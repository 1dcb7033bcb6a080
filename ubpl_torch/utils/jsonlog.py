"""JSON run logs: the port's copy of ``ubpl_tpu/utils/jsonlog.py``
(reference CommUtils.json_save, used for the per-epoch dumps)."""
import json
import os

import numpy as np


def _default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if hasattr(o, "tolist"):        # numpy arrays and torch tensors
        return o.tolist()
    return str(o)


def json_save(data, path, is_cover=False):
    if os.path.exists(path) and not is_cover:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, default=_default)
