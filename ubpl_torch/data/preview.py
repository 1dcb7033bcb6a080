"""Dataset smoke preview (reference datasources __main__ blocks): render a
few annotated samples to disk to eyeball a datasource.  The port's
counterpart of ``ubpl_tpu/data/preview.py``; it writes PNG files.

    python -m ubpl_torch preview --data_source=Mouse --count=20 --out=./preview
"""
import os

import numpy as np

from ..utils.draw import draw_kps_image, save_image
from .arrays import materialize
from .sources import get_datasource


def main(params=None):
    params = params or {}
    name = params.get("data_source", "Mouse")
    count = int(params.get("count", 20))
    out_dir = params.get("out", f"./preview_{name}")
    ds = get_datasource(name, data_root=params.get("data_root"),
                        cache_dir=params.get("cache_dir"), seed=1388)
    train, _, _, _ = ds.get_data(count, min(count, 8))
    arrays = materialize(train, ds.inp_res, cache=ds.image_cache)
    for i in range(len(train)):
        img = draw_kps_image(arrays.images[i].astype(np.float32) / 255.0,
                             arrays.kps[i], ds.pck_ref)
        save_image(img, os.path.join(out_dir, f"{arrays.image_ids[i]}.png"))
    print(f"wrote {len(train)} previews to {out_dir}")
