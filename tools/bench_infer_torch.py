"""Serving throughput and latency of the PyTorch port's ``PoseEstimator``,
the counterpart of ``tools/bench_infer.py``: uint8 images in, keypoints
and scores out, one JSON line per batch size.

    python3 tools/bench_infer_torch.py [batch_sizes...] [--device=cpu]
    # default 1 8 32 64; UBPL_INFER_DEVICE_INPUT=1: input already on the
    # card; UBPL_INFER_CHUNKS=N: N chunks per request

``ubpl_torch/bench.py:main_serving`` does the work.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ubpl_torch.__main__ import parse_overrides  # noqa: E402
from ubpl_torch.bench import main_serving  # noqa: E402

if __name__ == "__main__":
    args = sys.argv[1:]
    sizes = [int(a) for a in args if not a.startswith("--")] or [1, 8, 32, 64]
    sys.exit(main_serving(sizes, parse_overrides(args).get("device")))
