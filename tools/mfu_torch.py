"""Flops per MT_UBPL training step and MFU of the PyTorch port, the
counterpart of ``tools/mfu.py``.

    python3 tools/mfu_torch.py [batch_size] [steps] [--device=cpu]
    # default 32 20; UBPL_PEAK_TFLOPS sets the peak (default 989.4)

Prints flops per step (``FlopCounterMode``), the step time (one window of
``steps`` steps over their number, as ``tools/mfu.py`` times it), the
achieved TFLOP/s and MFU beside the card's name and power limit.
``ubpl_torch/bench.py:main_mfu`` does the work.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ubpl_torch.__main__ import parse_overrides  # noqa: E402
from ubpl_torch.bench import main_mfu  # noqa: E402

if __name__ == "__main__":
    args = sys.argv[1:]
    pos = [int(a) for a in args if not a.startswith("--")]
    bs, steps = (pos + [32, 20][len(pos):])[:2]
    sys.exit(main_mfu(bs, steps, parse_overrides(args).get("device")))
