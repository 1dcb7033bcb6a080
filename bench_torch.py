"""Benchmark of the PyTorch port: MT_UBPL training throughput
(images/sec/chip), the counterpart of ``bench.py``.

    python3 bench_torch.py                # on the CUDA card
    python3 bench_torch.py --device=cpu   # on the CPU (labelled "cpu")

Prints ONE JSON line on stdout with ``bench.py``'s keys plus ``device``
(the card's name and power limit) and ``baseline``; the same
``UBPL_BENCH_*`` variables steer it.  It runs ``python -m ubpl_torch
bench`` (``ubpl_torch/bench.py``); a failure exits non-zero with no line.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ubpl_torch.__main__ import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(["bench", *sys.argv[1:]]))
