"""File and misc helpers (reference utils/base/comm.py CommUtils): the
port's copy of ``ubpl_tpu/utils/comm.py``.

Checkpoints live in ``train/checkpointing.py`` and the report in
``utils/report.py``; this module carries the rest of the small surface:
file scanning and naming helpers and ``math_signal``.
"""
import glob as _glob
import os
import shutil


def math_signal(x):
    """Reference math_signal: sign with 0 at 0."""
    return 1 if x > 0 else (0 if x == 0 else -1)


def file_scan(pattern):
    """Reference file_scan: sorted glob."""
    return sorted(_glob.glob(pattern))


def file_isfile(path):
    return os.path.isfile(path)


def file_split_filename(path):
    """Reference file_splitFilename: basename without extension."""
    return os.path.splitext(os.path.basename(path))[0]


def file_copy(src, dst):
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    shutil.copyfile(src, dst)


def folder_ensure(path):
    os.makedirs(path, exist_ok=True)
    return path
