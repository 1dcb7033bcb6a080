"""Profiler traces of the port: the counterpart of ``ubpl_tpu/utils/
profiling.py``'s ``trace``, with ``torch.profiler`` in place of
``jax.profiler``.

``trace(log_dir)`` records the enclosed region (host ops, and the card's
kernels when CUDA is available) and writes it as one Chrome trace file
(``chrome://tracing``, Perfetto) under ``log_dir``.
"""
import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Record a torch.profiler trace of the enclosed region into
    ``{log_dir}/trace_{pid}_{time}.json``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d%H%M%S')}.json"))
