"""Profiler traces of the port: the counterpart of ``ubpl_tpu/utils/
profiling.py``'s ``trace``, with ``torch.profiler`` in place of
``jax.profiler``.

``trace(log_dir)`` records the enclosed region (host ops, and the card's
kernels when CUDA is available) and writes it as one Chrome trace file
(``chrome://tracing``, Perfetto) under ``log_dir``.

``span(name)`` marks a phase of the program (``train.forward``,
``serve.stage``) in whatever profiler is recording, on the clock of the
card's kernels; with none recording it is a shared null context.
"""
import contextlib
import os
import time

import torch

_NO_SPAN = contextlib.nullcontext()


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


def span(name):
    """A ``record_function`` range named ``name`` while a profiler records
    (``trace`` above, or any ``torch.profiler.profile``); otherwise the
    shared null context, so an unprofiled run pays one check per span
    (an ungated ``record_function`` costs ~20x that with no profiler)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
