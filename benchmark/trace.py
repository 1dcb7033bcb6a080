"""``torch.profiler`` over a short stretch of a run, reduced to what the
per-layer metrics read: device time and count by operation, the device's
busy time (the union of its operations' intervals), and its idle gaps
labelled by the host operator that was running in them.

The events are read from the profiler's raw Kineto results rather than
``key_averages()``, which builds an event tree that costs seconds per
thousand kernels.
"""
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    units: int                 # steps or requests in the stretch
    wall_s: float              # host time of the stretch, synchronised
    busy_s: float = 0.0        # union of the device's operation intervals
    #: device operation name -> [seconds, count]
    ops: dict = field(default_factory=dict)
    #: host operator name -> seconds of device idle while it ran innermost
    gaps: dict = field(default_factory=dict)

    def launches(self):
        return sum(c for _, c in self.ops.values())

    def device_s(self, *patterns, exclude=()):
        """Device seconds of the operations whose lower-case name holds a
        pattern and none of ``exclude``."""
        return sum(s for name, (s, _) in self.ops.items()
                   if _match(name, patterns) and not _match(name, exclude))

    def count(self, *patterns):
        return sum(c for name, (_, c) in self.ops.items()
                   if _match(name, patterns))

    def breakdown(self, n=10):
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v[0]] for k, v in top],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _match(name, patterns):
    low = name.lower()
    return any(p in low for p in patterns)


#: a user annotation on the device timeline ("Optimizer.step#AdamW.step"),
#: where the event does not say it is one; kernel names may hold '#' too
#: ("{lambda(float)#1}"), so an annotation is told by its form
ANNOTATION = re.compile(r"[\w.]+#[\w.]+")


def _device_op(e):
    if hasattr(e, "activity_type"):
        return (str(e.activity_type()).lower() in DEVICE_ACTIVITIES
                and not e.is_user_annotation())
    return not e.is_user_annotation() and not ANNOTATION.fullmatch(e.name())


def _host_op(e):
    """A host operator (not a call into the CUDA runtime)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type()).lower() in ("cpu_op",
                                                  "user_annotation")
    name = e.name()
    return not (name.startswith("cu") and "::" not in name)


def profile(fn, units):
    """Run ``fn()`` (``units`` steps or requests) under the profiler with
    CPU and CUDA activity; returns its ``TraceSummary``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize(prof.profiler.kineto_results.events(), units, wall)


def summarize(events, units, wall):
    out = TraceSummary(units=units, wall_s=wall)
    dev, host = [], defaultdict(list)
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _device_op(e):
                continue
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            dev.append((s, t))
            rec = out.ops.setdefault(e.name(), [0.0, 0])
            rec[0] += e.duration_ns() * 1e-9
            rec[1] += 1
        elif _host_op(e):
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            host[e.start_thread_id()].append((s, t, e.name()))
    dev.sort()
    busy, gaps, end = 0, [], None
    for s, t in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    out.busy_s = busy * 1e-9
    out.gaps = _label_gaps(gaps, host)
    return out


def _label_gaps(gaps, host):
    """Seconds of device idle by the innermost host operator running at
    each gap's midpoint (on any thread: the one begun last)."""
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    best = [(-1, "no host operator")] * len(mids)
    for ops in host.values():
        ops.sort()
        stack, i = [], 0
        for j, (p, _) in enumerate(mids):
            while i < len(ops) and ops[i][0] <= p:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < p:
                stack.pop()
            if stack and stack[-1][0] > best[j][0]:
                best[j] = (stack[-1][0], stack[-1][2])
    out = defaultdict(float)
    for (_, width), (_, name) in zip(mids, best):
        out[name] += width * 1e-9
    return dict(out)
