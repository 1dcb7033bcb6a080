"""The program's phase spans in a profiled stretch, and the readings they
give.

The program marks its phases with ``ubpl_torch.utils.profiling.span``:
``record_function`` ranges named ``train.step``, ``train.views``,
``train.forward``, ``train.losses``, ``train.backward``, ``train.update``,
``serve.request``, ``serve.stage``, ``serve.normalize``,
``serve.forward`` and ``serve.collect``, live only while a profiler
records.  ``reduce`` turns a stretch's raw Kineto events into, per span
name: the count, host seconds, self seconds (host less the cover of the
spans nested in it), the device seconds and launches of the operations
launched inside it, and the device's idle seconds inside it.

A device operation belongs to its launching runtime call (the same
correlation id) and so to the innermost span open on the stepping thread
(the thread that opened ``train.step`` or ``serve.request``) when that
call began: backward's kernels are launched from autograd's thread while
the stepping thread waits inside ``train.backward``.  An idle gap of the
device belongs to the innermost span open on the stepping thread at its
midpoint, or to ``between_steps`` outside every span.

    python3 benchmark/spans.py --workload <name> --seed <n> --seconds <s>

runs a cell as ``run.py --trace 1`` does (set-up, the timed window, the
profiled stretch after it), without the check, and prints one JSON line:
the window's end-to-end metrics, the spans per step or per chunk, the
readings of the spans and of the estimator's frame counters
(``readings``), and the cell's per-layer metrics as ``run.py`` reads
them.  ``run.py`` itself does not read the spans.
"""
import re
import time
from collections import defaultdict

#: the program's span names ("train.views"), as told from the profiler's
#: own annotations ("Optimizer.step#AdamW.step", "ProfilerStep#3")
PROGRAM_SPAN = re.compile(r"[a-z]+(\.[a-z_]+)+")
ROOTS = ("train.step", "serve.request")
OUTSIDE = "between_steps"
#: the training step's phases, in the step's order
PHASES = ("views", "forward", "losses", "backward", "update")
COUNTERS = ("frames_requested", "frames_computed")


def _record():
    return {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
            "launches": 0, "idle_s": 0.0}


def _innermost(spans, points):
    """For each of the ascending ``points``, the index into ``spans``
    ((start, end, name) of one thread, properly nested, ascending by start
    and outer first) of the innermost one open there, or None."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and spans[stack[-1]][1] <= spans[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _put(spans, out, items, key, count):
    """Add each (time, seconds) of ``items`` to ``out[<innermost span at
    time>][key]`` (``between_steps`` outside every span); ``count``: add 1
    to its launches too."""
    items = sorted(items)
    for (_, sec), k in zip(items, _innermost(spans, [t for t, _ in items])):
        rec = out[spans[k][2] if k is not None else OUTSIDE]
        rec[key] += sec
        if count:
            rec["launches"] += 1


def reduce(events):
    """name -> {count, host_s, self_s, device_s, launches, idle_s} of the
    program's spans in a stretch's raw Kineto events, with
    ``between_steps`` for what falls outside every span.  Empty where the
    program opened no ``train.step`` or ``serve.request``."""
    import torch

    from . import trace as T
    spans, launches, dev = [], {}, []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if T._device_op(e):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
        elif e.is_user_annotation() and PROGRAM_SPAN.fullmatch(e.name()):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name(), e.start_thread_id()))
        elif not T._host_op(e):     # a call into CUDA (host operators
            # number their own correlation ids)
            launches[e.correlation_id()] = e.start_ns()
    roots = sorted(s for s in spans if s[2] in ROOTS)
    if not roots:
        return {}
    thread = roots[0][3]
    spans = sorted(((s, t, n) for s, t, n, th in spans if th == thread),
                   key=lambda x: (x[0], -x[1]))
    out = defaultdict(_record)
    stack = []
    for i, (s, t, name) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        if stack:
            out[spans[stack[-1]][2]]["self_s"] -= (t - s) * 1e-9
        stack.append(i)
        rec = out[name]
        rec["count"] += 1
        rec["host_s"] += (t - s) * 1e-9
        rec["self_s"] += (t - s) * 1e-9
    # an operation whose launch call was not recorded counts at its start
    _put(spans, out, [(launches.get(corr, s), (t - s) * 1e-9)
                      for s, t, corr in dev], "device_s", True)
    _put(spans, out, [((a + b) // 2, (b - a) * 1e-9)
                      for a, b in _gaps(dev)], "idle_s", False)
    return {k: dict(v) for k, v in out.items()}


def _gaps(dev):
    """The device's idle intervals between the first operation's start
    and the last one's end."""
    gaps, end = [], None
    for s, t, *_ in sorted(dev):
        if end is not None and s > end:
            gaps.append((end, s))
        end = t if end is None else max(end, t)
    return gaps


def training_idle_ms(spans, window_s_per_step, busy_s_per_step):
    """``train.<phase>_idle_ms`` for the five phases and ``between_steps``
    (idle outside ``train.step``): each one's share of the stretch's idle
    seconds times the unprofiled idle per step, (window s/step - stretch
    busy s/step) x 1e3, so that the six add up to ``train.idle_share`` /
    100 x the window's ms per step wherever the phases cover the step.
    None where the program opened no ``train.step``."""
    if "train.step" not in spans:
        return None
    total = sum(v["idle_s"] for v in spans.values())
    idle_ms = (window_s_per_step - busy_s_per_step) * 1e3
    names = [f"train.{p}" for p in PHASES] + [OUTSIDE]
    return {f"train.{n.split('.')[-1]}_idle_ms":
            spans.get(n, {}).get("idle_s", 0.0) / total * idle_ms
            if total else 0.0 for n in names}


def padded_share(counters):
    """Percent of the frames computed that were padding: 100 x (computed
    - requested) / computed; None without the counters."""
    computed = counters.get("frames_computed")
    if not computed:
        return None
    return 100.0 * (computed - counters["frames_requested"]) / computed


def serving_readings(spans, counters):
    """``serve.padded_share``, ``serve.stage_ms_per_chunk`` (host ms of
    ``serve.stage`` per chunk) and ``serve.normalize_ms_per_chunk``
    (device ms of the operations launched inside ``serve.normalize`` per
    chunk); each None where its span or counter is missing."""
    stage, norm = spans.get("serve.stage"), spans.get("serve.normalize")
    return {"serve.padded_share": padded_share(counters),
            "serve.stage_ms_per_chunk":
            stage["host_s"] / stage["count"] * 1e3 if stage else None,
            "serve.normalize_ms_per_chunk":
            norm["device_s"] / norm["count"] * 1e3 if norm else None}


def profile(fn, units, device):
    """Run ``fn()`` (``units`` steps or requests) under the profiler (the
    card's activity too where ``device`` is one); returns (the harness's
    ``TraceSummary``, ``reduce`` of the same events)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from . import trace as T
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    sync()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    return T.summarize(events, units, wall), reduce(events)


def _counters(est):
    return {k: getattr(est, k) for k in COUNTERS if hasattr(est, k)}


def per_unit(spans, n):
    """The spans' numbers per step or chunk (``n`` of them), in ms."""
    return {name: {"count": v["count"] / n,
                   **{k[:-2] + "_ms": v[k] / n * 1e3 for k in
                      ("host_s", "self_s", "device_s", "idle_s")},
                   "launches": v["launches"] / n}
            for name, v in spans.items()}


def measure(cell, seed, seconds, device):
    """Set-up, the timed window and the profiled stretch of ``cell``;
    returns the result line (a dict)."""
    import torch

    from . import harness
    prog = cell.runner().Program(cell, seed, device)
    est = getattr(prog, "est", None)
    before = _counters(est)
    win = prog.window(seconds)
    counters = {k: v - before[k] for k, v in _counters(est).items()}
    summary, spans = profile(prog.stretch, prog.stretch_units, device)
    m = harness.Measured(win, summary, None, None, cell.chips, {})
    on_card = device.type == "cuda"
    if on_card:
        m.peak_flops, m.peak_bytes_per_s = harness.peaks(
            torch.cuda.get_device_name(device), cell.config["compute_dtype"])
    serving = "serve.request" in spans
    if serving:
        readings = serving_readings(spans, counters)
        n = spans["serve.stage"]["count"]
    else:
        readings = training_idle_ms(
            spans, win.seconds / win.units, summary.busy_s / summary.units)
        n = summary.units
    return {"workload": cell.name, "seed": seed,
            "device": (torch.cuda.get_device_name(device) if on_card
                       else "cpu"),
            "window": {"units": win.units, "seconds": win.seconds,
                       **win.end_to_end, "counters": counters},
            "stretch": {"units": summary.units, "wall_s": summary.wall_s,
                        "busy_s": summary.busy_s,
                        "launches": summary.launches(),
                        "idle_gaps": summary.breakdown()["idle_gaps"]},
            "per": "chunk" if serving else "step", "n": n,
            "spans": per_unit(spans, n) if spans else {},
            "readings": readings,
            "per_layer": {x["name"]: harness.reader(x["name"])(m)
                          for x in cell.per_layer} if on_card else {}}


def main(argv=None):
    import argparse
    import json
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    # as run.py: the kernel caches in the checkout, and one host thread
    # for torch's CPU work (set before torch is imported)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".kernel_build",
                                                  "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, root)
    import torch

    from benchmark import harness
    from benchmark.spans import measure as measure_cell
    if not torch.cuda.is_available():
        print("spans.py needs a CUDA card", file=sys.stderr)
        return 2
    line = measure_cell(harness.Cell(args.workload), args.seed,
                        args.seconds, torch.device("cuda"))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
