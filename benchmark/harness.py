"""The benchmark's run of one cell: set-up, the timed window, an optional
profiled stretch, the correctness check against the plain reference, and
the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

  * the cell's configuration file (``configs`` entry's ``file``),
  * its traffic mix, ``traffic/<traffic>.json``, whose ``runner`` names the
    module of ``runners/`` that drives the program for that kind of
    traffic,
  * its correctness limits, ``limits/<workload>.json``,
  * each per-layer metric's reader, ``metrics/<metric name>.py``.

A runner module defines ``Program(cell, seed, device)``, whose
construction is the set-up (program built, inputs and weights made from
the seed, every shape warmed up, the first steps that the check follows
taken through the window's own call), and which has
``window(seconds)`` (returns a ``Window``), ``stretch()`` (a short run of
``stretch_units`` more steps or requests, for the profiler) and
``release()``, which frees the program's state and returns what the check
keeps: an object with ``kernel_bytes`` (bytes per launch of the hand
kernels on the path) and ``check()``, which runs the reference and
returns ``[(name, value, limit, what)]``, each value passing at or under
its limit.

A program whose ranks run in processes of their own (one per card) also
defines ``profile(units)``, which returns the ``TraceSummary`` of rank 0's
profiled stretch (its ``busy_s`` the mean over the ranks' cards), and
``memory_peak_bytes()``, the fullest rank's peak; it has synchronised its
cards when its construction returns, and this process leaves the cards to
it until the check.
"""
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "ubpl_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclass
class Window:
    """What the timed window did: ``units`` steps or requests completed
    over ``seconds`` (a synchronise at each end), their analytic
    ``flops``, and the cell's end-to-end metrics."""
    units: int
    seconds: float
    flops: float
    end_to_end: dict = field(default_factory=dict)


class Cell:
    """One ``workloads`` entry of ``BENCHMARK.json`` with its files."""

    def __init__(self, name, spec=None):
        spec = spec or load_spec()
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        self.name = name
        self.workload = by_name[name]
        self.chips = self.workload["chips"]
        conf = {c["name"]: c for c in spec["configs"]}[
            self.workload["config"]]
        self.config_name = conf["name"]
        self.config = load_json(os.path.join(ROOT, conf["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(os.path.join(
            BENCH_DIR, "traffic", f"{self.traffic_name}.json"))
        self.limits = load_json(os.path.join(BENCH_DIR, "limits",
                                             f"{name}.json"))
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in e2e]

    def runner(self):
        return importlib.import_module(
            f"benchmark.runners.{self.traffic['runner']}")


def reader(metric):
    """The ``read(measured)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Measured:
    """What a per-layer reader reads: the unprofiled window, the profiled
    stretch after it (``trace``), the card's peaks for the configuration's
    compute type (None where the table lacks the card), the chips, and
    the bytes per launch of the hand kernels on the path."""
    window: Window
    trace: object
    peak_flops: float
    peak_bytes_per_s: float
    chips: int
    kernel_bytes: dict


def peaks(device_name, compute_dtype):
    table = load_json(os.path.join(BENCH_DIR, "peaks.json"))
    card = table.get(device_name)
    if card is None:
        return None, None
    return card[f"{compute_dtype}_flops"], card["hbm_bytes_per_s"]


def seeds(seed, n):
    """``n`` 32-bit seeds drawn from the run's ``--seed``."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(
        n, dtype=np.uint32)]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell, seed, seconds, trace, device, t_start):
    """One run of ``cell``; returns (correct, result dict, checks)."""
    import torch
    from . import trace as T
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    prog = cell.runner().Program(cell, seed, device)
    in_ranks = hasattr(prog, "profile")
    if not in_ranks:
        sync()
    setup_s = time.perf_counter() - t_start
    win = prog.window(seconds)
    profile = prog.profile if in_ranks else (
        lambda units: T.profile(prog.stretch, units))
    summary = profile(prog.stretch_units) if trace and on_card else None
    if in_ranks:
        memory = prog.memory_peak_bytes()
    else:
        memory = torch.cuda.max_memory_allocated(device) if on_card else 0
    kept = prog.release()
    del prog
    if on_card:
        torch.cuda.empty_cache()
    checks = kept.check()
    correct = all(v <= lim for _, v, lim, _ in checks)
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(memory)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if not trace:
        values = {**win.end_to_end, "setup_s": setup_s}
        metrics = {k: {"value": values[k], "unit": units[k]}
                   for k in units}
    else:
        metrics = {}
        if summary is not None:
            pf, pb = peaks(name, cell.config["compute_dtype"])
            measured = Measured(win, summary, pf, pb, cell.chips,
                                kept.kernel_bytes)
            for m in cell.per_layer:
                v = reader(m["name"])(measured)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.wall_s
    result = {"correct": correct, "attempted": win.units, "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in checks}
    return correct, result, checks
