"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with as many CUDA cards as
the cell asks for.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (a profiled stretch after the timed
window).  The last line of standard output is one JSON object; the numbers
that decided ``correct`` are its ``checks`` and the last lines of standard
error.  Exits non-zero, printing no result, without the cards or when JAX
or the JAX package was loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # the program's kernel caches live in the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".kernel_build",
                                                  "triton")
    # one host thread for torch's CPU work: the steps are dispatched from
    # one thread, and a pool of spinning workers only competes with it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    from benchmark import harness
    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {n}",
              file=sys.stderr)
        return 2
    correct, result, checks = harness.run(
        cell, args.seed, args.seconds, args.trace, torch.device("cuda"),
        T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit, what in checks:
        print(f"check {name} {value!r} limit {limit!r} ({what})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
