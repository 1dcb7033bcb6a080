"""Readings that set a cell's correctness limits, on the card, at the
cell's own size: the program's numbers against the plain reference on
many seeds, the control's (the reference computed with fp8 operands in
the program's place), those of planted faults, and those of a witness:
the program itself computing in float32 without TF32.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 3] [--faults half_batch,heatmap_zero] \
        [--fault-seeds 3] [--witness 3] [--seconds 3]

Read the program's sound numbers one seed per process, as the checks
run: cuDNN chooses its algorithms once per process, so seeds read in one
process share that choice and spread less than fresh processes do.

One JSON line per seed and reading on standard output: every number
``runners.training.readings_gaps`` gives, each with the leaf or term it
comes from.  A training cell needs no timed window; a serving cell runs a
``--seconds`` window at the cell's load so that there are served requests
to compare.  Faults (``FAULTS``): a training step on every other row of
its batch (half the batch left out, the losses the mean over the rest);
heatmap targets zeroed, or moved by one map cell, where the kernel writes
them; a loss term (EPC, FDC) left out of the step; a step that leaves the
state unchanged; the gradients' sum over the ranks that split the batch
left out (each rank steps on its own rows' share); a serving answer moved
by one map cell where it is produced.  A step that leaves the state
unchanged reads 1 on ``change_gap`` by construction, and a term left out
1 on its ``<term>_gap`` (``tests/test_bench_faults.py`` runs both).  A
program whose ranks run in processes of their own plants the fault in
each of them (its ``Program.fault``).
"""
import argparse
import contextlib
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(owner.name)`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, wrap(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def half_batch(program_cls):
    """The program sees every other row of each batch."""
    def wrap(step):
        return lambda self, batch: step(self, batch[::2])
    return patched(program_cls, "_step", wrap)


def heatmaps(change):
    """The heatmap kernel's maps passed through ``change`` as it returns
    them."""
    from ubpl_torch.ops.kernels import heatmap_synth

    def wrap(synth):
        def faulty(*args, **kwargs):
            hm, kps = synth(*args, **kwargs)
            return change(hm), kps
        return faulty
    return patched(heatmap_synth, "synthesize_heatmaps", wrap)


def epc_left_out():
    """The step's ensemble pseudo-label loss summed as 0."""
    from ubpl_torch.train import losses

    def wrap(pseudo):
        def faulty(*args, **kwargs):
            s, stats = pseudo(*args, **kwargs)
            return s * 0.0, stats
        return faulty
    return patched(losses, "joint_pseudo3", wrap)


def fdc_left_out():
    """The step's feature decorrelation loss returned as 0."""
    from ubpl_torch.train import mt_ubpl

    def wrap(fdc):
        def faulty(*args, **kwargs):
            loss, n = fdc(*args, **kwargs)
            return loss * 0.0, n
        return faulty
    return patched(mt_ubpl, "fdc_loss", wrap)


def state_unchanged(_):
    """AdamW's step leaves the parameters as they were."""
    import torch
    return patched(torch.optim.AdamW, "step",
                   lambda step: lambda self, *args, **kwargs: None)


def exchange_left_out():
    """The gradients are not summed over the ranks that split the
    batch."""
    from ubpl_torch.parallel import collectives

    return patched(collectives, "all_reduce_grads",
                   lambda reduce: lambda grads, group: grads)


def moved_answers():
    """Every served x moved by one map cell where it is produced."""
    from ubpl_torch.infer import PoseEstimator

    def wrap(predict):
        def faulty(self, images):
            kps, scores = predict(self, images)
            kps[..., 0] += self.cfg.inp_res // self.cfg.out_res
            return kps, scores
        return faulty
    return patched(PoseEstimator, "predict", wrap)


#: name -> (runner it applies to, plant(program class) -> context)
FAULTS = {
    "half_batch": ("train", half_batch),
    "heatmap_zero": ("train_pose", lambda _: heatmaps(lambda h: h * 0.0)),
    "heatmap_shift": ("train_pose",
                      lambda _: heatmaps(lambda h: h.roll(1, dims=-1))),
    "epc_left_out": ("train_pose", lambda _: epc_left_out()),
    "fdc_left_out": ("train_pose", lambda _: fdc_left_out()),
    "state_unchanged": ("train", state_unchanged),
    "exchange_left_out": ("train_pose_mesh", lambda _: exchange_left_out()),
    "moved_answer": ("serve_clips", lambda _: moved_answers()),
}


def plant(cell, fault):
    """The context in which ``fault`` is planted in ``cell``'s program."""
    if fault is None:
        return contextlib.nullcontext()
    kind, make = FAULTS[fault]
    if not cell.traffic["runner"].startswith(kind):
        raise ValueError(f"{fault} does not apply to {cell.name}")
    program = cell.runner().Program
    if hasattr(program, "fault"):       # planted in the program's ranks
        return patched(program, "fault", lambda _: fault)
    return make(program)


def named(prog, ref):
    """Every number a training check can compare, and the look behind
    it: each step's loss gap and the smallest reference gradients as
    shares of the median leaf's."""
    import statistics
    from benchmark.runners.training import worst_gaps
    rows = {n: list(v) for n, v in worst_gaps(prog, ref).items()}
    if isinstance(prog, list):          # one per rank: rank 0's look
        prog = prog[0]
    med = statistics.median(ref.first_grads.values())
    rows["step_loss_gaps"] = [abs(p - r) / abs(r) for p, r in
                              zip(prog.losses, ref.losses)]
    rows["smallest_reference_grads"] = sorted(
        (v / med, n) for n, v in ref.first_grads.items())[:4]
    rows["terms"] = {"program": prog.terms, "reference": ref.terms}
    return rows


def readings(cell, seed, device, seconds, control, fault=None,
             witness=False):
    """One seed's readings; ``witness`` runs the program in float32
    without TF32 in place of the configuration's precision."""
    from benchmark.runners import serve_clips
    from benchmark.runners.training import float32_matmuls
    if witness:
        if hasattr(cell.runner().Program, "fault"):
            raise ValueError("the witness turns TF32 off in this process, "
                             "not in the program's ranks")
        cell = copy.copy(cell)
        cell.config = dict(cell.config, compute_dtype="float32")
    runner = cell.runner()
    t0 = time.perf_counter()
    with plant(cell, fault), (float32_matmuls() if witness
                              else contextlib.nullcontext()):
        prog = runner.Program(cell, seed, device)
        if cell.traffic["runner"] == "serve_clips":
            prog.window(seconds)
        kept = prog.release()
        del prog
    out = {"workload": cell.name, "seed": seed, "fault": fault,
           "program_dtype": cell.config["compute_dtype"],
           "program_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    if cell.traffic["runner"] == "serve_clips":
        out["program"] = dict(zip(("argmax_gap", "score_gap"),
                                  kept.reference_gaps()))
        if control:
            out["control"] = dict(zip(
                ("argmax_gap", "score_gap"), kept.reference_gaps(
                    "fp8", answers=serve_clips.reference_answers)))
    else:
        ref = kept.reference("fp32")
        out["program"] = named(kept.readings, ref)
        if control:
            out["control"] = named(kept.reference("fp8"), ref)
    out["reference_s"] = time.perf_counter() - t0
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="",
                   help="comma-separated names of FAULTS")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--witness", type=int, default=0,
                   help="seeds on which the float32 program also runs")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".kernel_build",
                                                  "triton")
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness
    cell = harness.Cell(args.workload)
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [(s, i < args.control, None, False) for i, s in enumerate(seeds)]
    runs += [(s, False, None, True) for s in seeds[:args.witness]]
    runs += [(s, False, f, False) for f in filter(None,
                                                  args.faults.split(","))
             for s in seeds[:args.fault_seeds]]
    for seed, control, fault, witness in runs:
        print(json.dumps(readings(cell, seed, device, args.seconds, control,
                                  fault, witness)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
