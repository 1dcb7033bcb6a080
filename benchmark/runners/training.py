"""What the training runners share: the batch order, the timed window,
the check steps' readings on the program's side and the reference's, and
the numbers that compare them.

The readings of a training check (``Readings``): each check step's summed
loss (and the counts it divides by, where the step returns them), the
first step's loss terms, computed before any update, the first
gradient's norm per leaf (on the program's side AdamW's first moment
after one step over 1 - beta1), each leaf's change over the check steps,
students' and EMA teachers', and, where the step synthesises heatmap
targets, the maps and keypoints it wrote.
"""
import contextlib
import time

import numpy as np
import torch

from .. import compare
from ..harness import Window
from ..reference import nets
from ..reference import optim as RO

BETA1 = 0.9


def batch_order(n, n_lab, bu, bl, seed):
    """Endless index batches: ``bu`` unlabelled rows (``n_lab`` to ``n``)
    then ``bl`` labelled ones (0 to ``n_lab``), each stream walking its
    own permutations drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def stream(lo, hi, k):
        while True:
            perm = rng.permutation(np.arange(lo, hi))
            for i in range(0, len(perm) - k + 1, k):
                yield perm[i:i + k]

    un, lab = stream(n_lab, n, bu), stream(0, n_lab, bl)
    while True:
        yield np.concatenate([next(un), next(lab)])


class Readings:
    def __init__(self, losses, first_grads, changes, counts=None,
                 terms=None, maps=None):
        self.losses, self.first_grads = losses, first_grads
        self.changes, self.counts = changes, counts
        self.terms, self.maps = terms, maps


def leaf_names(students):
    return [f"s{m}.{n}" for m, s in enumerate(students)
            for n, _ in s.named_parameters()]


def changes(students, teachers, states):
    """Each leaf's change from ``states``, students' ("s<m>.") and
    teachers' ("t<m>.")."""
    out = {}
    for tag, group in (("s", students), ("t", teachers)):
        for m, (net, sd) in enumerate(zip(group, states)):
            for n, p in net.named_parameters():
                out[f"{tag}{m}.{n}"] = float((p.detach() - sd[n]).norm())
    return out


def first_gradients(optimizer, names, params):
    """Each leaf's first gradient norm, from AdamW's first moment after
    one step ((1 - beta1) x the gradient); 0 for a leaf the optimiser
    holds no state for (it had no gradient)."""
    state = optimizer.state
    return {n: float(state[p]["exp_avg"].norm() / (1 - BETA1))
            if p in state else 0.0 for n, p in zip(names, params)}


class TrainProgram:
    """The program's side of a training cell.  A subclass builds
    ``trainer`` (with ``students``, ``teachers`` and ``optimizer``),
    ``states``, ``batches``, ``bs``, ``flops_per_step`` and ``cell``, and
    defines ``_step(batch)`` (one call of the window's entry),
    ``_loss_and_counts(metrics)`` and ``_terms(metrics)``; then calls
    ``_check_steps()``.  ``_targets()`` may record the targets the check
    steps write."""

    def _targets(self):
        """A context in which the check steps run, yielding the list that
        collects their heatmap targets; none by default."""
        return contextlib.nullcontext(None)

    def _check_steps(self):
        """The first steps, through the window's own call, on rows that
        all differ; the reference follows them."""
        tr = self.trainer
        names = leaf_names(tr.students)
        params = [p for s in tr.students for p in s.parameters()]
        self.check_batches, losses, counts = [], [], []
        with self._targets() as maps:
            for i in range(self.cell.traffic["check_steps"]):
                b = next(self.batches)
                self.check_batches.append(b)
                metrics = self._step(b)
                loss, n = self._loss_and_counts(metrics)
                losses.append(loss)
                counts.append(n)
                if i == 0:
                    first = first_gradients(tr.optimizer, names, params)
                    terms = {k: [float(x) for x in v.reshape(-1)]
                             for k, v in self._terms(metrics).items()}
        counts = None if counts[0] is None else [
            {k: v.reshape(-1).tolist() for k, v in c.items()}
            for c in counts]
        self.readings = Readings([float(x) for x in losses], first,
                                 changes(tr.students, tr.teachers,
                                         self.states), counts, terms, maps)
        self.stretch_units = self.cell.traffic["trace_steps"]

    def window(self, seconds):
        """Steps until ``seconds`` have passed, a synchronise at each end
        of the window and none inside."""
        on_card = self.trainer.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while True:
            self._step(next(self.batches))
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return Window(steps, dt, steps * self.flops_per_step,
                      {"train_images_per_s": steps * self.bs / dt})

    def stretch(self):
        for _ in range(self.stretch_units):
            self._step(next(self.batches))

    def check_rows(self):
        return torch.as_tensor(np.concatenate(self.check_batches),
                               device=self.trainer.device)


class TrainKept:
    """What a training check keeps once the program is gone; a subclass
    defines ``reference(precision)``."""
    kernel_bytes = {}

    def check(self):
        return numbers(self.readings, self.reference(), self.cell.limits)


@contextlib.contextmanager
def float32_matmuls():
    """Float32 convolutions and matrix products without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_steps(cell, arch, classes_or_kps, states, device, precision,
                    step_loss):
    """The reference's readings over the check steps: student and EMA
    teacher networks from ``states``, plain AdamW and EMA, and
    ``step_loss(i, students, teachers)`` -> (loss, counts or None, terms)
    for check step ``i``."""
    c, t = cell.config, cell.traffic
    with float32_matmuls():
        def build(sd):
            net = nets.build(arch, classes_or_kps).to(device)
            net.load_state_dict(sd)
            return nets.set_precision(net, precision)
        students = [build(sd) for sd in states]
        teachers = [build(sd).requires_grad_(False) for sd in states]
        params = [p for s in students for p in s.parameters()]
        opt = RO.AdamW(params, lr=c["hyper"]["lr"],
                       weight_decay=c["hyper"]["wd"])
        losses, counts, first = [], [], None
        for i in range(t["check_steps"]):
            loss, n, step_terms = step_loss(i, students, teachers)
            counts.append(n)
            loss.backward()
            if i == 0:
                terms = step_terms
                first = {name: float(p.grad.norm()) if p.grad is not None
                         else 0.0 for name, p in zip(leaf_names(students),
                                                     params)}
            losses.append(loss.item())
            del loss
            opt.step()
            RO.ema(teachers, students, t["schedule"]["ema_alpha"])
        return Readings(losses, first, changes(students, teachers, states),
                        None if counts[0] is None else counts, terms)


def readings_gaps(prog, ref):
    """Every number a training check can compare, name -> (value, what):
    the check steps' losses (all, and the first step's alone); each of
    the first step's loss terms (``<term>_gap``); the first gradient's and
    the change's norms by the worst leaf (the gradient over every leaf,
    the change over the leaves that are not rounding-only) and by the
    median leaf (both over the latter); the loss's counts, where the step
    returns them; the heatmap targets, where the step writes them."""
    moving = compare.moving_leaves(ref.first_grads)
    # a teacher's leaf moves with its student's ("t0.x" with "s0.x")
    keep = {n for n in ref.changes if "s" + n[1:] in moving}
    grad, g_at = compare.leaf_gap(prog.first_grads, ref.first_grads)
    change, c_at = compare.leaf_gap(prog.changes, ref.changes, keep)
    out = {"loss_gap": (compare.relative_gap(prog.losses, ref.losses),
                        "worst of the check steps' summed losses"),
           "loss_gap_first": (compare.relative_gap(prog.losses[:1],
                                                   ref.losses[:1]),
                              "the first step's summed loss"),
           "grad_gap": (grad, f"worst leaf {g_at}"),
           "change_gap": (change, f"worst leaf {c_at}"),
           "grad_gap_median": (compare.median_leaf_gap(
               prog.first_grads, ref.first_grads, moving), "median leaf"),
           "change_gap_median": (compare.median_leaf_gap(
               prog.changes, ref.changes, keep), "median leaf")}
    for k, r in (ref.terms or {}).items():
        out[f"{k}_gap"] = (compare.term_gap(prog.terms[k], r,
                                            ref.losses[0]),
                           f"the first step's {k}, worst branch")
    if prog.counts and ref.counts:
        out["count_gap"] = (compare.count_gap(prog.counts, ref.counts),
                            "the losses' counts, every step")
    if ref.maps is not None:
        out["heatmap_gap"] = (compare.map_gap(prog.maps, ref.maps),
                              "the targets' cells and visibility")
    return out


def worst_gaps(progs, ref):
    """``readings_gaps`` of each of ``progs`` (a program's readings, or
    one per rank of a program that spans ranks), the worst per number."""
    out = {}
    for i, prog in enumerate(progs if isinstance(progs, list) else [progs]):
        for k, (v, what) in readings_gaps(prog, ref).items():
            if k not in out or v > out[k][0]:
                out[k] = (v, what if i == 0 else f"{what}, rank {i}")
    return out


def numbers(prog, ref, limits):
    """[(name, value, limit, what)] of the numbers that ``limits`` names,
    from a program's (or a control's) readings ``prog``, or a list of
    them, one per rank, against the reference's ``ref``."""
    gaps = worst_gaps(prog, ref)
    return [(k, gaps[k][0], lim, gaps[k][1]) for k, lim in limits.items()]
