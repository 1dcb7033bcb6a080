"""Flops of attention's two activation products in one training step, and
the cell a per-layer reader runs in.

A network's ``registry`` entry declares its products (``products``, such
as ViTPose's q k^T and probabilities times v); ``flops`` counts each at
the shapes of the reference network, a backward as both operands'
gradients (two forwards).  Per Mean Teacher step: per image and view, each
teacher's forward and each student's forward and backward, over as many
branches as the program's trainer builds.
"""
import os
import sys

from . import flops
from .harness import Cell


def product_flops(arch, classes_or_kps, res):
    """Forward flops of one image's declared products."""
    return sum(f for _, f, weighted in flops._counted(arch, classes_or_kps,
                                                      res) if not weighted)


def branches(cell):
    """The student-teacher pairs of the pose training ``cell``'s trainer:
    ``br_num`` x ``br_aug_num`` of its ``Config`` (``MTUBPLTrainer.n_models``),
    the configuration's ``hyper`` block over the defaults."""
    from .runners.train_pose import program_config
    cfg = program_config(cell, 0)
    return cfg.br_num * cfg.br_aug_num


def step_flops(cell):
    """The products' flops of one step of the pose training ``cell``: per
    image and view, each branch's teacher forward and its student's forward
    and backward (both operands' gradients, two forwards)."""
    c, t = cell.config, cell.traffic
    per_image = product_flops(c["model"], c["kps"], c["inp_res"])
    rows = t["batch_unlabeled"] + t["batch_labeled"]
    return rows * t["views"] * branches(cell) * (per_image + 3 * per_image)


def current_cell(argv=None):
    """The cell of ``benchmark/run.py`` in this process, its command line
    read by ``run.py``'s own parser (so ``--workload=<name>`` and
    abbreviations count as they do there); None where the process was
    started otherwise."""
    argv = sys.argv if argv is None else argv
    if not argv or os.path.basename(argv[0]) != "run.py":
        return None
    from .run import parse
    try:
        args = parse(argv[1:])
    except SystemExit:
        return None
    return Cell(args.workload)
