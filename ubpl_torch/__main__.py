"""CLI: python -m ubpl_torch <regime> [--key=value ...]

Regimes: supervised | mt | mt_ubpl | dualpose | dualpose_ubpl | exec |
classification | preview
(`exec` runs the reference's full sweep grid, projects/exec.py equivalent;
`exec --quick` a 2-epoch HG2 smoke of all five regimes over Mouse;
`classification --mode=supervised|mt|mt_ubpl` the CIFAR branch, e.g.
`--model=ResNet --data_source=cifar10`).

`--device=cuda|cpu` picks the device; without it the port runs on the CUDA
card and stops if there is none.

Several cards, one process per card, started here or by torchrun.  Data
parallel (the batch and the dataset split over the cards, BatchNorm
statistics, losses and gradients over the global batch): every card of the
host by default (the count shrunk to one that divides --train_bs), or
`--mesh_shape=N` (`--mesh_axes=data`; N=1: one card, in this process):
    python -m ubpl_torch mt_ubpl --mesh_shape=4 ...
    torchrun --nproc-per-node=4 -m ubpl_torch mt_ubpl ...
    torchrun --nnodes=2 --nproc-per-node=4 --rdzv-endpoint=HOST:PORT \\
        -m ubpl_torch mt_ubpl --mesh_shape=2,4 --mesh_axes=dcn,data ...
(`dcn`: one index per node).  Branch parallel (a `model` axis: the
two-network regimes mt_ubpl, dualpose and dualpose_ubpl put each (student,
EMA teacher) pair on its own card and exchange only the teachers' last
stacks, the students' features and a few scalars):
    python -m ubpl_torch mt_ubpl --mesh_shape=2 --mesh_axes=model ...
    python -m ubpl_torch mt_ubpl --mesh_shape=2,4 --mesh_axes=model,data ...
    torchrun --nproc-per-node=4 -m ubpl_torch mt_ubpl --mesh_shape=2,2 \\
        --mesh_axes=model,data ...
A `model` axis must divide the two branches (4 raises).  supervised and mt
have no branch axis: they run whole on every `model` index.  classification
takes no mesh.  With --device=cpu, `--mesh_shape=...` runs that many gloo
processes on the CPU; without it, one.

Other keys map to
ubpl_torch.config.Config fields (or reference argparse aliases), e.g.:
    python -m ubpl_torch mt_ubpl --data_source=Mouse --data_root=./data \\
        --train_count=100 --label_ratio=0.3 --epochs=100

Datasets are read in the reference's layout under --data_root, e.g.
{data_root}/pose/mouse/croppeds_bbox/{labels_normal.json,images/*.png} or
{data_root}/cifar10(Classification)/data/cifar-10-batches-py/ (torchvision's
pickled batches).  Runs write to {experiment_root}/<experiment>/: ckpts/,
logs/ (classification: logs/classification.json).

The port's counterpart of ``ubpl_tpu/__main__.py``; its `bench` regime is
not ported yet (ROADMAP A).
"""
import sys

_NOT_PORTED = {
    "bench": "the port bench, bench_torch.py (ROADMAP A.2)",
}


def parse_overrides(argv):
    """``--key=value`` arguments -> {key: int, float or str}; anything else
    is skipped (a copy of ``ubpl_tpu.__main__.parse_overrides``)."""
    params = {}
    for arg in argv:
        if not arg.startswith("--"):
            continue
        key, _, val = arg[2:].partition("=")
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except (ValueError, TypeError):
                continue
        params[key] = val
    return params


def main(argv=None):
    """Run one regime; ``argv`` defaults to ``sys.argv[1:]``.  Returns the
    exit code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__)
        return 1
    regime = argv[0]
    params = parse_overrides(argv[1:])
    device = params.pop("device", None)
    if regime == "supervised":
        from ubpl_torch.train.supervised import exec_regime
        exec_regime("Supervised", params, device)
    elif regime == "mt":
        from ubpl_torch.train.mean_teacher import exec_regime
        exec_regime("MT", params, device)
    elif regime == "mt_ubpl":
        from ubpl_torch.train.mt_ubpl import exec_regime
        exec_regime("MT_UBPL", params, device)
    elif regime == "dualpose":
        from ubpl_torch.train.dualpose_ubpl import exec_regime
        exec_regime("DualPose", {**params, "fdl_weight_max": 0.0,
                                 "fdl_weight_min": 0.0,
                                 "use_ensemble_pseudo": False}, device)
    elif regime == "dualpose_ubpl":
        from ubpl_torch.train.dualpose_ubpl import exec_regime
        exec_regime("DualPose_UBPL", params, device)
    elif regime == "exec":
        from ubpl_torch.train.exec import exec_home
        quick = "quick" in params
        params.pop("quick", None)
        exec_home(extra=params, device=device, quick=quick)
    elif regime == "classification":
        from ubpl_torch.train.classification import exec_regime
        exec_regime("Classification", params, device)
    elif regime == "preview":
        from ubpl_torch.data.preview import main as preview_main
        preview_main(params)
    elif regime in _NOT_PORTED:
        print(f"regime {regime!r} is not ported yet: {_NOT_PORTED[regime]}",
              file=sys.stderr)
        return 2
    else:
        print(f"unknown regime {regime!r}\n{__doc__}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
