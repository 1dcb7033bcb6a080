"""Batch sweep driver (reference projects/exec.py): the port's counterpart
of ``ubpl_tpu/train/exec.py``.

Runs all five regime configurations over the {Mouse, FLIC, LSP} x
{trainCount, labelRatio} grid, the reference's de-facto benchmark suite:

    python -m ubpl_torch exec [--key=value ...]            # full grid
    python -m ubpl_torch exec --quick [--key=value ...]    # 2-epoch smoke
                                                           # over Mouse only
"""
from ..utils.preemption import PreemptionGuard
from .dualpose_ubpl import exec_regime as DualPose_UBPL
from .mean_teacher import exec_regime as MT
from .mt_ubpl import exec_regime as MT_UBPL
from .supervised import exec_regime as Supervised

GRID = [["Mouse", 100, 0.3], ["Mouse", 200, 0.15],
        ["FLIC", 100, 0.3], ["FLIC", 200, 0.15],
        ["LSP", 500, 0.2], ["LSP", 500, 0.4]]
QUICK_GRID = [["Mouse", 24, 0.5]]
QUICK_EXTRA = {"epochs": 2, "valid_count": 16, "model": "HG2"}


def exec_home(grid=None, extra=None, device=None, quick=False):
    """Every regime over ``grid`` (default ``GRID``; ``quick``:
    ``QUICK_GRID`` with ``QUICK_EXTRA``, which ``extra`` overrides), each
    run under a PreemptionGuard (SIGTERM -> checkpoint at the epoch
    boundary).  Returns {regime: history} of the last grid cell."""
    PreemptionGuard.get()
    if quick:
        grid, extra = grid or QUICK_GRID, {**QUICK_EXTRA, **(extra or {})}
    extra = extra or {}
    out = {}
    for data_source, train_count, rate in (grid or GRID):
        base = {"data_source": data_source, "train_count": train_count,
                "label_ratio": rate, **extra}
        out = {
            "Supervised": Supervised("Supervised", dict(base), device),
            "MT": MT("MT", dict(base), device),
            "MT_UBPL": MT_UBPL("MT_UBPL", {**base, "fdl_weight_max": 1.0,
                                           "fdl_weight_min": 1.0,
                                           "use_ensemble_pseudo": True},
                               device),
            "DualPose": DualPose_UBPL("DualPose", {
                **base, "fdl_weight_max": 0.0, "fdl_weight_min": 0.0,
                "use_ensemble_pseudo": False}, device),
            "DualPose_UBPL": DualPose_UBPL("DualPose_UBPL", {
                **base, "fdl_weight_max": 1.0, "fdl_weight_min": 1.0,
                "use_ensemble_pseudo": True}, device)}
    return out
