"""Epoch-indexed SSL schedules (reference utils/parameters.py).

The port's own copy of ``ubpl_tpu/train/schedules.py:11-94``: plain floats,
computed on the host once per epoch and handed to the training step as
scalars, as the reference trainers recompute args.consWeight etc. per epoch
(projects/MT_UBPL.py:74-78).  All ramps wrap the Mean-Teacher sigmoid
rampup exp(-5(1-t)^2).
"""
import math


def sigmoid_rampup(current, rampup_length):
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return math.exp(-5.0 * phase * phase)


def value_increase(epo, max_value, min_value, rampup):
    return min_value + (max_value - min_value) * sigmoid_rampup(epo, rampup)


def value_decrease(epo, max_value, min_value, rampup):
    return min_value + (max_value - min_value) * (1.0 - sigmoid_rampup(epo, rampup))


def cons_weight(epo, max_value=10.0, min_value=0.0, rampup=5):
    """consWeight_increase with the reference defaults."""
    return value_increase(epo, max_value, min_value, rampup)


def pseudo_weight(epo, max_value=1.0, min_value=1.0, rampup=100):
    return value_increase(epo, max_value, min_value, rampup)


def fdl_weight(epo, max_value=1.0, min_value=1.0, rampup=100):
    """FDLWeight_decrease with the reference defaults (flat at 1.0)."""
    return value_decrease(epo, max_value, min_value, rampup)


def ema_alpha(epo, ema_decay=0.999):
    """Reference update_ema_variables: epoch-indexed warmup to ema_decay."""
    return min(1.0 - 1.0 / (epo + 1), ema_decay)


def step_schedule(epo, stages, values, epochs):
    """Reference FDLWeight_Step: piecewise sigmoid ramps between stages."""
    stages, values = list(stages), list(values)
    if stages[0] > 0:
        stages = [0] + stages
        values = [0.0] + values
    if stages[-1] < epochs:
        stages = stages + [500]
        values = values + [0.0]
    in_idx = 0
    for s_idx, stage in enumerate(stages):
        if epo >= stage:
            in_idx = s_idx
    min_v, max_v = values[in_idx], values[in_idx + 1]
    rampup = stages[in_idx + 1] - stages[in_idx]
    epo_v = epo - stages[in_idx]
    if min_v <= max_v:
        return value_increase(epo_v, max_v, min_v, rampup)
    return value_decrease(epo_v, min_v, max_v, rampup)


def cawr_schedule(epo, stages, start_values, min_value):
    """Reference FDLWeight_CAWR: cosine-annealing-with-warm-restarts analogue."""
    stages_plus = [0] + list(stages)
    in_idx = 0
    for s_idx, stage in enumerate(stages_plus):
        if epo >= stage:
            in_idx = s_idx
    max_v = start_values[in_idx]
    rampup = stages_plus[in_idx + 1] - stages_plus[in_idx]
    epo_v = (epo - stages_plus[in_idx]) if in_idx > 0 else epo
    return value_decrease(epo_v, max_v, min_value, rampup)


def ssl_epoch_schedules(cfg, epo) -> dict:
    """The per-epoch scalar schedule shared by the dual-branch UBPL regimes
    (MT_UBPL and DualPose_UBPL use identical ramps, projects/MT_UBPL.py:72-76
    / DualPose_UBPL.py:71-75)."""
    return {
        "cons_weight": cons_weight(epo, cfg.cons_weight_max,
                                   cfg.cons_weight_min,
                                   cfg.cons_weight_rampup),
        "fdl_weight": fdl_weight(epo, cfg.fdl_weight_max, cfg.fdl_weight_min,
                                 cfg.fdl_weight_rampup),
        "pseudo_weight": pseudo_weight(epo, cfg.pseudo_weight_max,
                                       cfg.pseudo_weight_min,
                                       cfg.pseudo_weight_rampup),
        "ema_alpha": ema_alpha(epo, cfg.ema_decay),
    }
