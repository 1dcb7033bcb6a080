"""Mean-Teacher trainer (reference projects/MT.py).

Port of ``ubpl_tpu/train/mean_teacher.py``: one student and its EMA
teacher, two independently augmented views per batch, consistency on the
last stacks (MTC) plus the gated pose loss (PEC) on both views,
epoch-indexed EMA, two-stream batches (unlabeled first, then labeled).  The
step is the single-branch case of ``mt_ubpl.teacher_student_step`` with the
ensemble pseudo-label and feature-decorrelation terms off (its global
counts, gradients and metrics with it, data parallel).
"""
from . import losses as L
from . import schedules as S
from .base_trainer import BaseTrainer, run_regime
from .mt_ubpl import teacher_student_step


def mean_teacher_step(student, teacher, optimizer, views, islabeled,
                      cons_weight, ema_alpha, cfg, group=None):
    """One MT step (``ubpl_tpu/train/mean_teacher.py:66-138``) on built
    views; returns device-tensor metrics {"pec_loss", "pec_count",
    "mtc_loss", "mtc_count"}."""
    m = teacher_student_step([student], [teacher], optimizer, views,
                             islabeled, cons_weight, 0.0, 0.0, ema_alpha,
                             cfg, use_epc=False, use_fdc=False, group=group)
    return {"pec_loss": m["pec"][0], "pec_count": m["pec_count"][0],
            "mtc_loss": m["mtc"][0], "mtc_count": m["mtc_count"][0]}


class MeanTeacherTrainer(BaseTrainer):
    regime = "MT"
    valid_heads = ("student", "teacher")
    n_views = 2  # brNum * br_augNum (projects/MT.py:59)
    graphs_step = True

    def _setup_model(self):
        self._setup_branches(1)

    def train_step(self, idxs, cons_weight, ema_alpha):
        views, islabeled = self.make_views(idxs, self.n_views)
        self.count_backbone(views)
        return self.step_graph(self.step_after_views, views, islabeled,
                               (cons_weight,), ema_alpha, self.param_dtype)

    def step_after_views(self, views, islabeled, cons_weight, ema_alpha):
        return mean_teacher_step(self.students[0], self.teachers[0],
                                 self.optimizer, views, islabeled,
                                 cons_weight, ema_alpha, self.cfg,
                                 self.group)

    def epoch_schedules(self, epo):
        cfg = self.cfg
        return {"cons_weight": S.cons_weight(epo, cfg.cons_weight_max,
                                             cfg.cons_weight_min,
                                             cfg.cons_weight_rampup),
                "ema_alpha": S.ema_alpha(epo, cfg.ema_decay)}

    def train_epoch(self, epo, schedules):
        counters = {k: L.AvgCounter() for k in ("pec", "mtc")}
        metrics = self.run_train_steps(self.make_sampler(),
                                       schedules["cons_weight"],
                                       schedules["ema_alpha"])
        for m in metrics:
            for k, c in counters.items():
                c.update(float(m[f"{k}_loss"]), int(m[f"{k}_count"]))
        return {"pec_loss": counters["pec"].avg,
                "mtc_loss": counters["mtc"].avg}

    def validate(self):
        return self._validate_heads([self.students[0], self.teachers[0]],
                                    False)


def exec_regime(exp_mark="MT", params=None, device=None):
    """Entry point of the ``mt`` regime (``run_regime``)."""
    return run_regime(MeanTeacherTrainer, exp_mark, params, device)
