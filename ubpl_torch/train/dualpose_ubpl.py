"""DualPose(+UBPL) trainer (reference projects/DualPose_UBPL.py).

Port of ``ubpl_tpu/train/dualpose_ubpl.py``.  The dual-branch structure of
MT_UBPL with the DS_mt view pairing: ONE strongly augmented student view
and ONE independently augmented *weak* teacher view (``scale_range_ema``,
``rot_range_ema``, ``use_occlusion_ema``), so 2 heatmap-kernel launches
per step, and a consistency masked by the teacher's confidence
(``joint_dist_mt2`` with the cons sample weights: labeled 1, unlabeled
``pseudo_weight``).  Per step: the two teachers' train-mode forwards on
the teacher view under ``no_grad``, the two students' forwards on the
student view, then

  PEC  gated pose MSE on labeled samples, all stacks
  MTC  ``joint_dist_mt2`` against the branch's own teacher, last stacks
  EPC  ``joint_pseudo3`` against both teachers (``use_ensemble_pseudo``)
  FDC  feature decorrelation between the students (when the FDL weights
       are not both 0), counted twice as in MT_UBPL

one backward (two, combined by the MLD surgery, for ``optimizer="mld"``),
AdamW over both students and the EMA.  ``dualpose`` is the
same trainer with FDL off and no EPC (``ubpl_tpu/__main__.py:63-67``).
``Config.fuse_teacher_forward`` stacks the four forwards into one XLA
program in the JAX package and leaves the values unchanged; it is ignored
here.  Data and branch parallel, the counts, gradients, metrics and the
branch exchanges are as in ``mt_ubpl.teacher_student_step``.
"""
import torch

from . import losses as L
from .base_trainer import run_regime
from .common import sample_weights
from .mt_ubpl import (MTUBPLTrainer, _forward_views, _weighted,
                      branch_features, branch_metrics, ensemble_targets,
                      fdc_loss, global_counts, global_metrics, loss_groups,
                      optimize_and_ema)


def dualpose_step(students, teachers, optimizer, stu_view, ema_view,
                  islabeled, cons_weight, fdl_weight, pseudo_weight,
                  ema_alpha, cfg, group=None, branches=None):
    """One DualPose(_UBPL) step (``ubpl_tpu/train/dualpose_ubpl.py:
    76-196``) of M branches on built views; device-tensor metrics as
    ``mt_ubpl.teacher_student_step`` returns them (``group``: the ranks
    that split the batch; ``branches``: those that split the branches)."""
    M = len(students)
    sw_pos, sw_nega, sw_cons = sample_weights(islabeled, pseudo_weight)
    use_epc = bool(cfg.use_ensemble_pseudo)
    use_fdl = cfg.fdl_weight_max > 0 or cfg.fdl_weight_min > 0
    thr = float(cfg.pseudo_score_thr)
    with torch.no_grad():
        outs_ema = [_forward_views(t, [ema_view], cfg)[0][0]
                    for t in teachers]
    fwd = [_forward_views(s, [stu_view], cfg, remat=cfg.remat)
           for s in students]
    outs = [p[0] for p, _ in fwd]             # [B, S, K, H, W] per branch
    feats = [f[0] for _, f in fwd]
    teacher_outs = (ensemble_targets([[o] for o in outs_ema], branches)[0]
                    if use_epc else None)

    zero = torch.zeros((), device=islabeled.device)
    sums = {k: [zero] * M for k in ("mtc", "mtc_n", "pec", "pec_n", "epc",
                                    "epc_n")}
    n_pseudo = n_sel = zero
    for m in range(M):
        s, n, _ = L.joint_dist_mt2(outs[m][:, -1], outs_ema[m][:, -1],
                                   sample_weight=sw_cons,
                                   use_sample_weight=True, score_thr=thr)
        sums["mtc"][m], sums["mtc_n"][m] = s, n
        s, n = L.joint_mse(outs[m], stu_view.heatmaps, stu_view.gate, sw_pos,
                           use_gate=True, use_sample_weight=True)
        sums["pec"][m], sums["pec_n"][m] = s, n
        if use_epc:
            s, stats = L.joint_pseudo3(outs[m], teacher_outs, sw_nega, thr)
            sums["epc"][m], sums["epc_n"][m] = s, stats.num_pseudo
            n_pseudo = n_pseudo + stats.num_pseudo
            n_sel = n_sel + stats.num_selected
    sums = {k: torch.stack([torch.as_tensor(x, device=zero.device)
                            for x in v]) for k, v in sums.items()}
    counts = global_counts({"mtc_n": sums["mtc_n"], "pec_n": sums["pec_n"],
                            "epc_n": sums["epc_n"], "n_pseudo": n_pseudo,
                            "n_sel": n_sel}, group)
    mtc = _weighted(sums["mtc"], counts["mtc_n"], cons_weight)
    pec = _weighted(sums["pec"], counts["pec_n"], cfg.pose_weight)
    epc = (_weighted(sums["epc"], counts["epc_n"],
                     cfg.ensemble_pseudo_weight)
           if use_epc else torch.zeros_like(mtc))

    fdc = fdc_count = zero
    if use_fdl:
        fdl_mask = {"labeled": sw_pos > 0, "unlabeled": sw_pos == 0,
                    "all": torch.ones_like(sw_pos, dtype=torch.bool)
                    }[cfg.fdl_label]
        fa, fb = branch_features([[f] for f in feats], branches)
        fdc, fdc_count = fdc_loss(fa, fb, fdl_mask, fdl_weight, cfg, group)

    loss, mld_alpha = loss_groups(pec, mtc, epc, fdc, cfg, branches)
    optimize_and_ema(students, teachers, optimizer, loss, ema_alpha,
                     mld_alpha, group, branches)
    return branch_metrics(global_metrics(
        {"pec": pec.detach(), "pec_count": counts["pec_n"],
         "mtc": mtc.detach(), "mtc_count": counts["mtc_n"],
         "epc": epc.detach(), "epc_count": counts["epc_n"],
         "fdc": fdc.detach(), "fdc_count": fdc_count,
         "n_pseudo": counts["n_pseudo"], "n_sel": counts["n_sel"]}, group),
        branches)


class DualPoseUBPLTrainer(MTUBPLTrainer):
    """MT_UBPL's branches, schedules, epoch loop and three-head validation
    with the DualPose step (eager: its own step takes no graph)."""
    regime = "DualPose_UBPL"
    graphs_step = False

    def view_options(self, i):
        """The students' view (0) from the configured ranges, the
        teachers' (1) from the weaker EMA ones."""
        cfg = self.cfg
        return {} if i == 0 else dict(scale_range=cfg.scale_range_ema,
                                      rot_range=cfg.rot_range_ema,
                                      occlude=cfg.use_occlusion_ema)

    def train_step(self, idxs, cons_weight, fdl_weight, pseudo_weight,
                   ema_alpha):
        (stu, ema), islabeled = self.make_views(idxs, 2)
        return dualpose_step(self.students, self.teachers, self.optimizer,
                             stu, ema, islabeled, cons_weight, fdl_weight,
                             pseudo_weight, ema_alpha, self.cfg, self.group,
                             self.branches)


def exec_regime(exp_mark="DualPose_UBPL", params=None, device=None):
    """Entry point of ``dualpose`` / ``dualpose_ubpl``: the reference's
    DualPose defaults weaken the teacher view (``scale_range_ema`` 0.05,
    ``rot_range_ema`` 5.0) unless the parameters set them."""
    params = dict(params or {})
    if not any(k in params for k in ("scale_range_ema", "scaleRange_ema")):
        params["scale_range_ema"] = 0.05
    if not any(k in params for k in ("rot_range_ema", "rotRange_ema")):
        params["rot_range_ema"] = 5.0
    return run_regime(DualPoseUBPLTrainer, exp_mark, params, device)
