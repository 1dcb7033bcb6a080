"""MT+UBPL trainer — the flagship regime (reference projects/MT_UBPL.py).

Port of ``ubpl_tpu/train/mt_ubpl.py``.  Two (student + EMA-teacher)
branches over two augmented views, four constraints per step:

  PEC  gated pose MSE on labeled samples, all stacks (MT_UBPL.py:258-268)
  MTC  consistency with the branch's own teacher, last stacks (:246-256)
  EPC  ensemble pseudo-label loss: target = mean of BOTH teachers' last
       stacks, confidence-masked at pseudoScoreThr, unlabeled only
       (:270-298)
  FDC  feature decorrelation between the two branches on labeled samples
       (:300-331); the reference backs each branch's total through both
       models with retain_graph, so FDC's gradient lands TWICE in each
       branch: the summed loss carries 2 x FDC.

The JAX package vmaps a stacked branch axis; here the branches are separate
``nn.Module``s and ``teacher_student_step`` loops over them (the unfused
form of ``mt_ubpl.py:95-239``, same values).  It also serves the
single-branch MT regime (``train/mean_teacher.py``).  Per step: one
``draw_augment`` + ``make_view`` per view (2 heatmap-kernel launches), the
teachers' train-mode forwards under ``no_grad``, the students' forwards,
one backward, one AdamW step over both students, then the EMA — with no
host sync: every metric stays a device tensor.  With ``optimizer="mld"``
the backward is two pullbacks, PEC and the rest (``loss_groups``), combined
by the MLD gradient surgery (``train/mld_optim.py``) before AdamW.
"""
import torch

from . import losses as L
from . import schedules as S
from .base_trainer import BaseTrainer, run_regime
from .common import forward_heatmaps, sample_weights
from .mld_optim import mld_combine, mld_gradients


def _forward_views(model, views, cfg, remat=False):
    """Train-mode forward of every view through one network, its BatchNorm
    running stats carried from view to view.  ``cfg.fold_views``
    concatenates the views into one batch (BatchNorm then pools its
    statistics over all views).  Returns (preds per view, feats per view).
    """
    dtype = cfg.compute_dtype
    if cfg.fold_views:
        B = views[0].images.shape[0]
        p, f = forward_heatmaps(model, torch.cat([v.images for v in views]),
                                True, dtype, remat=remat)
        return (list(p.split(B)),
                [None] * len(views) if f is None else list(f.split(B)))
    outs = [forward_heatmaps(model, v.images, True, dtype, remat=remat)
            for v in views]
    return [p for p, _ in outs], [f for _, f in outs]


def _weighted(sums, counts, w):
    """w * sum / count per branch; the bare sum where the count is 0."""
    return w * torch.where(counts > 0, sums / counts.clamp(min=1), sums)


def optimize_and_ema(students, teachers, optimizer, loss, ema_alpha,
                     mld_alpha=None):
    """One optimiser step over the students, then each teacher's
    parameters (not its BatchNorm stats) move to ``ema_alpha * teacher +
    (1 - ema_alpha) * student``.

    ``loss`` is the summed loss (one backward), or with ``mld_alpha`` set
    (``Config.optimizer="mld"``) the pair (primary, secondary): their two
    gradients over the students' parameters are combined by
    ``mld_optim.mld_combine`` and written into ``.grad``."""
    optimizer.zero_grad(set_to_none=True)
    if mld_alpha is None:
        loss.backward()
    else:
        params = [p for s in students for p in s.parameters()]
        g_pri, g_sec = mld_gradients(*loss, params)
        for p, g in zip(params, mld_combine(g_pri, g_sec, mld_alpha)):
            p.grad = g
    optimizer.step()
    with torch.no_grad():
        ema = [p for t in teachers for p in t.parameters()]
        new = [p for s in students for p in s.parameters()]
        torch._foreach_mul_(ema, ema_alpha)
        torch._foreach_add_(ema, new, alpha=1.0 - ema_alpha)


def loss_groups(pec, mtc, epc, fdc, cfg):
    """The step's loss for ``optimize_and_ema``: PEC is the primary group,
    MTC + EPC + 2 x FDC the secondary (``ubpl_tpu/train/mt_ubpl.py:
    205-206``); summed for AdamW, a pair with the MLD weight for
    ``optimizer="mld"``.  Returns (loss, mld_alpha)."""
    pri, sec = pec.sum(), (mtc + epc).sum() + 2.0 * fdc
    if cfg.optimizer == "mld":
        return (pri, sec), float(cfg.mld_alpha)
    return pri + sec, None


def teacher_student_step(students, teachers, optimizer, views, islabeled,
                         cons_weight, fdl_weight, pseudo_weight, ema_alpha,
                         cfg, *, use_epc, use_fdc):
    """One optimisation step of M (student, EMA teacher) branches on built
    views: M = 2 with EPC and FDC is MT_UBPL, M = 1 without them is MT.

    Teachers run first, without grad but in train-mode BatchNorm (their
    running stats move; reference MT_UBPL.py:235-238), from their pre-step
    parameters.  After the optimiser step each teacher's parameters (not
    its BatchNorm stats) move to ``ema_alpha * teacher + (1 - ema_alpha) *
    student`` with the NEW student parameters.  Returns device-tensor
    metrics; the per-branch ones have shape [M].
    """
    M = len(students)
    sw_pos, sw_nega, _ = sample_weights(islabeled, pseudo_weight)
    with torch.no_grad():
        outs_ema = [_forward_views(t, views, cfg)[0] for t in teachers]
    fwd = [_forward_views(s, views, cfg, remat=cfg.remat) for s in students]
    outs = [p for p, _ in fwd]          # outs[m][a]: [B, S, K, H, W]
    feats = [f for _, f in fwd]         # feats[m][a]: [B, N, C, hf, wf]
    if use_epc:
        teacher_outs = [torch.stack([outs_ema[m][a] for m in range(M)])
                        for a in range(len(views))]

    zero = torch.zeros((), device=islabeled.device)
    sums = {k: [zero] * M for k in ("mtc", "mtc_n", "pec", "pec_n", "epc",
                                    "epc_n")}
    n_pseudo = n_sel = zero

    def add(key, m, s, n):
        sums[key][m] = sums[key][m] + s
        sums[key + "_n"][m] = sums[key + "_n"][m] + n

    for a, v in enumerate(views):
        for m in range(M):
            add("mtc", m, *L.joint_dist(outs[m][a][:, -1],
                                        outs_ema[m][a][:, -1]))
            add("pec", m, *L.joint_mse(outs[m][a], v.heatmaps, v.gate, sw_pos,
                                       use_gate=True, use_sample_weight=True))
            if use_epc:
                s, stats = L.joint_pseudo3(outs[m][a], teacher_outs[a],
                                           sw_nega, cfg.pseudo_score_thr)
                add("epc", m, s, stats.num_pseudo)
                n_pseudo = n_pseudo + stats.num_pseudo
                n_sel = n_sel + stats.num_selected
    sums = {k: torch.stack(v) for k, v in sums.items()}
    mtc = _weighted(sums["mtc"], sums["mtc_n"], cons_weight)
    pec = _weighted(sums["pec"], sums["pec_n"], cfg.pose_weight)
    epc = (_weighted(sums["epc"], sums["epc_n"], cfg.ensemble_pseudo_weight)
           if use_epc else torch.zeros_like(mtc))

    fdc = fdc_count = zero
    if use_fdc:
        # between the two branches, per view, over the fdl_label samples
        fdl_mask = {"labeled": sw_pos > 0, "unlabeled": sw_pos == 0,
                    "all": torch.ones_like(sw_pos, dtype=torch.bool)
                    }[cfg.fdl_label]
        fdl = (L.features_cov_masked if cfg.fdl_type == "covariance"
               else L.joint_feature_dist_masked)
        fdc_sum = zero
        for a in range(len(views)):
            c, n = fdl(feats[0][a], feats[1][a], fdl_mask)
            fdc_sum, fdc_count = fdc_sum + c, fdc_count + n
        fdc = fdl_weight * torch.where(fdc_count > 0,
                                       fdc_sum / fdc_count.clamp(min=1),
                                       fdc_sum)

    loss, mld_alpha = loss_groups(pec, mtc, epc, fdc, cfg)
    optimize_and_ema(students, teachers, optimizer, loss, ema_alpha,
                     mld_alpha)
    return {"pec": pec.detach(), "pec_count": sums["pec_n"],
            "mtc": mtc.detach(), "mtc_count": sums["mtc_n"],
            "epc": epc.detach(), "epc_count": sums["epc_n"],
            "fdc": fdc.detach(), "fdc_count": fdc_count,
            "n_pseudo": n_pseudo, "n_sel": n_sel}


def mt_ubpl_step(students, teachers, optimizer, views, islabeled,
                 cons_weight, fdl_weight, pseudo_weight, ema_alpha, cfg):
    """One MT_UBPL step (``ubpl_tpu/train/mt_ubpl.py:95-239``) of two
    branches on built views; see ``teacher_student_step``."""
    return teacher_student_step(
        students, teachers, optimizer, views, islabeled, cons_weight,
        fdl_weight, pseudo_weight, ema_alpha, cfg,
        use_epc=bool(cfg.use_ensemble_pseudo), use_fdc=True)


class MTUBPLTrainer(BaseTrainer):
    regime = "MT_UBPL"
    valid_heads = ("teacher1", "teacher2", "mean")
    n_models = 2
    supports_pseudo_loop = True     # cfg.pseudo_rounds > 0: UBPL rounds
    supports_mld = True             # primary PEC, secondary MTC+EPC+2*FDC

    @property
    def n_views(self):
        return self.cfg.br_num * self.cfg.br_aug_num  # 2 by default

    def _setup_model(self):
        self._setup_branches(self.n_models)

    def train_step(self, idxs, cons_weight, fdl_weight, pseudo_weight,
                   ema_alpha):
        views, islabeled = self.make_views(idxs, self.n_views)
        return mt_ubpl_step(self.students, self.teachers, self.optimizer,
                            views, islabeled, cons_weight, fdl_weight,
                            pseudo_weight, ema_alpha, self.cfg)

    def epoch_schedules(self, epo):
        return S.ssl_epoch_schedules(self.cfg, epo)

    def train_epoch(self, epo, schedules):
        M = self.n_models
        pec_cs = [L.AvgCounter() for _ in range(M)]
        mtc_cs = [L.AvgCounter() for _ in range(M)]
        epc_cs = [L.AvgCounter() for _ in range(M)]
        fdc_c = L.AvgCounter()
        metrics = self.run_train_steps(
            self.make_sampler(), schedules["cons_weight"],
            schedules["fdl_weight"], schedules["pseudo_weight"],
            schedules["ema_alpha"])
        for step in metrics:
            m = {k: v.tolist() for k, v in step.items()}
            for i in range(M):
                pec_cs[i].update(m["pec"][i], m["pec_count"][i])
                mtc_cs[i].update(m["mtc"][i], m["mtc_count"][i])
                epc_cs[i].update(m["epc"][i], max(int(m["epc_count"][i]), 1))
            fdc_c.update(m["fdc"], max(int(m["fdc_count"]), 1))
        return {"pec_losses": [c.avg for c in pec_cs],
                "mtc_losses": [c.avg for c in mtc_cs],
                "epc_losses": [c.avg for c in epc_cs],
                "fdc_loss": fdc_c.avg}

    def validate(self):
        """Both teachers and the mean of their predictions
        (MT_UBPL.py:355-408)."""
        return self._validate_heads(self.teachers, True)

    def format_epoch_log(self, losses, accs, errs):
        return ("pec: [{}] | mtc: [{}] | epc: [{}] | fdc: {:.5f} | "
                "mean acc: {:.5f}, err: {:.3f}".format(
                    ", ".join(f"{v:.5f}" for v in losses["pec_losses"]),
                    ", ".join(f"{v:.5f}" for v in losses["mtc_losses"]),
                    ", ".join(f"{v:.5f}" for v in losses["epc_losses"]),
                    losses["fdc_loss"], accs[-1][-1], errs[-1][-1]))


def exec_regime(exp_mark="MT_UBPL", params=None, device=None):
    """Entry point of the ``mt_ubpl`` regime (``run_regime``)."""
    return run_regime(MTUBPLTrainer, exp_mark, params, device)
