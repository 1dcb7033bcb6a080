"""UBPL pseudo-label rounds of the dual-teacher regimes
(``Config.pseudo_rounds``).

Port of ``ubpl_tpu/train/pseudo_loop.py:33-152``.  The reference ships the
machinery (utils/business.py + dataset.update()) but never wires it into a
trainer; here, as in the JAX package, one round

  1. runs both EMA teachers, eval-mode BatchNorm, without grad, on every
     unlabeled sample: one view without augmentation and ``aug_views``
     augmented views, ``infer_bs`` rows at a time; each teacher's last
     stack is warped back to the original frame (``affine_back``) and
     decoded at the centre ``inp_res // 2`` and scale 1 (the reference's
     test_affine_back convention).  The views skip target synthesis:
     nothing reads their heatmaps, so a round launches no heatmap kernel;
  2. scores each keypoint (``train/pseudo.py``): per-teacher spread over the
     views (intDist), inter-teacher distance (extDist), the intDist-weighted
     ensemble coordinate, LMA smoothing over rounds and the mixed
     uncertainty 1 - exp(-mixDist/5);
  3. selects by reliability quantile and writes the chosen keypoints into
     the trainer's device arrays (``_apply``), auditing them against the
     retained truth (``kps_test``).

The augmentation draws are an argument (``draws(lo, a, batch)`` ->
``AugmentDraws`` for view ``a`` of the rows starting at ``lo``), so tests
can feed ``jax.random``'s; ``round_draws`` gives the trainer's default, a
``torch.Generator`` seeded from (seed, 7919 + epoch), where the JAX package
folds ``PRNGKey(seed)`` with ``7919 + epoch``.  The port has no compiled
step closing over the data, so nothing is rebuilt after an update.

Data parallel (the trainer's ``group``), every rank gathers each inference
batch whole, draws its augmentations for the whole batch (the generators
stay in step), predicts its share of the rows and the shares are gathered
in order (``BaseTrainer.predict_split``); every rank then runs the same
numpy selection and injects the rows that it holds.  Branch parallel (the
trainer's ``branches``), each rank predicts with its own teachers and the
coordinates are gathered over the branch group before the selection.
"""
import numpy as np
import torch

from ..ops import augment as A
from ..ops import heatmap as HM
from ..ops.transforms import affine_back
from . import pseudo as P
from .common import forward_heatmaps, make_view


def round_draws(seed, epoch, device):
    """The draws of the round after ``epoch``: one generator on ``device``
    seeded from (seed, 7919 + epoch), drawn from in the loop's order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(
        [seed, 7919 + epoch]).generate_state(1)[0]))
    return lambda lo, a, batch: A.draw_augment(batch, gen, device)


class PseudoLabelingLoop:
    def __init__(self, trainer, aug_views=2, reliable_pct=0.5,
                 reliable_thr=0.2, dist_thr_max=20.0, use_lma=True,
                 batch_size=32):
        self.trainer = trainer
        self.aug_views = aug_views
        self.reliable_pct = reliable_pct
        self.reliable_thr = reliable_thr
        self.dist_thr_max = dist_thr_max
        self.batch_size = batch_size
        cfg = trainer.cfg
        n_unl = len(trainer.unlabeled_idxs)
        self.lma_int = [P.LMACache((n_unl, cfg.kps_count)) for _ in range(2)] \
            if use_lma else None
        self.lma_ext = P.LMACache((n_unl, cfg.kps_count)) if use_lma else None
        # pristine copies: each apply RESETS then injects, like the
        # reference's dataArray_reset (datasets/dataset_mds.py:15-16)
        self._kps0 = trainer.train_data.kps.clone()
        self._islabeled0 = trainer.train_data.islabeled.clone()

    # ------------------------------------------------------------ inference
    def inference_view(self, images_u8, kps, draws):
        """One view of a batch of unlabeled rows (``draws=None``: without
        augmentation), colour-normalised, without targets."""
        tr = self.trainer
        return make_view(images_u8, kps, tr.means, tr.cfg, draws,
                         targets=False)

    @torch.no_grad()
    def back_warped(self, view):
        """Every teacher's last stack on ``view`` (eval-mode BatchNorm),
        warped back to the original frame: [M, B, K, H, W]."""
        tr = self.trainer
        return torch.stack([
            affine_back(forward_heatmaps(t, view.images, False,
                                         tr.cfg.compute_dtype)[0][:, -1],
                        view.warpmat, view.isflip)
            for t in tr.teachers])

    def decode(self, back):
        """Original-frame coordinates [M, B, K, 2] of back-warped maps."""
        cfg = self.trainer.cfg
        B, dev = back.shape[1], back.device
        center = torch.full((B, 2), float(cfg.inp_res // 2), device=dev)
        coords, _, _, _ = HM.decode_heatmaps_mul(
            back, center, torch.ones((B,), device=dev),
            (cfg.out_res, cfg.out_res))
        return coords

    def predict_all(self, draws):
        """Both teachers on every unlabeled sample: (ori [M, N, K, 2],
        augs [aug_views, M, N, K, 2]) as float64 numpy; one read to the
        host.  The teachers are left in train mode, as the steps run
        them.  Branch parallel, this rank's teachers' coordinates are
        gathered with the others' in one collective."""
        tr = self.trainer
        idxs = np.asarray(tr.unlabeled_idxs)
        per_batch = []
        try:
            for lo in range(0, len(idxs), self.batch_size):
                batch = idxs[lo:lo + self.batch_size]
                imgs, kps = tr.gather_rows(tr.train_data, batch,
                                           ("images", "kps_test"))
                aug = [draws(lo, a, len(batch))
                       for a in range(self.aug_views)]

                def predict(pick):
                    im, kp = imgs[pick], kps[pick]
                    views = [self.inference_view(im, kp, None)] + [
                        self.inference_view(im, kp, type(d)(
                            *(x[pick] for x in d))) for d in aug]
                    return torch.stack([self.decode(self.back_warped(v))
                                        for v in views]).permute(2, 0, 1, 3, 4)

                per_batch.append(tr.predict_split(predict, len(batch)))
        finally:
            for t in tr.teachers:
                t.train()
        coords = torch.cat(per_batch).permute(2, 0, 1, 3, 4)  # [M, N, V..]
        if tr.branches is not None:
            coords = tr.branches.gather_branches(coords)
        coords = (coords.permute(2, 0, 1, 3, 4)
                  .cpu().double().numpy())             # [V, M, N, K, 2]
        return coords[0], coords[1:]

    # ------------------------------------------------------------ selection
    def round(self, draws, apply=True):
        """One selection round; returns (Selection, EnsembleAssessment)."""
        tr = self.trainer
        cfg = tr.cfg
        idxs = np.asarray(tr.unlabeled_idxs)
        gts = tr.gather_rows(tr.train_data, idxs, ("kps_test",))[0] \
            .cpu().numpy()                                 # retained truth
        ori, augs = self.predict_all(draws)
        ens = P.assess_ensemble(ori[0], ori[1], augs[:, 0], augs[:, 1], gts,
                                tuple(cfg.pck_ref), cfg.pck_thr)
        ext = ens.ext_dist
        if self.lma_ext is not None:
            int1 = self.lma_int[0].update(ens.int_dist1)
            int2 = self.lma_int[1].update(ens.int_dist2)
            ext = self.lma_ext.update(ens.ext_dist)
            unc, _ = P.mixed_uncertainty((int1 + int2) / 2, ext, ext,
                                         self.dist_thr_max)
            rel = 1.0 - np.clip(unc, 0.0, 1.0)
            rel = np.where(ens.legal > 0, rel, 0.0)
        else:
            rel = P.reliability_from_dist(ext, ens.legal,
                                          reliable_dist_min=1.0)
        sel = P.select_pseudo(rel, ens.errors, ens.acc_flags,
                              self.reliable_pct, self.reliable_thr)
        if apply and sel.sel_counts[-1] > 0:
            self._apply(idxs, ens.coords, sel.enable)
        return sel, ens

    def _apply(self, sample_idxs, coords, enable):
        """dataset.update() semantics (datasets/dataset_mds.py:14-25) on the
        trainer's device tensors: reset to the pristine arrays, inject the
        enabled pseudo keypoints with vis = 1, and flip their samples into
        the labeled pool (islabeled = 1) so the 'pos' sample weights apply
        PEC to them.  The sampler's index lists stay fixed, as in the
        reference (its loader is never rebuilt).  Data parallel, a rank
        writes the rows it holds."""
        tr = self.trainer
        dev = self._kps0.device
        local = np.asarray(sample_idxs) - tr.train_data.offset
        own = (local >= 0) & (local < self._kps0.shape[0])
        rows = torch.as_tensor(local[own], device=dev)
        on = torch.as_tensor(np.asarray(enable)[own] > 0, device=dev)
        xy = torch.as_tensor(np.asarray(coords)[own], dtype=torch.float32,
                             device=dev)
        kps = self._kps0.clone()
        islabeled = self._islabeled0.clone()
        sub = kps[rows]
        sub[..., 0:2] = torch.where(on[..., None], xy, sub[..., 0:2])
        sub[..., 2] = torch.where(on, 1.0, sub[..., 2])
        kps[rows] = sub
        islabeled[rows] = torch.where(on.any(dim=1), 1, islabeled[rows])
        tr.train_data = tr.train_data._replace(kps=kps, islabeled=islabeled)
