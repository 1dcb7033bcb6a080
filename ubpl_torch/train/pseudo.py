"""Uncertainty-Based Pseudo-Labeling (UBPL) business logic (reference
utils/business.py): the scoring and selection rules that the pseudo-label
rounds of ``train/pseudo_loop.py`` run between their teacher passes.

The port's own copy of ``ubpl_tpu/train/pseudo.py`` (numpy only, float64,
the same values).  A fixed-shape "pseudo bank" of [N, K] per-keypoint
records (coords, scores, distances, reliability, selection mask), with
every scoring rule vectorised:

  * quality audit vs retained ground truth (kps_test)      business.py:15-40
  * reliability = 1 - normalized inter-model distance;
    quantile threshold selection (reliablePCT)             business.py:48-91
  * two-teacher intDist/extDist ensemble weighting          business.py:108-161
  * LMA (last-3 weighted moving average) smoothing          business.py:397-406
  * mixed uncertainty 1 - exp(-mixDist/5)                   business.py:375-376
"""
from typing import NamedTuple

import numpy as np

LMA_ALPHAS = (0.5, 0.3, 0.2)
ILLEGAL = 999.0


def pck_norms(gts, pck_ref):
    """Per-sample PCK reference distance (eval.acc_pck_pseudo_norm).
    gts: [N, K, >=2] -> [N]."""
    gts = np.asarray(gts)
    r0, r1 = pck_ref
    return np.linalg.norm(gts[:, r0, 0:2] - gts[:, r1, 0:2], axis=-1)


def assess_pseudo(preds, gts, pck_ref, pck_thr):
    """Quality audit of predictions vs retained truth (assess_pseudo_unc).

    preds/gts: [N, K, 2+].  Returns (errors [N, K], acc_flags [N, K],
    legal [N, K]) where legal = both coords >= 0.
    """
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    errors = np.linalg.norm(preds[..., 0:2] - gts[..., 0:2], axis=-1)
    norms = pck_norms(gts, pck_ref)
    acc_flags = (errors / norms[:, None] < pck_thr).astype(np.int32)
    legal = ((preds[..., 0] >= 0) & (preds[..., 1] >= 0)).astype(np.float64)
    return errors, acc_flags, legal


def reliability_from_dist(dists, legal, reliable_dist_min):
    """Reference filter_pseudo reliability: min-max normalize the inter-model
    distance over the whole bank (min clamped to reliableDistMin), illegal
    points get reliability 0."""
    dists = np.asarray(dists, np.float64)
    d_max = float(np.max(dists))
    d_min = min(float(np.min(dists)), reliable_dist_min)
    span = max(d_max - d_min, 1e-12)
    unc = np.where(legal > 0, (dists - d_min) / span, 1.0)
    return 1.0 - unc


def reliability_threshold(reliabilities, reliable_pct, reliable_thr):
    """Reference _calReliabilityThr: the reliablePCT-quantile of the sorted
    (descending) reliability list, floored at reliableThr."""
    scores = np.sort(np.asarray(reliabilities).ravel())[::-1]
    idx = int((len(scores) - 1) * reliable_pct)
    return max(reliable_thr, float(scores[idx]))


class Selection(NamedTuple):
    enable: np.ndarray      # [N, K] 0/1
    sel_counts: np.ndarray  # [K+1]
    sel_errs: np.ndarray    # [K+1] mean error of selected
    sel_accs: np.ndarray    # [K+1] mean acc flag of selected
    threshold: float


def select_pseudo(reliabilities, errors, acc_flags, reliable_pct,
                  reliable_thr):
    """Reference filter_pseudo selection + per-joint audit accumulation."""
    rel = np.asarray(reliabilities)
    N, K = rel.shape
    thr = reliability_threshold(rel, reliable_pct, reliable_thr)
    enable = (rel > thr).astype(np.int32)
    sel_counts = np.zeros(K + 1)
    sel_errs = np.zeros(K + 1)
    sel_accs = np.zeros(K + 1)
    for k in range(K):
        m = enable[:, k] > 0
        c = int(m.sum())
        sel_counts[k] = c
        if c:
            sel_errs[k] = errors[m, k].mean()
            sel_accs[k] = acc_flags[m, k].mean()
    total = enable.sum()
    sel_counts[-1] = total
    if total:
        sel_errs[-1] = errors[enable > 0].mean()
        sel_accs[-1] = acc_flags[enable > 0].mean()
    return Selection(enable, sel_counts, sel_errs, sel_accs, thr)


def pairwise_avg_distance(coords):
    """Mean pairwise distance over the leading axis (coord_avgDistance).
    coords: [A, ..., 2] -> [...]."""
    coords = np.asarray(coords, np.float64)
    A = coords.shape[0]
    total = np.zeros(coords.shape[1:-1])
    n = 0
    for i in range(A):
        for j in range(i + 1, A):
            total = total + np.linalg.norm(coords[i, ..., 0:2]
                                           - coords[j, ..., 0:2], axis=-1)
            n += 1
    return total / max(n, 1)


class EnsembleAssessment(NamedTuple):
    coords: np.ndarray     # [N, K, 2] intDist-weighted ensemble coords
    w1: np.ndarray         # [N, K]
    w2: np.ndarray         # [N, K]
    int_dist1: np.ndarray  # [N, K]
    int_dist2: np.ndarray  # [N, K]
    ext_dist: np.ndarray   # [N, K]
    legal: np.ndarray      # [N, K]
    errors: np.ndarray     # [N, K] vs retained truth
    acc_flags: np.ndarray  # [N, K]


def assess_ensemble(ori_preds1, ori_preds2, aug_preds1, aug_preds2, gts,
                    pck_ref, pck_thr):
    """Two-teacher ensemble weighting (assess_pseudo_unc2).

    ori_preds{1,2}: [N, K, 2] each teacher's prediction on the original view;
    aug_preds{1,2}: [A, N, K, 2] predictions over A augmented views.

      intDist_m = mean pairwise distance of teacher m over the A views
                  (a per-sample "cognition" spread);
      weights w_m = intDist_m / (intDist_1 + intDist_2)  — the reference's
                  own convention (the *larger*-spread teacher gets the
                  larger weight; reproduced faithfully, business.py:133-134);
      ensemble coord = w1 * p1 + w2 * p2;
      extDist = mean over views of the two teachers' distance.
    """
    p1 = np.asarray(ori_preds1, np.float64)
    p2 = np.asarray(ori_preds2, np.float64)
    a1 = np.asarray(aug_preds1, np.float64)
    a2 = np.asarray(aug_preds2, np.float64)
    legal = (((p1[..., 0] >= 0) & (p1[..., 1] >= 0)
              & (p2[..., 0] >= 0) & (p2[..., 1] >= 0))
             & (a1[..., 0] >= 0).all(0) & (a1[..., 1] >= 0).all(0)
             & (a2[..., 0] >= 0).all(0) & (a2[..., 1] >= 0).all(0)
             ).astype(np.float64)
    int1 = pairwise_avg_distance(a1)
    int2 = pairwise_avg_distance(a2)
    denom = int1 + int2
    # reference would divide 0/0 when both teachers are perfectly stable
    # across views (business.py:133-134); fall back to an even split
    w1 = np.where(denom > 0, int1 / np.maximum(denom, 1e-12), 0.5)
    w2 = 1.0 - w1
    coords = w1[..., None] * p1[..., 0:2] + w2[..., None] * p2[..., 0:2]
    coords = np.where(legal[..., None] > 0, coords, p1[..., 0:2])
    ext = np.mean(np.linalg.norm(a1[..., 0:2] - a2[..., 0:2], axis=-1), axis=0)
    int1 = np.where(legal > 0, int1, ILLEGAL)
    int2 = np.where(legal > 0, int2, ILLEGAL)
    ext = np.where(legal > 0, ext, ILLEGAL)
    errors, acc_flags, _ = assess_pseudo(coords, gts, pck_ref, pck_thr)
    return EnsembleAssessment(coords, w1, w2, int1, int2, ext, legal,
                              errors, acc_flags)


class LMACache:
    """Last-3 weighted moving average per (sample, joint) distance history
    (reference _lma_variables / getLMAfromCache), batched as [N, K, T<=3]."""

    def __init__(self, shape):
        self.history = np.full(shape + (3,), np.nan)

    def update(self, values):
        """Push new values [N, K]; return their LMA."""
        self.history = np.concatenate(
            [self.history[..., 1:], np.asarray(values)[..., None]], axis=-1)
        return self.current()

    def current(self):
        h = self.history
        a0, a1, a2 = LMA_ALPHAS
        newest, mid, oldest = h[..., 2], h[..., 1], h[..., 0]
        n_valid = (~np.isnan(h)).sum(-1)
        out = np.where(n_valid >= 3,
                       np.nan_to_num(newest * a0 + mid * a1 + oldest * a2),
                       np.where(n_valid == 2,
                                np.nan_to_num(newest * (a0 + a1) + mid * a2),
                                np.where(n_valid == 1,
                                         np.nan_to_num(newest), ILLEGAL)))
        return out


def mixed_uncertainty(int_dist_lma, ext_dist_lma, aext_dist_lma, dist_thr_max):
    """Reference mixDist + unc (business.py:368-376): mixDist = intDist_lma +
    mean of (extDist_lma, aExtDist_lma) [aExt alone when ext <= 0];
    unc = 1 - exp(-mixDist / 5), forced to 999 when any component exceeds
    distThrMax."""
    ext_part = np.where(ext_dist_lma > 0,
                        (ext_dist_lma + aext_dist_lma) / 2.0, aext_dist_lma)
    mix = int_dist_lma + ext_part
    unc = 1.0 - np.exp(-mix / 5.0)
    ok = ((int_dist_lma <= dist_thr_max) & (ext_dist_lma <= dist_thr_max)
          & (aext_dist_lma <= dist_thr_max))
    return np.where(ok, unc, ILLEGAL), mix


def apply_pseudo_labels(arrays, sample_idxs, coords, enable):
    """Dataset update hook (reference DS_mds.update / DS_mt.update): inject
    selected pseudo keypoints into the materialized train arrays in place.

    arrays: data.arrays.PoseArrays; sample_idxs: [N] dataset rows;
    coords: [N, K, 2]; enable: [N, K] selection mask.
    """
    kps = arrays.kps
    for row, c, e in zip(np.asarray(sample_idxs), np.asarray(coords),
                         np.asarray(enable)):
        sel = e > 0
        kps[row, sel, 0:2] = c[sel]
        kps[row, sel, 2] = 1.0
    return arrays
