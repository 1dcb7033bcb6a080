"""PCK evaluation as fixed-shape masked reductions.

Port of ``ubpl_tpu/ops/pck.py`` (reference utils/evaluation.py:92-139):

  * dists[b, k]     = ||pred - gt|| if gt_x > 1 and gt_y > 1 else -1
  * dists_ref[b, k] = dists / ||gt[ref0] - gt[ref1]||  (same -1 convention)
  * errs[k]  = batch mean of dists *including* the -1 entries
  * errs[K]  = mean of the per-joint errs
  * accs[k]  = fraction of valid dists_ref below thr, or -1 if none valid
  * accs[K]  = mean of the per-joint accs that are >= 0 (0 if none)
"""
import torch


def acc_pck(preds, gts, pck_ref, pck_thr):
    """preds: [B, K, 2]; gts: [B, K, >=2] (only x, y used).

    Returns (errs [K+1], accs [K+1]) in the reference layout.
    """
    preds = preds.float()
    gts = gts.float()
    r0, r1 = pck_ref
    norm = torch.linalg.vector_norm(gts[:, r0, 0:2] - gts[:, r1, 0:2], dim=-1)
    d = torch.linalg.vector_norm(preds[..., 0:2] - gts[..., 0:2], dim=-1)
    valid = (gts[..., 0] > 1) & (gts[..., 1] > 1)
    neg = torch.full_like(d, -1.0)
    dists = torch.where(valid, d, neg)
    dists_ref = torch.where(valid, d / norm[:, None], neg)

    errs_k = dists.mean(dim=0)
    errs = torch.cat([errs_k, errs_k.mean()[None]])

    n_valid = valid.sum(dim=0)
    n_below = ((dists_ref != -1) & (dists_ref < pck_thr)).sum(dim=0)
    accs_k = torch.where(n_valid > 0, n_below / n_valid.clamp(min=1),
                         torch.full_like(errs_k, -1.0))
    acc_mask = accs_k >= 0
    acc_num = acc_mask.sum()
    acc_mean = torch.where(
        acc_num > 0,
        torch.where(acc_mask, accs_k, torch.zeros_like(accs_k)).sum()
        / acc_num.clamp(min=1),
        torch.zeros((), dtype=accs_k.dtype, device=accs_k.device))
    accs = torch.cat([accs_k, acc_mean[None]])
    return errs, accs


def acc_pck_pseudo(error, norm, pck_thr):
    """Reference acc_pck_pseudo (``ubpl_tpu/ops/pck.py:51-53``): 1 where
    error / norm < thr, else 0 (int32, batched)."""
    return (error / norm < pck_thr).to(torch.int32)
