"""Model/prediction similarity and coordinate-spread uncertainty (reference
utils/evaluation.py:12-58, dormant analysis utilities).

Port of ``ubpl_tpu/ops/uncertainty.py``.  Parameters are given as iterables
of tensors (``model.parameters()``, a state dict's values).  The reference's
cosine similarity concatenates the *second* model's parameters into both
vectors after the first layer (evaluation.py:19 uses p2 for v1); like the
JAX package, the port computes the intended 1 + cos(theta).
"""
import torch


def _flatten(params):
    return torch.cat([p.detach().reshape(-1) for p in params])


def model_similarity_cosine(params1, params2):
    """1 + cosine similarity between two models' flattened parameters."""
    v1, v2 = _flatten(params1), _flatten(params2)
    return 1.0 + torch.dot(v1, v2) / (torch.linalg.vector_norm(v1)
                                      * torch.linalg.vector_norm(v2))


def model_similarity_distance(params1, params2):
    """Sum of squared parameter distances (modelSimilarity_byDistance)."""
    return sum(((a.detach() - b.detach()) ** 2).sum()
               for a, b in zip(params1, params2))


def err_kps(preds, gts):
    """Per-keypoint coordinate error [..., K] (err_kps)."""
    return torch.linalg.vector_norm(preds[..., 0:2] - gts[..., 0:2], dim=-1)


def preds_similarity_distance(preds1, preds2):
    """Mean coordinate distance between two prediction sets [N, K, 2]."""
    return err_kps(preds1, preds2).mean()


def uncertainty_from_distance(preds_mul, preds_mean):
    """MC-style coordinate-spread uncertainty (uncertainty_fromDistance).

    preds_mul: [M, B, K, 2] per-member predictions; preds_mean: [B, K, 2].
    Returns (unc [B, K] normalised to max 1, weights exp(-unc)).
    """
    unc = err_kps(preds_mul, preds_mean[None]).mean(dim=0)
    unc = unc / unc.max().clamp(min=1e-12)
    return unc, torch.exp(-unc)


def err_kps_mul(preds_mul, gts):
    """[M, B, K] errors of stacked prediction sets (error_kps_mul)."""
    return err_kps(preds_mul, gts[None])
