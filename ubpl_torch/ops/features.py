"""Feature statistics for the UBPL feature-decorrelation loss (FDC), and the
recency-weighted mixture of per-epoch feature snapshots.

Port of ``ubpl_tpu/ops/features.py`` (reference utils/process.py:18-44 and
utils/module.py FeaturePool).  The JAX package keeps features channel-last
(``[B, N, Hf, Wf, C]``); the port's layout is the model's,
``[B, N, C, Hf, Wf]``, so ``features_cov`` here is the JAX package's
``features_cov_nchw``.  The training step's FDC uses the masked form in
``train/losses.py``; these are the dormant analysis utilities.
"""
import torch


def features_cov(f1, f2):
    """Mean |off-diagonal covariance| between two models' features.

    f1, f2: [B, N, C, Hf, Wf].  Per (b, n, c) the two feature maps are
    paired over the Hf*Wf positions; the |cov[0, 1]| entry is averaged over
    c, n and b, as the reference's torch_cov path.  Returns (scalar,
    count = B*N*C).
    """
    B, N, C = f1.shape[:3]
    v1 = f1.reshape(B, N, C, -1)
    v2 = f2.reshape(B, N, C, -1)
    hw = v1.shape[-1]
    m1 = v1 - v1.mean(dim=-1, keepdim=True)
    m2 = v2 - v2.mean(dim=-1, keepdim=True)
    cov01 = (m1 * m2).sum(dim=-1) / (hw - 1)
    return cov01.abs().mean(), B * N * C


def feature_mixture_weight(epo, l=10):
    """Reference _feature_mixture_weight: smooth recency weight."""
    t = torch.as_tensor(epo, dtype=torch.float32) - l
    sign = torch.sign(t)
    return (1 - sign + sign * torch.exp(-sign * t)) / 2


def feature_mixture_across_epochs(features, max_count):
    """Recency-weighted mixture of per-epoch feature snapshots.

    features: [T, ...] stacked snapshots, newest last (reference
    feature_mixture_across_epoch); at most ``max_count`` are mixed.
    """
    T = features.shape[0]
    n = min(T, max_count)
    idxs = torch.arange(n, device=features.device)
    w = feature_mixture_weight(idxs.float()).to(features.device,
                                                features.dtype)
    sel = features[T - 1 - idxs]
    return torch.tensordot(w, sel, dims=1) / w.sum()
