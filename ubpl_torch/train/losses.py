"""Heatmap-regression and SSL losses, and running means.

Port of ``ubpl_tpu/train/losses.py`` (reference utils/losses.py:8-354) in
NCHW layout: ``joint_mse``, ``joint_dist``, the feature-decorrelation terms
(``joint_feature_dist[_masked]``, ``features_cov_masked``), the
pseudo-label losses (``joint_pseudo3`` — the EPC of MT_UBPL — and the
dormant ``joint_pseudo``/``joint_pseudo2``), the masked consistencies
``joint_dist_mt``/``joint_dist_mt2``, the classification branch's
``class_loss``, ``class_dist``, ``class_sym_dist``, ``class_pseudo`` and
``class_feature_dist`` (``:285-328``), and the host-side
``AvgCounter``/``AvgCounters``.

Losses return ``(sum, count)`` as 0-dim tensors, with no host sync; the
caller divides and applies the regime weight, as the reference trainers do.
Sample selection is masked arithmetic, so shapes never depend on the data.

Layouts: preds [B, S, K, H, W] (S = hourglass stacks); gts [B, K, H, W];
kps gate [B, K]; sample weight [B] or [B, 1]; features [B, N, C, hf, wf];
teacher stacks [M, B, S, K, H, W]; class logits [B, C], teacher logits
[M, B, C], class features [B, C, hf, wf].
"""
from typing import NamedTuple

import torch


def kps_labeled_count(gate):
    """Reference kps_getLabeledCount: #entries > 0."""
    return (gate > 0).sum().to(torch.float32)


def _gated(loss, kps_gate, sample_weight, use_gate, use_sample_weight):
    """Apply the visibility gate [B, K] and the sample weight [B] to a
    per-joint loss [B, S, K]; returns (loss, gate)."""
    B, _, K = loss.shape
    gate = (torch.ones((B, K), dtype=loss.dtype, device=loss.device)
            if kps_gate is None else kps_gate)
    if use_gate:
        loss = loss * gate[:, None, :]
    if use_sample_weight and sample_weight is not None:
        loss = loss * sample_weight.reshape(B)[:, None, None]
    return loss, gate


def _stack_mse(a, b):
    """Mean squared difference over each map: [..., H, W] -> [...]."""
    return ((a - b) ** 2).mean(dim=(-2, -1))


def joint_mse(preds, gts, kps_gate=None, sample_weight=None,
              use_gate=False, use_sample_weight=False):
    """Per-stack heatmap MSE, optionally visibility/sample gated.

    Returns (loss_sum, count) with count = S * #(gate > 0).
    """
    if preds.dim() == 4:            # single-stack convenience
        preds = preds[:, None]
    loss, gate = _gated(_stack_mse(preds, gts[:, None]), kps_gate,
                        sample_weight, use_gate, use_sample_weight)
    return loss.sum(), preds.shape[1] * kps_labeled_count(gate)


def joint_dist(preds1, preds2, kps_gate=None, sample_weight=None,
               use_gate=False, use_sample_weight=False):
    """Reference JointDistLoss: MSE between two prediction stacks
    ([B, K, H, W] or [B, S, K, H, W])."""
    if preds1.dim() == 4:
        preds1, preds2 = preds1[:, None], preds2[:, None]
    loss, gate = _gated(_stack_mse(preds1, preds2), kps_gate, sample_weight,
                        use_gate, use_sample_weight)
    return loss.sum(), preds1.shape[1] * kps_labeled_count(gate)


def joint_feature_dist(f1, f2):
    """Reference JointFeatureDistLoss: per-channel MSE between feature
    stacks [B, N, C, hf, wf].  Returns (sum, B * N)."""
    return _stack_mse(f1, f2).sum(), f1.shape[0] * f1.shape[1]


def joint_feature_dist_masked(f1, f2, sample_mask):
    """JointFeatureDistLoss over the samples with mask > 0 (the reference
    selects them in a Python loop, projects/MT_UBPL.py:306-320).
    Returns (sum, count = n_sel * N)."""
    loss = _stack_mse(f1, f2)                              # [B, N, C]
    m = (sample_mask > 0).to(loss.dtype)
    return (loss * m[:, None, None]).sum(), m.sum() * f1.shape[1]


def features_cov_masked(f1, f2, sample_mask):
    """Reference features_cov (utils/process.py:18-31) over the samples
    with mask > 0: returns (mean |cov(f1, f2)| per channel over the selected
    set, count = n_sel * N * C).  The covariance is the unbiased one
    (divisor hw - 1)."""
    N, C = f1.shape[1], f1.shape[2]
    v1, v2 = f1.flatten(-2), f2.flatten(-2)                # [B, N, C, hw]
    m1 = v1 - v1.mean(dim=-1, keepdim=True)
    m2 = v2 - v2.mean(dim=-1, keepdim=True)
    cov01 = (m1 * m2).sum(dim=-1) / (v1.shape[-1] - 1)     # [B, N, C]
    m = (sample_mask > 0).to(cov01.dtype)
    n_sel = m.sum()
    mean_val = (cov01.abs() * m[:, None, None]).sum() / (
        n_sel.clamp(min=1) * N * C)
    return mean_val, n_sel * N * C


class PseudoStats(NamedTuple):
    num_pseudo: torch.Tensor        # #loss entries > 0 (reference n)
    num_selected: torch.Tensor      # #mask entries > 0
    joint_score_mean: torch.Tensor  # [K] mean confidence, weighted samples


def _max_score(v):
    """Raw confidence: the maximum of each map, [..., K, H, W] -> [..., K]."""
    return v.amax(dim=(-2, -1))


def _softmax_k_score(v):
    """Reference confidence of the dormant pseudo losses: softmax over the
    JOINT axis at every pixel, then the maximum over the map."""
    return torch.softmax(v, dim=-3).amax(dim=(-2, -1))


def _rate_threshold(scores, sel_rate):
    """Reference quantile threshold: the ascending-sorted flat scores at
    index int(len * (1 - sel_rate))."""
    flat = scores.reshape(-1).sort().values
    idx = int(flat.shape[0] * (1.0 - sel_rate))
    return flat[min(idx, flat.shape[0] - 1)]


def _pseudo_target_loss(preds, teacher_outs, sample_weight):
    """Shared head of the pseudo-label losses: the target is the mean of
    ALL teachers' LAST stacks; returns (target [B, K, H, W], weighted
    per-joint loss [B, S, K], sample weight [B])."""
    sw = sample_weight.reshape(preds.shape[0])
    target = teacher_outs[:, :, -1].mean(dim=0)
    loss = _stack_mse(preds, target[:, None]) * sw[:, None, None]
    return target, loss, sw


def _pseudo_stats(loss, mask, v1_score, v2_score, sw):
    """PseudoStats of a masked pseudo loss; v1_score [B, S, K] (student),
    v2_score [B, K] (target)."""
    wpos = (sw > 0).to(loss.dtype)
    denom = wpos.sum().clamp(min=1.0)
    v1_mean = (v1_score * wpos[:, None, None]).sum(dim=0) / denom   # [S, K]
    v2_mean = (v2_score * wpos[:, None]).sum(dim=0) / denom         # [K]
    jsm = ((v1_mean + v2_mean[None, :]) / 2.0).mean(dim=0)          # [K]
    return PseudoStats((loss > 0).sum(), (mask > 0).sum(), jsm)


def joint_pseudo3(preds, teacher_outs, sample_weight, score_thr=0.95):
    """Reference JointPseudoLoss3: the ensemble pseudo-label constraint
    (EPC).

    preds: [B, S, K, H, W] student stacks; teacher_outs:
    [M, B, S, K, H, W]; sample_weight: [B] "nega" weights (labeled 0,
    unlabeled pseudoWeight).  Per-joint confidence mask:
    max(student stack) >= thr AND max(target) >= thr.
    Returns (loss_sum, PseudoStats); num_pseudo counts loss > 0 after the
    sample weight.
    """
    target, loss, sw = _pseudo_target_loss(preds, teacher_outs, sample_weight)
    v1_score, v2_score = _max_score(preds), _max_score(target)
    mask = ((v1_score >= score_thr)
            & (v2_score[:, None] >= score_thr)).to(loss.dtype)
    return (loss * mask).sum(), _pseudo_stats(loss, mask, v1_score, v2_score,
                                              sw)


def joint_pseudo(preds, teacher_outs, sample_weight, score_thr=0.8):
    """Reference JointPseudoLoss (dormant): as joint_pseudo3, but the
    confidence is the softmax-over-joints score."""
    target, loss, sw = _pseudo_target_loss(preds, teacher_outs, sample_weight)
    v1_score, v2_score = _softmax_k_score(preds), _softmax_k_score(target)
    mask = ((v1_score >= score_thr)
            & (v2_score[:, None] >= score_thr)).to(loss.dtype)
    return (loss * mask).sum(), _pseudo_stats(loss, mask, v1_score, v2_score,
                                              sw)


def joint_pseudo2(preds, teacher_outs, sample_weight, sel_rate=0.5):
    """Reference JointPseudoLoss2 (dormant): per-stack top-sel_rate quantile
    thresholds on the softmax-over-joints scores.
    Returns (sum, PseudoStats, thr1 [S], thr2 [S])."""
    S = preds.shape[1]
    target, loss, sw = _pseudo_target_loss(preds, teacher_outs, sample_weight)
    v1_score, v2_score = _softmax_k_score(preds), _softmax_k_score(target)
    thr1 = torch.stack([_rate_threshold(v1_score[:, s], sel_rate)
                        for s in range(S)])
    thr2 = _rate_threshold(v2_score, sel_rate)
    mask = ((v1_score >= thr1[None, :, None])
            & (v2_score[:, None] >= thr2)).to(loss.dtype)
    return ((loss * mask).sum(),
            _pseudo_stats(loss, mask, v1_score, v2_score, sw),
            thr1, thr2.expand(S))


def joint_dist_mt(preds1, preds2, kps_gate=None, sample_weight=None,
                  use_gate=False, use_sample_weight=False, sel_rate=0.5):
    """Reference JointDistLoss_mt (dormant): consistency masked by the
    top-sel_rate quantile of the teacher's softmax-over-joints score."""
    if preds1.dim() == 4:
        preds1, preds2 = preds1[:, None], preds2[:, None]
    S = preds1.shape[1]
    loss, gate = _gated(_stack_mse(preds1, preds2), kps_gate, sample_weight,
                        use_gate, use_sample_weight)
    v2_score = _softmax_k_score(preds2)                    # [B, S, K]
    mask = torch.stack(
        [(v2_score[:, s] >= _rate_threshold(v2_score[:, s], sel_rate))
         for s in range(S)], dim=1).to(loss.dtype)
    return (loss * mask).sum(), S * kps_labeled_count(gate)


def joint_dist_mt2(preds1, preds2, kps_gate=None, sample_weight=None,
                   use_gate=False, use_sample_weight=False, score_thr=0.95):
    """Reference JointDistLoss_mt2: consistency masked by the raw maximum
    of the teacher's maps.  Returns (loss_sum, count, PseudoStats)."""
    if preds1.dim() == 4:
        preds1, preds2 = preds1[:, None], preds2[:, None]
    B, S = preds1.shape[:2]
    loss, gate = _gated(_stack_mse(preds1, preds2), kps_gate, sample_weight,
                        use_gate, use_sample_weight)
    v2_score = _max_score(preds2)                          # [B, S, K]
    mask = (v2_score >= score_thr).to(loss.dtype)
    if use_sample_weight and sample_weight is not None:
        sw = sample_weight.reshape(B)
    else:
        sw = torch.ones((B,), dtype=loss.dtype, device=loss.device)
    wpos = (sw > 0).to(loss.dtype)
    jsm = ((v2_score * wpos[:, None, None]).sum(dim=0)
           / wpos.sum().clamp(min=1.0)).mean(dim=0)        # [K]
    return ((loss * mask).sum(), S * kps_labeled_count(gate),
            PseudoStats((loss > 0).sum(), (mask > 0).sum(), jsm))


# ---------------------------------------------------------------------------
# Classification-branch losses (reference utils/losses.py:289-354)
# ---------------------------------------------------------------------------

def class_loss(logits, labels, sample_weight=None, use_sample_weight=False):
    """Reference ClassLoss: cross-entropy with ignore_index=-1, optional
    sample weights; (sum, number of labelled samples)."""
    valid = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    nll = nll * valid.to(nll.dtype)
    if use_sample_weight and sample_weight is not None:
        nll = nll * sample_weight.reshape(-1)
    return nll.sum(), valid.sum()


def class_dist(logits1, logits2):
    """Reference ClassDistLoss: squared distance of the softmaxes over the
    number of classes; (sum, batch size)."""
    bs, c = logits1.shape
    d = torch.softmax(logits1, -1) - torch.softmax(logits2, -1)
    return (d ** 2).sum() / c, bs


def class_sym_dist(logits1, logits2):
    """Reference ClassSymDistLoss: raw squared distance over the number of
    classes; (sum, batch size)."""
    bs, c = logits1.shape
    return ((logits1 - logits2) ** 2).sum() / c, bs


def class_pseudo(logits, teacher_logits, sample_weight):
    """Reference ClassPseudoLoss: per-sample MSE to the mean of the M
    teachers' softmaxes (``teacher_logits`` [M, B, C]), weighted;
    (sum, number of weighted samples)."""
    t = torch.softmax(teacher_logits, -1).mean(dim=0)
    sw = sample_weight.reshape(-1)
    loss = ((torch.softmax(logits, -1) - t) ** 2).mean(dim=-1) * sw
    return loss.sum(), (sw > 0).sum()


def class_feature_dist(f1, f2):
    """Reference ClassFeatureDistLoss: the sum over samples of the inverse
    mean squared distance of the two feature maps; (sum, batch size)."""
    bs, c = f1.shape[:2]
    d = (f1.reshape(bs, c, -1) - f2.reshape(bs, c, -1)) ** 2
    return (1.0 / d.mean(dim=-1).mean(dim=-1)).sum(), bs


class AvgCounter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        n = int(n)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = 0.0 if self.count == 0 else self.sum / self.count


class AvgCounters:
    def __init__(self, num=1):
        self.counters = [AvgCounter() for _ in range(num)]

    def reset(self):
        for c in self.counters:
            c.reset()

    def update(self, idx, val, n=1):
        while len(self.counters) < idx + 1:
            self.counters.append(AvgCounter())
        self.counters[idx].update(val, n)

    def avg(self):
        return [c.avg for c in self.counters]

    def sum(self):
        return [c.sum for c in self.counters]
