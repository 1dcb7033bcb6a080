"""Heatmap-regression loss and running means.

Port of ``ubpl_tpu/train/losses.py``: ``kps_labeled_count`` and
``joint_mse`` (``:29-52``, reference JointMSELoss) and the host-side
``AvgCounter``/``AvgCounters`` (``:335-374``).  Losses return
``(sum, count)``; the caller divides and applies the regime weight, as the
reference trainers do.

Layouts: preds [B, S, K, H, W] (S = hourglass stacks); gts [B, K, H, W];
kps gate [B, K]; sample weight [B] or [B, 1].
"""
import torch


def kps_labeled_count(gate):
    """Reference kps_getLabeledCount: #entries > 0."""
    return (gate > 0).sum().to(torch.float32)


def joint_mse(preds, gts, kps_gate=None, sample_weight=None,
              use_gate=False, use_sample_weight=False):
    """Per-stack heatmap MSE, optionally visibility/sample gated.

    Returns (loss_sum, count) with count = S * #(gate > 0).
    """
    if preds.dim() == 4:            # single-stack convenience
        preds = preds[:, None]
    B, S, K = preds.shape[:3]
    loss = ((preds - gts[:, None]) ** 2).mean(dim=(-2, -1))   # [B, S, K]
    gate = (torch.ones((B, K), dtype=preds.dtype, device=preds.device)
            if kps_gate is None else kps_gate)
    if use_gate:
        loss = loss * gate[:, None, :]
    if use_sample_weight and sample_weight is not None:
        loss = loss * sample_weight.reshape(B)[:, None, None]
    return loss.sum(), S * kps_labeled_count(gate)


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
