"""Supervised baseline trainer (reference projects/supervised.py).

Port of ``ubpl_tpu/train/supervised.py``: labeled-only heatmap regression
with AdamW(lr 2.5e-4, wd 0), JointMSELoss x poseWeight and PCK
validation.  One step gathers its batch from the device-resident dataset,
draws its augmentation, builds the view (targets from the Triton kernel:
one launch per step), runs forward, loss, backward and AdamW — all on the
device, with no host sync.  Data parallel (``group``), the count is
summed over the ranks before the loss is formed, the gradients after the
backward, and the returned metrics are global.
"""
import torch

from ..data.sampler import supervised_epoch_batches
from ..parallel import collectives as PC
from . import losses as L
from .base_trainer import BaseTrainer, run_regime
from .common import forward_heatmaps


def supervised_step(model, optimizer, view, cfg, group=None):
    """One optimisation step on a built view; returns device-tensor
    metrics {"pec_loss", "pec_count"}."""
    preds, _ = forward_heatmaps(model, view.images, True, cfg.compute_dtype,
                                remat=cfg.remat)
    s, n = L.joint_mse(preds, view.heatmaps)
    (n,) = PC.all_reduce_packed([n], group)
    loss = cfg.pose_weight * torch.where(n > 0, s / n.clamp(min=1), s)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    PC.all_reduce_grads([p.grad for p in model.parameters()], group)
    optimizer.step()
    (total,) = PC.all_reduce_packed([loss.detach()], group)
    return {"pec_loss": total, "pec_count": n}


class SupervisedTrainer(BaseTrainer):
    regime = "Supervised"
    valid_heads = ("model",)

    def _setup_model(self):
        cfg = self.cfg
        self.model = self._make_model()
        self.networks = {"model_state": self.model}
        # wd passed explicitly: Config's is 0.0, torch's AdamW default 0.01
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=cfg.lr,
                                           weight_decay=cfg.wd)

    def train_step(self, idxs):
        (view,), _ = self.make_views(idxs, 1)
        return supervised_step(self.model, self.optimizer, view, self.cfg,
                               self.group)

    def train_epoch(self, epo, schedules=None):
        counter = L.AvgCounter()
        metrics = self.run_train_steps(supervised_epoch_batches(
            self.labeled_idxs, self.cfg.train_bs, self.rng))
        for m in metrics:
            counter.update(float(m["pec_loss"]), int(m["pec_count"]))
        return {"pec_loss": counter.avg}

    def validate(self):
        return self._validate_heads([self.model], False)


def exec_regime(exp_mark="Supervised", params=None, device=None):
    """Entry point of the ``supervised`` regime (``run_regime``)."""
    return run_regime(SupervisedTrainer, exp_mark, params, device)
