"""Supervised baseline trainer (reference projects/supervised.py).

Port of ``ubpl_tpu/train/supervised.py``: labeled-only heatmap regression
with AdamW(lr 2.5e-4, wd 0), JointMSELoss x poseWeight and PCK
validation.  One step gathers its batch from the device-resident dataset,
draws its augmentation, builds the view (targets from the Triton kernel:
one launch per step), runs forward, loss, backward and AdamW — all on the
device, with no host sync.
"""
import torch

from ..data.sampler import supervised_epoch_batches
from ..ops import augment as A
from . import losses as L
from .base_trainer import BaseTrainer
from .common import forward_heatmaps, make_view


def supervised_step(model, optimizer, view, cfg):
    """One optimisation step on a built view; returns device-tensor
    metrics {"pec_loss", "pec_count"}."""
    preds, _ = forward_heatmaps(model, view.images, True, cfg.compute_dtype,
                                remat=cfg.remat)
    s, n = L.joint_mse(preds, view.heatmaps)
    loss = cfg.pose_weight * torch.where(n > 0, s / n.clamp(min=1), s)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return {"pec_loss": loss.detach(), "pec_count": n}


class SupervisedTrainer(BaseTrainer):
    regime = "Supervised"

    def _setup_model(self):
        cfg = self.cfg
        self.model = self._make_model()
        # wd passed explicitly: Config's is 0.0, torch's AdamW default 0.01
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=cfg.lr,
                                           weight_decay=cfg.wd)

    def train_step(self, idxs):
        imgs, kps, _ = self.fetch_batch(self.train_data, idxs)
        draws = A.draw_augment(len(idxs), self.generator, self.device)
        view = make_view(imgs, kps, self.means, self.cfg, draws)
        return supervised_step(self.model, self.optimizer, view, self.cfg)

    def train_epoch(self):
        counter = L.AvgCounter()
        metrics = self.run_train_steps(supervised_epoch_batches(
            self.labeled_idxs, self.cfg.train_bs, self.rng))
        for m in metrics:
            counter.update(float(m["pec_loss"]), int(m["pec_count"]))
        return {"pec_loss": counter.avg}

    def validate(self):
        preds, accs, errs = self.validate_model(self.model)
        return [preds], [accs], [errs]
