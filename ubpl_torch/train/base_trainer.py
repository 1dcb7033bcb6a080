"""Trainer skeleton: data setup, batch gather, plain step loop, validation.

Port of the parts of ``ubpl_tpu/train/base_trainer.py`` the supervised
regime needs: the synthetic dataset exactly as ``_setup_synthetic_data``
(``:173-207``) makes it, ``fetch_batch`` in resident mode (``:423-433``)
and a plain-step ``run_train_steps`` (``:467-487``).  Disk data sources,
checkpoints, resume and the CLI are not ported yet.

Random numbers: numpy's ``np.random.default_rng(cfg.seed)`` drives data
and batch order (as in the JAX package); the augmentation draws come from a
``torch.Generator`` on the device seeded with ``cfg.seed``.
"""
import numpy as np
import torch

from ..config import Config
from ..data.sampler import valid_batches
from ..device import memory_format, resolve_device
from ..models import create_pose_model
from . import losses as L
from .common import put_dataset, update_pck_counters, validate_batch


def synthetic_arrays(cfg: Config):
    """Random in-memory dataset, as ``ubpl_tpu``'s ``_setup_synthetic_data``
    draws it from ``cfg.seed``: (train, valid, n_labeled), each split a
    dict of numpy arrays.  Fills cfg.kps_count and cfg.pck_ref."""
    cfg.kps_count = cfg.synthetic_kps
    cfg.pck_ref = cfg.pck_ref or (1, 2)
    nprng = np.random.default_rng(cfg.seed)
    K, R = cfg.kps_count, cfg.inp_res

    def make(n):
        imgs = nprng.integers(0, 256, (n, R, R, 3), dtype=np.uint8)
        kps = np.zeros((n, K, 3), np.float32)
        kps[..., 0:2] = nprng.uniform(16, R - 16, (n, K, 2))
        kps[..., 2] = 1.0
        return {"images": imgs, "kps": kps, "kps_test": kps.copy(),
                "islabeled": np.ones((n,), np.int32)}

    train = make(cfg.train_count)
    n_lab = max(1, int(cfg.train_count * cfg.label_ratio))
    train["islabeled"][n_lab:] = 0
    train["kps"][n_lab:] = 0
    return train, make(cfg.valid_count), n_lab


class BaseTrainer:
    regime = "Base"

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._setup_data()
        self._setup_model()
        self._step_num = 0

    def _setup_data(self):
        cfg = self.cfg
        if not cfg.synthetic_data:
            raise NotImplementedError(
                "disk data sources are not ported yet; use synthetic_data")
        train, valid, n_lab = synthetic_arrays(cfg)
        means = [0.5, 0.5, 0.5]
        self.labeled_idxs = list(range(n_lab))
        self.n_valid = cfg.valid_count
        self.train_data = put_dataset(**train, means=means, device=self.device)
        self.valid_data = put_dataset(**valid, means=means, device=self.device)
        self.means = self.train_data.means
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    def _make_model(self):
        """The regime's network, initialised on the CPU from cfg.seed, in
        the device's activation layout."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = create_pose_model(cfg.model, cfg.kps_count,
                                      cfg.feature_mode)
        return model.to(self.device,
                        memory_format=memory_format(self.device))

    def _setup_model(self):
        raise NotImplementedError

    def fetch_batch(self, data, idxs):
        """Gather one batch from the device-resident dataset."""
        i = torch.as_tensor(np.asarray(idxs), device=self.device)
        return data.images[i], data.kps[i], data.islabeled[i]

    def train_step(self, idxs):
        raise NotImplementedError

    def run_train_steps(self, batch_iter):
        """Drive batches through ``train_step``.  Returns the per-step
        metric dicts as device tensors; reading them (the caller's
        reduction) is the only host sync."""
        metrics = []
        for idxs in batch_iter:
            self._step_num += 1
            metrics.append(self.train_step(idxs))
        return metrics

    def validate_model(self, model):
        """Validation pass over the resident validation set with the
        reference's counter weighting.  Returns (preds, accs, errs)."""
        cfg = self.cfg
        acc_c, err_c = L.AvgCounters(), L.AvgCounters()
        preds_array = []
        for idxs in valid_batches(self.n_valid, cfg.infer_bs):
            imgs, kps, _ = self.fetch_batch(self.valid_data, idxs)
            coords, _, errs, accs = validate_batch(model, imgs, kps,
                                                   self.means, cfg)
            preds_array += coords.cpu().tolist()
            update_pck_counters(acc_c, err_c, accs.cpu().numpy(),
                                errs.cpu().numpy(), len(idxs), cfg.kps_count)
        return preds_array, acc_c.avg(), err_c.avg()
