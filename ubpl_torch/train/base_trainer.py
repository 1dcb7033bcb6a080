"""Shared trainer skeleton of every regime: data setup, models and EMA
teachers, batch gather, step loop, multi-head validation, the epoch loop
with checkpoints and JSON logs, resume.

Port of ``ubpl_tpu/train/base_trainer.py``: the synthetic dataset exactly
as ``_setup_synthetic_data`` (``:173-207``) makes it, ``fetch_batch`` in
resident mode (``:423-433``), ``run_train_steps`` (``:467-487``), branch
initialisation from ``cfg.seed + i`` (``:520-532``) with EMA teachers that
start as copies of their students (``:29-41``), ``_validate_heads``
(``:586-606``), ``run`` (``:763-814``) and ``resume`` (``:624-638``).

Not ported yet, and refused by the constructor when the config asks for
them: UBPL pseudo-label rounds (``pseudo_rounds``), the debug drawings
(``debug``), profiler traces (``profile_dir``), the MLD optimiser, streamed
datasets (``stream_data``) and ``torch_init`` warm starts.  Disk data
sources, the end-of-run report and the preemption guard are not ported
either.

Random numbers: numpy's ``np.random.default_rng(cfg.seed)`` drives data
and batch order (as in the JAX package); the augmentation draws come from a
``torch.Generator`` on the device seeded with ``cfg.seed``.
"""
import copy
import datetime

import numpy as np
import torch

from ..config import Config
from ..data.sampler import TwoStreamBatchSampler, valid_batches
from ..device import memory_format, resolve_device
from ..models import create_pose_model
from ..ops import augment as A
from ..utils import Logger, json_save
from . import losses as L
from .checkpointing import restore_checkpoint, save_checkpoint
from .common import (make_view, put_dataset, sample_weights,
                     update_pck_counters, validate_heads_batch)

# Config fields whose feature the port does not have yet: (field, test)
_NOT_PORTED = (
    ("pseudo_rounds", lambda v: v > 0),
    ("debug", bool),
    ("profile_dir", lambda v: v is not None),
    ("optimizer", lambda v: v == "mld"),
    ("stream_data", bool),
    ("torch_init", bool),
)


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
    #: names of the validated heads; "mean" is the ensemble-mean row
    valid_heads = ("model",)

    def __init__(self, cfg: Config, device=None, logger=None):
        if cfg.optimizer not in ("adamw", "mld"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                             "(adamw | mld)")
        for name, asked in _NOT_PORTED:
            if asked(getattr(cfg, name)):
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r} is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = logger or Logger(f"{cfg.data_source}_{self.regime}")
        self._setup_data()
        self._setup_model()
        n = len(self.valid_heads)
        self.best_acc = [-1.0] * n
        self.best_epoch = [0] * n
        self.epoch = 0
        self._step_num = 0

    # ------------------------------------------------------------------ data
    def _setup_data(self):
        cfg = self.cfg
        if not cfg.synthetic_data:
            raise NotImplementedError(
                "disk data sources are not ported yet; use synthetic_data")
        train, valid, n_lab = synthetic_arrays(cfg)
        means = [0.5, 0.5, 0.5]
        self.labeled_idxs = list(range(n_lab))
        self.unlabeled_idxs = list(range(n_lab, cfg.train_count))
        self.n_valid = cfg.valid_count
        self.train_data = put_dataset(**train, means=means, device=self.device)
        self.valid_data = put_dataset(**valid, means=means, device=self.device)
        self.means = self.train_data.means
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    def fetch_batch(self, data, idxs):
        """Gather one batch from the device-resident dataset."""
        i = torch.as_tensor(np.asarray(idxs), device=self.device)
        return data.images[i], data.kps[i], data.islabeled[i]

    def make_views(self, idxs, n_views):
        """Gather a training batch and build ``n_views`` independently
        augmented views of it (one ``draw_augment`` and one kernel launch
        each).  Returns (views, islabeled)."""
        imgs, kps, islabeled = self.fetch_batch(self.train_data, idxs)
        views = [make_view(imgs, kps, self.means, self.cfg,
                           A.draw_augment(len(idxs), self.generator,
                                          self.device))
                 for _ in range(n_views)]
        return views, islabeled

    def make_sampler(self):
        """The SSL regimes' batches: unlabeled first, then labeled."""
        cfg = self.cfg
        return TwoStreamBatchSampler(self.unlabeled_idxs, self.labeled_idxs,
                                     cfg.train_bs, cfg.train_bs_labeled,
                                     self.rng)

    sample_weights = staticmethod(sample_weights)

    # ----------------------------------------------------------------- model
    def _make_model(self, seed=None):
        """One network, initialised on the CPU from ``seed`` (cfg.seed by
        default), in the device's activation layout."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed if seed is None else seed)
            model = create_pose_model(cfg.model, cfg.kps_count,
                                      cfg.feature_mode)
        return model.to(self.device,
                        memory_format=memory_format(self.device))

    def _make_models(self, n):
        """``n`` student branches, branch i initialised from cfg.seed + i,
        each with an EMA teacher that starts as a copy of it: parameters
        (frozen: the EMA moves them) and BatchNorm running stats."""
        students = [self._make_model(self.cfg.seed + i) for i in range(n)]
        teachers = [copy.deepcopy(s).requires_grad_(False) for s in students]
        return students, teachers

    def _setup_branches(self, n):
        """The student/teacher regimes' ``_setup_model``: n branches, one
        AdamW over all students' parameters, and the networks named as the
        reference checkpoints name them: ``model[_ema]_state`` for one
        branch, ``model{i}[_ema]_state`` for several."""
        cfg = self.cfg
        self.students, self.teachers = self._make_models(n)
        self.networks = {}
        for i, (s, t) in enumerate(zip(self.students, self.teachers)):
            tag = "" if n == 1 else str(i + 1)
            self.networks[f"model{tag}_state"] = s
            self.networks[f"model{tag}_ema_state"] = t
        # wd passed explicitly: Config's is 0.0, torch's AdamW default 0.01
        self.optimizer = torch.optim.AdamW(
            [p for s in self.students for p in s.parameters()], lr=cfg.lr,
            weight_decay=cfg.wd)

    def _setup_model(self):
        """Build the networks and ``self.optimizer``, and name the networks
        in ``self.networks`` by their reference checkpoint keys."""
        raise NotImplementedError

    # ------------------------------------------------------------- step exec
    def train_step(self, idxs, *sched_args):
        raise NotImplementedError

    def run_train_steps(self, batch_iter, *sched_args):
        """Drive batches through ``train_step``.  Returns the per-step
        metric dicts as device tensors; reading them (the caller's
        reduction) is the only host sync."""
        metrics = []
        for idxs in batch_iter:
            self._step_num += 1
            metrics.append(self.train_step(idxs, *sched_args))
        return metrics

    # ------------------------------------------------------------ validation
    def _validate_heads(self, models, with_mean):
        """Validation pass of several heads over the resident validation
        set with the reference's counter weighting; one device-to-host
        read per batch.  Returns (preds, accs, errs), one entry per head."""
        cfg = self.cfg
        n_heads, k = len(self.valid_heads), cfg.kps_count
        assert n_heads == len(models) + bool(with_mean)
        acc_cs = [L.AvgCounters() for _ in range(n_heads)]
        err_cs = [L.AvgCounters() for _ in range(n_heads)]
        preds_arrays = [[] for _ in range(n_heads)]
        for idxs in valid_batches(self.n_valid, cfg.infer_bs):
            imgs, kps, _ = self.fetch_batch(self.valid_data, idxs)
            coords, errs, accs = validate_heads_batch(
                models, imgs, kps, self.means, cfg, with_mean)
            sizes = [coords.numel(), errs.numel(), accs.numel()]
            host = torch.cat([coords.flatten(), errs.flatten(),
                              accs.flatten()]).cpu().split(sizes)
            coords, errs, accs = (h.reshape(t.shape).numpy() for h, t in
                                  zip(host, (coords, errs, accs)))
            for m in range(n_heads):
                preds_arrays[m] += coords[m].tolist()
                update_pck_counters(acc_cs[m], err_cs[m], accs[m], errs[m],
                                    len(idxs), k)
        return (preds_arrays, [c.avg() for c in acc_cs],
                [c.avg() for c in err_cs])

    # ------------------------------------------------------------- main loop
    def epoch_schedules(self, epo) -> dict:
        """Per-epoch scalar hyper-parameters (the SSL regimes override)."""
        return {}

    def train_epoch(self, epo, schedules) -> dict:
        raise NotImplementedError

    def validate(self):
        raise NotImplementedError

    def format_epoch_log(self, losses, accs, errs) -> str:
        head = self.valid_heads[-1]
        return ("losses: " + ", ".join(f"{k}={v:.5f}"
                                       for k, v in losses.items())
                + f" | [{head}] acc: {accs[-1][-1]:.5f}, "
                  f"err: {errs[-1][-1]:.3f}")

    def checkpoint_state(self):
        """The regime's state in the reference checkpoint layout."""
        state = {k: m.state_dict() for k, m in self.networks.items()}
        state["optim_state"] = self.optimizer.state_dict()
        return state

    def resume(self, base_path, best=False):
        """Restore networks, optimiser and counters from ``base_path``;
        returns the epoch to continue from (0 without a checkpoint)."""
        state, meta = restore_checkpoint(base_path, best=best)
        if state is None:
            return 0
        for key, net in self.networks.items():
            net.load_state_dict(state[key])
        self.optimizer.load_state_dict(state["optim_state"])
        self.best_acc = [float(a) for a in
                         np.atleast_1d(meta.get("best_acc", self.best_acc))]
        self.best_epoch = [int(e) for e in np.atleast_1d(
            meta.get("best_epoch", self.best_epoch))]
        return int(meta["current_epoch"]) + 1

    def run(self, base_path=None, start_epoch=0, resume=False):
        """The epoch loop: schedules -> train -> validate -> best tracking
        per head -> checkpoint and JSON logs under ``base_path`` -> the
        epoch's log line.  Returns the per-epoch history."""
        cfg = self.cfg
        if resume and base_path:
            start_epoch = self.resume(base_path)
        history = []
        for epo in range(start_epoch, cfg.epochs):
            epo_tm = datetime.datetime.now()
            self.epoch = epo
            losses = self.train_epoch(epo, self.epoch_schedules(epo))
            preds, accs, errs = self.validate()
            is_best = []
            for m in range(len(self.valid_heads)):
                flag = accs[m][-1] > self.best_acc[m]
                is_best.append(flag)
                if flag:
                    self.best_epoch[m], self.best_acc[m] = epo, accs[m][-1]
            if base_path:
                save_checkpoint(base_path, epo, self.checkpoint_state(),
                                is_best[-1],
                                extra={"best_acc": self.best_acc,
                                       "best_epoch": self.best_epoch})
                if epo == start_epoch:
                    cfg.to_json(f"{base_path}/logs/args.json")
                json_save({**losses, "accs": accs, "errs": errs},
                          f"{base_path}/logs/logData/logData_{epo + 1}.json",
                          is_cover=True)
                json_save({"predsArraies": preds},
                          f"{base_path}/logs/pseudoData/"
                          f"pseudoData_{epo + 1}.json", is_cover=True)
            self.logger.print(
                "L1", "[{:3d}/{:3d}] | best acc: {:.5f} (epo: {:3d}) | {}"
                .format(epo + 1, cfg.epochs, self.best_acc[-1],
                        self.best_epoch[-1] + 1,
                        self.format_epoch_log(losses, accs, errs)),
                start=epo_tm)
            history.append({**losses, "accs": accs, "errs": errs})
        return history
