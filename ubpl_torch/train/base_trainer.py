"""Shared trainer skeleton of every regime: data setup, models and EMA
teachers, batch gather, step loop, multi-head validation, the epoch loop
with checkpoints, JSON logs, debug drawings, profiler trace, preemption
guard and end-of-run report, resume, and the regimes' shared entry point.

Port of ``ubpl_tpu/train/base_trainer.py``: the dataset from a datasource
on disk (``_setup_data``, ``:99-131``) or synthetic exactly as
``_setup_synthetic_data`` (``:173-207``) makes it, the occluder bank
(``:160-171``), ``fetch_batch`` in resident mode (``:423-433``),
``run_train_steps`` (``:467-487``), branch initialisation from
``cfg.seed + i`` (``:520-532``) with EMA teachers that start as copies of
their students (``:29-41``), ``_validate_heads`` (``:586-606``),
``resume`` (``:624-638``), ``run`` with ``maybe_debug_draw``, the
``profile_dir`` trace, the preemption guard and ``_write_report``
(``:743-837``), the ``torch_init`` warm start
(``ubpl_tpu/models/torch_import.py:196-240``), and ``make_experiment`` /
``run_regime`` (``:851-873``, without a device mesh: one card).

Not ported yet, and refused by the constructor when the config asks for
them: UBPL pseudo-label rounds (``pseudo_rounds``), the MLD optimiser and
streamed datasets (``stream_data``).

Random numbers: numpy's ``np.random.default_rng(cfg.seed)`` drives data
and batch order (as in the JAX package); the augmentation draws come from a
``torch.Generator`` on the device seeded with ``cfg.seed``.
"""
import copy
import datetime
import os
import re

import numpy as np
import torch

from ..config import Config
from ..data.arrays import materialize
from ..data.base import default_data_root
from ..data.occluders import build_occluder_bank
from ..data.sampler import TwoStreamBatchSampler, valid_batches
from ..data.sources import get_datasource
from ..device import memory_format, resolve_device
from ..models import create_pose_model
from ..models.weights import load_reference_checkpoint, load_state
from ..ops import augment as A
from ..utils import Logger, json_save
from ..utils.preemption import PreemptionGuard
from ..utils.profiling import trace
from ..utils.report import RunReport
from . import losses as L
from .checkpointing import restore_checkpoint, save_checkpoint
from .common import (make_view, put_dataset, sample_weights,
                     update_pck_counters, validate_heads_batch)

# Config fields whose feature the port does not have yet: (field, test)
_NOT_PORTED = (
    ("pseudo_rounds", lambda v: v > 0),
    ("optimizer", lambda v: v == "mld"),
    ("stream_data", bool),
)
_NETWORK_KEY = re.compile(r"model(\d*)(_ema)?_state")


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
        self._setup_occluders()
        self._setup_model()
        if cfg.torch_init:
            meta = self.warm_start(cfg.torch_init)
            self.logger.print(
                "L1", "=> warm start from reference checkpoint {} "
                "(epoch {}, {})".format(cfg.torch_init,
                                        meta["current_epoch"],
                                        meta["source_key"]))
        n = len(self.valid_heads)
        self.best_acc = [-1.0] * n
        self.best_epoch = [0] * n
        self.epoch = 0
        self._step_num = 0

    # ------------------------------------------------------------------ data
    def _setup_data(self):
        """The dataset in device memory: from ``cfg.data_source`` on disk
        (split, materialised once, the split's means), or synthetic."""
        cfg = self.cfg
        if cfg.synthetic_data:
            train, valid, n_lab = synthetic_arrays(cfg)
            labeled = range(n_lab)
            unlabeled = range(n_lab, cfg.train_count)
            means = [0.5, 0.5, 0.5]
        else:
            ds = get_datasource(cfg.data_source, data_root=cfg.data_root,
                                cache_dir=cfg.cache_dir, seed=cfg.seed)
            semi = ds.get_semi_data(cfg.train_count, cfg.valid_count,
                                    cfg.label_ratio)
            cfg.kps_count = ds.kps_count
            cfg.inp_res, cfg.out_res = ds.inp_res, ds.out_res
            if cfg.force_inp_res:
                cfg.inp_res = cfg.force_inp_res
            if cfg.force_out_res:
                cfg.out_res = cfg.force_out_res
            cfg.pck_ref, cfg.pck_thr = tuple(ds.pck_ref), ds.pck_thr

            def arrays(records):
                a = materialize(records, cfg.inp_res, cfg.io_workers,
                                ds.image_cache)
                return {"images": a.images, "kps": a.kps,
                        "kps_test": a.kps_test, "islabeled": a.islabeled}

            train, valid = arrays(semi.semi_train), arrays(semi.valid)
            labeled, unlabeled = semi.labeled_idxs, semi.unlabeled_idxs
            means = semi.means
        self.labeled_idxs = list(labeled)
        self.unlabeled_idxs = list(unlabeled)
        self.n_valid = len(valid["images"])
        self.train_data = put_dataset(**train, means=means, device=self.device)
        self.valid_data = put_dataset(**valid, means=means, device=self.device)
        self.means = self.train_data.means
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    def _setup_occluders(self):
        """Occluder bank for ``use_occlusion`` (VOC2012 under
        ``{data_root}/pascal/VOCdevkit/VOC2012``, else synthetic blobs), on
        the device; None when occlusion is off.  As in the JAX package,
        ``use_occlusion_ema`` alone builds no bank."""
        self.occluder_bank = None
        cfg = self.cfg
        if not cfg.use_occlusion:
            return
        voc = os.path.join(cfg.data_root or default_data_root(), "pascal",
                           "VOCdevkit", "VOC2012")
        rgb, alpha = build_occluder_bank(voc_root=voc, seed=cfg.seed)
        self.occluder_bank = (torch.as_tensor(rgb, device=self.device),
                              torch.as_tensor(alpha, device=self.device))

    def fetch_batch(self, data, idxs):
        """Gather one batch from the device-resident dataset."""
        i = torch.as_tensor(np.asarray(idxs), device=self.device)
        return data.images[i], data.kps[i], data.islabeled[i]

    def augmented_view(self, imgs, kps, *, scale_range=None, rot_range=None,
                       occlude=None):
        """One augmented view of a gathered batch: its augmentation draws
        (then its occlusion draws, where ``occlude`` — by default
        ``cfg.use_occlusion`` — is on and there is a bank) from the
        trainer's generator, and one heatmap-kernel launch."""
        cfg = self.cfg
        B = imgs.shape[0]
        draws = A.draw_augment(B, self.generator, self.device)
        occlude = cfg.use_occlusion if occlude is None else occlude
        occlusion = None
        if occlude and self.occluder_bank is not None:
            rgb, alpha = self.occluder_bank
            occlusion = (rgb, alpha, A.draw_occlusion(
                B, cfg.num_occluder, rgb.shape[0], self.generator,
                self.device))
        return make_view(imgs, kps, self.means, cfg, draws,
                         scale_range=scale_range, rot_range=rot_range,
                         occlusion=occlusion)

    def make_views(self, idxs, n_views):
        """Gather a training batch and build ``n_views`` independently
        augmented views of it.  Returns (views, islabeled)."""
        imgs, kps, islabeled = self.fetch_batch(self.train_data, idxs)
        views = [self.augmented_view(imgs, kps) for _ in range(n_views)]
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

    def warm_start(self, path):
        """``cfg.torch_init``: replace every network's weights with a
        reference ``.pth.tar``'s.  ``model{i}[_ema]_state`` takes branch i
        (1 for ``model[_ema]_state``), the student or the EMA head (which
        falls back to the student in a supervised checkpoint).  The
        optimiser state stays fresh, as in the JAX package.  Returns the
        checkpoint's meta of branch 1's student."""
        meta = None
        for key, net in self.networks.items():
            tag, ema = _NETWORK_KEY.fullmatch(key).groups()
            sd, m = load_reference_checkpoint(
                path, branch=int(tag or 1), head="ema" if ema else "student")
            load_state(net, sd)
            if not ema and tag in ("", "1"):
                meta = m
        self.optimizer.state.clear()
        return meta

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

    def maybe_debug_draw(self, base_path, epo):
        """``cfg.debug``: dump the augmentation of the first labeled batch
        (up to 4 samples; draws from ``cfg.seed + epo``, apart from the
        training stream) under ``{base_path}/draw`` (reference --debug)."""
        if not (self.cfg.debug and base_path):
            return
        from ..utils.draw import DebugDrawer
        cfg = self.cfg
        idxs = np.asarray(self.labeled_idxs[:min(4, len(self.labeled_idxs))])
        imgs, kps, _ = self.fetch_batch(self.train_data, idxs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed + epo)
        view = make_view(imgs, kps, torch.zeros(3, device=self.device), cfg,
                         A.draw_augment(len(idxs), gen, self.device))
        DebugDrawer(base_path).dump_view([str(i) for i in idxs], view,
                                         prefix=f"epo{epo + 1}_")

    def run(self, base_path=None, start_epoch=0, resume=False):
        """The epoch loop: debug drawings -> schedules -> train (under a
        profiler trace in the first epoch when ``cfg.profile_dir``) ->
        validate -> best tracking per head -> checkpoint and JSON logs
        under ``base_path`` -> the epoch's log line -> stop here if a
        preemption was requested; then the report.  Returns the per-epoch
        history."""
        cfg = self.cfg
        if resume and base_path:
            start_epoch = self.resume(base_path)
        history = []
        for epo in range(start_epoch, cfg.epochs):
            epo_tm = datetime.datetime.now()
            self.epoch = epo
            self.maybe_debug_draw(base_path, epo)
            schedules = self.epoch_schedules(epo)
            with trace(cfg.profile_dir, enabled=cfg.profile_dir is not None
                       and epo == start_epoch):
                losses = self.train_epoch(epo, schedules)
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
            if base_path and self._preemption_requested():
                self.logger.print("L1", "preemption requested — checkpointed "
                                        f"at epoch {epo + 1}; resume with "
                                        "run(resume=True)")
                break
        if base_path and history:
            self._write_report(base_path, history)
        return history

    @staticmethod
    def _preemption_requested():
        """Honoured only where a PreemptionGuard was installed (``exec``)."""
        guard = PreemptionGuard._installed
        return bool(guard and guard.requested)

    @staticmethod
    def _write_report(base_path, history):
        """End-of-run metric table (reference xlsx dumps -> CSV, markdown
        and xlsx under ``logs/report.*``)."""
        loss_keys = [k for k in history[0] if k not in ("accs", "errs")]
        rep = RunReport(["epoch", *loss_keys, "acc", "err"])
        for epo, h in enumerate(history):
            row = {"epoch": epo + 1, "acc": h["accs"][-1][-1],
                   "err": h["errs"][-1][-1]}
            for k in loss_keys:
                v = h[k]
                row[k] = float(np.mean(v)) if isinstance(v, (list, tuple)) else v
            rep.add_row(**row)
        rep.to_csv(f"{base_path}/logs/report.csv", highlight_column="acc")
        rep.to_markdown(f"{base_path}/logs/report.md", highlight_column="acc")
        rep.to_xlsx(f"{base_path}/logs/report.xlsx", highlight_column="acc")


def make_experiment(cfg: Config, exp_mark: str):
    """Reference exec(): experiment naming + logger + base path."""
    experiment = "{}({}_{})_{}_{}".format(
        cfg.data_source, cfg.train_count, cfg.label_ratio, exp_mark,
        datetime.datetime.now().strftime("%Y%m%d%H%M%S"))
    base_path = f"{cfg.experiment_root}/{experiment}"
    logger = Logger(experiment, base_path=base_path)
    return experiment, base_path, logger


def run_regime(trainer_cls, exp_mark: str, params=None, device=None):
    """Shared exec() body of every regime's entry point: config override,
    experiment naming, the trainer on ``device`` (None: the card), its
    run.  Returns the history."""
    cfg = Config().override(params)
    np.random.seed(cfg.seed)
    _, base_path, logger = make_experiment(cfg, exp_mark)
    return trainer_cls(cfg, device=device, logger=logger).run(base_path)
