"""Classification SSL branch on CIFAR (reference models/classification,
datasets/classification and the Class* losses, utils/losses.py:289-354).

Port of ``ubpl_tpu/train/classification.py``, with its three modes:

  mode="supervised": CE on the labelled samples
  mode="mt":         + an EMA teacher and the softmax-MSE consistency
                     (``class_dist``)
  mode="mt_ubpl":    two student/teacher pairs, + the ensemble softmax
                     pseudo loss (``class_pseudo``) and the inverse-distance
                     feature loss (``class_feature_dist``), as MT_UBPL

Every classifier has two heads (x1, x2); training and validation use x1.
Per step: one batch gathered from the uint8 training set on the device,
one augmented view that every student and teacher sees, the teachers'
train-mode forwards under ``no_grad`` (their BatchNorm stats move), the
students' forwards, one backward, one AdamW step over all students, then
the EMA of the parameters — with no host sync: the metrics stay device
tensors until the epoch's end.  Like the JAX trainer it writes no
checkpoint.
"""
import copy
import datetime

import numpy as np
import torch

from ..config import Config
from ..data.cifar import CIFAR10Data, CIFAR100Data
from ..data.sampler import (TwoStreamBatchSampler, supervised_epoch_batches,
                            valid_batches)
from ..device import autocast, memory_format, resolve_device
from ..models import create_class_model, param_count
from ..ops import augment as A
from ..utils import Logger, json_save
from . import losses as L
from . import schedules as S
from .base_trainer import make_experiment
from .common import make_class_view
from .mt_ubpl import optimize_and_ema

MODES = ("supervised", "mt", "mt_ubpl")


def class_forward(model, images, train, compute_dtype):
    """Run a classifier; returns (head-x1 logits float32, features float32
    or None).  train=True runs BatchNorm on batch statistics and updates
    its running stats in place."""
    model.train(train)
    x = images.contiguous(memory_format=memory_format(images.device))
    with autocast(images.device, compute_dtype):
        out = model(x)
    (logits, _), feat = out if model.mode != "default" else (out, None)
    return logits.float(), None if feat is None else feat.float()


def class_step(students, teachers, optimizer, view, labels, islabeled,
               mode, cons_weight, pseudo_weight, ema_alpha,
               compute_dtype="float32"):
    """One step of ``mode`` (``ubpl_tpu/train/classification.py:141-199``)
    on a built view; returns the metrics as 0-dim device tensors: ``ce``
    (and ``cons``, ``pseudo``, ``fdl`` where the mode has them), each the
    mean over the students as in the JAX step."""
    M = len(students)
    sw_nega = (1.0 - (islabeled > 0).float()) * pseudo_weight
    with torch.no_grad():
        t_logits = torch.stack([class_forward(t, view, True, compute_dtype)[0]
                                for t in teachers])
    outs = [class_forward(s, view, True, compute_dtype) for s in students]
    metrics = {}
    ce = []
    for logits, _ in outs:
        s, n = L.class_loss(logits, labels)
        ce.append(torch.where(n > 0, s / n.clamp(min=1), s))
    total = sum(ce)
    metrics["ce"] = total / M
    if mode in ("mt", "mt_ubpl"):
        cons = 0.0
        for m, (logits, _) in enumerate(outs):
            s, n = L.class_dist(logits, t_logits[m])
            cons = cons + cons_weight * s / max(n, 1)
        total = total + cons
        metrics["cons"] = cons / M
    if mode == "mt_ubpl":
        pseudo = 0.0
        for logits, _ in outs:
            s, n = L.class_pseudo(logits, t_logits, sw_nega)
            pseudo = pseudo + cons_weight * torch.where(
                n > 0, s / n.clamp(min=1), s)
        total = total + pseudo
        metrics["pseudo"] = pseudo / M
        if outs[0][1] is not None:
            s, n = L.class_feature_dist(outs[0][1], outs[1][1])
            fdl = s / max(n, 1)
            total = total + 2.0 * fdl
            metrics["fdl"] = fdl
    optimize_and_ema(students, teachers, optimizer, total, ema_alpha)
    return {k: v.detach() for k, v in metrics.items()}


class ClassificationTrainer:
    def __init__(self, cfg: Config, mode="mt", datasource=None, logger=None,
                 device=None):
        if mode not in MODES:
            raise ValueError(f"unknown classification mode {mode!r}; "
                             f"choices: {MODES}")
        self.cfg = cfg
        self.mode = mode
        self.n_models = 2 if mode == "mt_ubpl" else 1
        self.device = resolve_device(device)
        self.logger = logger or Logger(f"{cfg.data_source}_class_{mode}")
        self._setup_data(datasource)
        self._setup_model()
        self.best_acc = -1.0
        self.best_epoch = 0
        self._step_num = 0

    # ------------------------------------------------------------------ data
    def _setup_data(self, datasource):
        """The split of ``datasource`` (by default CIFAR-10/100 from
        ``cfg.data_root``) as uint8 images, labels and flags on the
        device."""
        cfg = self.cfg
        if datasource is None:
            ds_cls = (CIFAR100Data if cfg.data_source == "cifar100"
                      else CIFAR10Data)
            datasource = ds_cls(data_root=cfg.data_root,
                                cache_dir=cfg.cache_dir, seed=cfg.seed)
        cfg.inp_res = datasource.inp_res
        self.num_classes = datasource.num_classes
        semi, valid, _, _, lab_idxs, unlab_idxs, means, _ = \
            datasource.get_semi_data(cfg.train_count, cfg.valid_count,
                                     cfg.label_ratio)
        self.labeled_idxs, self.unlabeled_idxs = (list(lab_idxs),
                                                  list(unlab_idxs))
        tr = datasource.materialize(semi, is_train=True)
        va = datasource.materialize(valid, is_train=False)

        def put(x, dtype):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)

        self.train_images = put(tr.images, np.uint8)
        self.train_labels = put(tr.labels, np.int64)
        self.train_islabeled = put(tr.islabeled, np.int32)
        self.valid_images = put(va.images, np.uint8)
        self.valid_labels = put(va.labels, np.int64)
        self.means = put(means, np.float32)
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    # ----------------------------------------------------------------- model
    def _make_model(self, seed):
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = create_class_model(cfg.model, self.num_classes,
                                       cfg.feature_mode)
        return model.to(self.device,
                        memory_format=memory_format(self.device))

    def _setup_model(self):
        """Student i from ``cfg.seed + i``, its EMA teacher a copy of it,
        one AdamW over all students (optax ``adamw(lr, weight_decay=wd)``:
        constant lr, decay on every parameter)."""
        cfg = self.cfg
        self.students = [self._make_model(cfg.seed + i)
                         for i in range(self.n_models)]
        self.teachers = [copy.deepcopy(s).requires_grad_(False)
                         for s in self.students]
        self.optimizer = torch.optim.AdamW(
            [p for s in self.students for p in s.parameters()], lr=cfg.lr,
            weight_decay=cfg.wd)
        self.logger.print(
            "L1", "=> initialized {} classifier (params: {:.2f}M)".format(
                cfg.model, sum(param_count(s) for s in self.students)
                / 1024 ** 2))

    # ------------------------------------------------------------------ step
    def train_step(self, idxs, cons_weight, pseudo_weight, ema_alpha):
        """Gather the batch ``idxs``, build its augmented view (draws from
        the trainer's generator) and take one ``class_step``."""
        i = torch.as_tensor(np.asarray(idxs), device=self.device)
        view = make_class_view(
            self.train_images[i], self.means, self.cfg,
            A.draw_augment(len(i), self.generator, self.device))
        return class_step(self.students, self.teachers, self.optimizer,
                          view, self.train_labels[i],
                          self.train_islabeled[i], self.mode, cons_weight,
                          pseudo_weight, ema_alpha, self.cfg.compute_dtype)

    # ------------------------------------------------------------------ loop
    def train_epoch(self, epo):
        """One epoch under the epoch's schedules; returns each metric's
        mean over the steps (one host read, at the end)."""
        cfg = self.cfg
        cons = S.cons_weight(epo, cfg.cons_weight_max, cfg.cons_weight_min,
                             cfg.cons_weight_rampup)
        pw = S.pseudo_weight(epo, cfg.pseudo_weight_max,
                             cfg.pseudo_weight_min, cfg.pseudo_weight_rampup)
        alpha = S.ema_alpha(epo, cfg.ema_decay)
        if self.mode == "supervised":
            batches = supervised_epoch_batches(self.labeled_idxs,
                                               cfg.train_bs, self.rng)
        else:
            batches = TwoStreamBatchSampler(
                self.unlabeled_idxs, self.labeled_idxs, cfg.train_bs,
                cfg.train_bs_labeled, self.rng)
        steps = []
        for idxs in batches:
            self._step_num += 1
            steps.append(self.train_step(idxs, cons, pw, alpha))
        if not steps:
            return {}
        keys = list(steps[0])
        host = torch.stack([torch.stack([m[k] for k in keys])
                            for m in steps]).cpu().tolist()
        counters = {k: L.AvgCounter() for k in keys}
        for row in host:
            for k, v in zip(keys, row):
                counters[k].update(v)
        return {k: c.avg for k, c in counters.items()}

    @torch.inference_mode()
    def validate(self):
        """Accuracy of the argmax of the mean x1 logits of the EMA teachers
        (the students for ``supervised``), eval mode, no augmentation; the
        count stays on the device until the end."""
        cfg = self.cfg
        models = self.students if self.mode == "supervised" else self.teachers
        n = self.valid_images.shape[0]
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for idxs in valid_batches(n, cfg.infer_bs):
            i = torch.as_tensor(idxs, device=self.device)
            view = make_class_view(self.valid_images[i], self.means, cfg)
            logits = torch.stack([
                class_forward(m, view, False, cfg.compute_dtype)[0]
                for m in models]).mean(dim=0)
            correct += (logits.argmax(-1) == self.valid_labels[i]).sum()
        return int(correct) / n

    def run(self):
        cfg = self.cfg
        history = []
        for epo in range(cfg.epochs):
            tm = datetime.datetime.now()
            losses = self.train_epoch(epo)
            acc = self.validate()
            if acc > self.best_acc:
                self.best_acc, self.best_epoch = acc, epo
            self.logger.print(
                "L1", "[{:3d}/{:3d}] | {} | acc: {:.4f} (best {:.4f} @ {})"
                .format(epo + 1, cfg.epochs,
                        ", ".join(f"{k}={v:.4f}" for k, v in losses.items()),
                        acc, self.best_acc, self.best_epoch + 1), start=tm)
            history.append({**losses, "acc": acc})
        return history


def exec_regime(exp_mark="Classification", params=None, device=None,
                mode=None):
    """Entry point of the ``classification`` regime
    (``ubpl_tpu/train/classification.py:exec_regime``).

    mode: supervised | mt | mt_ubpl (default mt, or ``params["mode"]``);
    cfg.model picks the net (VGG / ResNet / MobileNet; "VGG" when a pose
    model is named); cfg.data_source cifar10 | cifar100 (cifar10 when
    another source is named).  Writes ``logs/classification.json``.
    """
    params = dict(params or {})
    mode = mode or params.pop("mode", "mt")
    cfg = Config().override(params)
    if cfg.model.startswith(("HG", "LitePose")):
        cfg.model = "VGG"               # the pose default does not apply
    if cfg.data_source not in ("cifar10", "cifar100"):
        cfg.data_source = "cifar10"
    np.random.seed(cfg.seed)
    _, base_path, logger = make_experiment(cfg, f"{exp_mark}_{mode}")
    trainer = ClassificationTrainer(cfg, mode=mode, logger=logger,
                                    device=device)
    history = trainer.run()
    json_save({"history": history, "best_acc": trainer.best_acc,
               "best_epoch": trainer.best_epoch},
              f"{base_path}/logs/classification.json", is_cover=True)
    return history
