"""Runner of the classification training cells: the program's
``ClassificationTrainer.train_step`` in its ``mt_ubpl`` mode, one call
per batch, as its epoch loop drives it.

Traffic parameters: ``batch_unlabeled`` and ``batch_labeled`` rows per
step (unlabelled first), ``train_images`` and ``valid_images`` resident on
the card as uint8 with ``labeled_images`` of the training ones labelled
(the others carry label -1), the step's ``schedule`` (``cons_weight``,
``pseudo_weight``, ``ema_alpha``), ``check_steps`` and ``trace_steps``.
Set-up and the kept readings are as in ``train_pose``.
"""
from types import SimpleNamespace

import numpy as np
import torch

from .. import flops
from .. import weights as W
from ..harness import seeds
from ..reference import augment as RA
from ..reference import classify as RC
from .training import TrainKept, TrainProgram, batch_order, reference_steps


class _NoData:
    """A datasource of one blank row: the benchmark hands the trainer its
    own data once it is built."""
    inp_res, num_classes = 32, 10

    def get_semi_data(self, train_count, valid_count, label_ratio):
        return [], [], [], [], [], [], [0.5] * 3, [0.5] * 3

    def materialize(self, records, is_train=True):
        return SimpleNamespace(images=np.zeros((1, 32, 32, 3), np.uint8),
                               labels=np.zeros(1), islabeled=np.zeros(1))


def make_dataset(cell, seed, device):
    """uint8 images and labels of the training and validation sets, and
    the training set's labelled flags, on ``device`` from ``seed``."""
    c, t = cell.config, cell.traffic
    R, n, nv = c["inp_res"], t["train_images"], t["valid_images"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    images = torch.randint(0, 256, (n + nv, R, R, 3), generator=g,
                           device=device, dtype=torch.uint8)
    labels = torch.randint(0, c["classes"], (n + nv,), generator=g,
                           device=device)
    n_lab = t["labeled_images"]
    islabeled = torch.zeros(n, dtype=torch.int32, device=device)
    islabeled[:n_lab] = 1
    train_labels = torch.where(islabeled > 0, labels[:n], -1)
    return (images[:n], train_labels, islabeled, images[n:], labels[n:],
            n_lab)


class Program(TrainProgram):
    def __init__(self, cell, seed, device):
        from ubpl_torch.config import Config
        from ubpl_torch.train.classification import ClassificationTrainer
        from ubpl_torch.utils import Logger
        c, t = cell.config, cell.traffic
        self.cell = cell
        s_data, s_weights, s_aug, s_order, s_prog = seeds(seed, 5)
        self.bs = t["batch_unlabeled"] + t["batch_labeled"]
        self.sched_args = tuple(t["schedule"][k] for k in (
            "cons_weight", "pseudo_weight", "ema_alpha"))
        cfg = Config(model=c["model"], feature_mode=c["feature_mode"],
                     data_source="cifar10", train_bs=self.bs,
                     train_bs_labeled=t["batch_labeled"],
                     compute_dtype=c["compute_dtype"], seed=s_prog,
                     **c["hyper"])
        self.trainer = tr = ClassificationTrainer(
            cfg, mode="mt_ubpl", datasource=_NoData(),
            logger=Logger("benchmark", console_level=None), device=device)
        (tr.train_images, tr.train_labels, tr.train_islabeled,
         tr.valid_images, tr.valid_labels, n_lab) = make_dataset(
            cell, s_data, device)
        tr.means = torch.tensor(c["means"], dtype=torch.float32,
                                device=device)
        self.states = W.make_states(c["arch"], c["classes"],
                                    len(tr.students), s_weights, device)
        for s, te, sd in zip(tr.students, tr.teachers, self.states):
            s.load_state_dict(sd)
            te.load_state_dict(sd)
        tr.generator.manual_seed(s_aug)
        self.aug_seed = s_aug
        self.batches = batch_order(t["train_images"], n_lab,
                                   t["batch_unlabeled"], t["batch_labeled"],
                                   s_order)
        self.flops_per_step = flops.teacher_student_step_flops(
            c["arch"], c["classes"], c["inp_res"], self.bs, 1,
            len(tr.students), len(tr.teachers))
        self._check_steps()

    def _step(self, batch):
        return self.trainer.train_step(batch, *self.sched_args)

    def _loss_and_counts(self, m):
        """The step's metrics are means over the students (``ce``,
        ``cons``, ``pseudo``) and the feature distance ``fdl``, which the
        loss counts twice; the step returns no counts."""
        M = len(self.trainer.students)
        return M * (m["ce"] + m["cons"] + m["pseudo"]) + 2.0 * m["fdl"], None

    @staticmethod
    def _terms(m):
        return {k: m[k] for k in ("ce", "cons", "pseudo", "fdl")}

    def release(self):
        tr, rows = self.trainer, self.check_rows()
        kept = Kept(self.cell, tr.device, self.states, self.aug_seed,
                    tr.train_images[rows].clone(),
                    tr.train_labels[rows].clone(),
                    tr.train_islabeled[rows].clone(), tr.means.clone(),
                    self.readings)
        del self.trainer, tr
        return kept


class Kept(TrainKept):
    def __init__(self, cell, device, states, aug_seed, images, labels,
                 islabeled, means, readings):
        self.cell, self.device, self.states = cell, device, states
        self.aug_seed = aug_seed
        self.images, self.labels, self.islabeled = images, labels, islabeled
        self.means, self.readings = means, readings

    def reference(self, precision="fp32"):
        """The reference's readings over the check steps, from the same
        inputs and the augmentation draws worked out again from their
        seed."""
        c, t = self.cell.config, self.cell.traffic
        bs = self.images.shape[0] // t["check_steps"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.aug_seed)

        def step_loss(i, students, teachers):
            rows = slice(i * bs, (i + 1) * bs)
            view = RC.make_view(self.images[rows], self.means,
                                RA.draw(bs, gen, self.device), c["inp_res"],
                                c["hyper"]["scale_range"],
                                c["hyper"]["rot_range"])
            loss, terms = RC.class_loss(students, teachers, view,
                                        self.labels[rows],
                                        self.islabeled[rows], t["schedule"])
            return loss, None, terms
        return reference_steps(self.cell, c["arch"], c["classes"],
                               self.states, self.device, precision,
                               step_loss)
