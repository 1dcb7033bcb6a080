"""Runner of the pose training cells: the program's MT_UBPL trainer
stepped through ``run_train_steps``, one call per batch, as its epoch
loop and the ``bench`` regime drive it.

Traffic parameters (``traffic/<name>.json``): ``batch_unlabeled`` and
``batch_labeled`` rows per step (unlabelled first, as the two-stream
sampler orders them), ``dataset_images`` resident on the card as uint8
with ``labeled_share`` of them labelled, the step's ``schedule``
(``cons_weight``, ``fdl_weight``, ``pseudo_weight``, ``ema_alpha``),
``views``, ``check_steps`` (the steps the reference follows) and
``trace_steps`` (the profiled stretch).

Set-up: the trainer is built, then handed the benchmark's inputs, all
made on the card from the seed: the dataset (on a mesh, this rank's shard
of it), each branch's weights (its teacher starts as a copy; on a mesh,
this rank's branches), the batch order, and the seed of the trainer's
augmentation generator.  The first ``check_steps`` steps warm every shape
the window uses, and their readings are kept for the check
(``training.TrainProgram``), with the heatmap targets that the step's
kernel writes in them, copied as they leave it.
"""
import contextlib

import torch

from .. import flops
from .. import weights as W
from ..harness import seeds
from ..reference import augment as RA
from ..reference import pose as RP
from .training import TrainKept, TrainProgram, batch_order, reference_steps

#: the counts the step's losses divide by, as the program's step returns
#: them and the reference works them out
COUNTS = ("pec_count", "mtc_count", "epc_count", "fdc_count")
#: the step's weighted loss terms
TERMS = ("pec", "mtc", "epc", "fdc")


def program_config(cell, seed):
    """The program's ``Config`` from the cell's files."""
    from ubpl_torch.config import Config
    c, t = cell.config, cell.traffic
    bs = t["batch_unlabeled"] + t["batch_labeled"]
    return Config(model=c["model"], feature_mode=c["feature_mode"],
                  synthetic_data=True, synthetic_kps=c["kps"],
                  inp_res=c["inp_res"], out_res=c["out_res"],
                  train_count=bs, valid_count=1, label_ratio=0.5,
                  train_bs=bs, train_bs_labeled=t["batch_labeled"],
                  infer_bs=bs, epochs=1, compute_dtype=c["compute_dtype"],
                  seed=seed, **c["hyper"])


def make_dataset(cell, seed, device):
    """uint8 BGR images [n, R, R, 3], keypoints [n, K, 3] (the labelled
    rows' uniform inside a 16-pixel margin, visible; the others 0) and the
    labelled flags, on ``device`` from ``seed``."""
    c, t = cell.config, cell.traffic
    n, R, K = t["dataset_images"], c["inp_res"], c["kps"]
    n_lab = int(round(n * t["labeled_share"]))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    images = torch.randint(0, 256, (n, R, R, 3), generator=g, device=device,
                           dtype=torch.uint8)
    xy = torch.rand(n, K, 2, generator=g, device=device) * (R - 32) + 16
    islabeled = torch.zeros(n, dtype=torch.int32, device=device)
    islabeled[:n_lab] = 1
    lab = islabeled[:, None, None].float()
    kps = torch.cat([xy, torch.ones(n, K, 1, device=device)], -1) * lab
    return images, kps, islabeled, n_lab


class Program(TrainProgram):
    def __init__(self, cell, seed, device, mesh=None):
        from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
        from ubpl_torch.utils import Logger
        c, t = cell.config, cell.traffic
        self.cell = cell
        s_data, s_weights, s_aug, s_order, s_prog = seeds(seed, 5)
        self.bs = t["batch_unlabeled"] + t["batch_labeled"]
        self.sched_args = tuple(t["schedule"][k] for k in (
            "cons_weight", "fdl_weight", "pseudo_weight", "ema_alpha"))
        self.trainer = tr = MTUBPLTrainer(
            program_config(cell, s_prog), device=device,
            logger=Logger("benchmark", console_level=None), mesh=mesh)
        if tr.n_views != t["views"]:
            raise ValueError(f"the trainer builds {tr.n_views} views, the "
                             f"traffic asks for {t['views']}")
        tr.train_data, n_lab = self._dataset(s_data, device)
        n = tr.train_data.total
        tr.means = tr.train_data.means
        tr.labeled_idxs = list(range(n_lab))
        tr.unlabeled_idxs = list(range(n_lab, n))
        states = W.make_states(c["model"], c["kps"], tr.n_models, s_weights,
                               device)
        #: the initial states of this rank's branches
        self.states = [states[i] for i in tr.branch_ids(tr.n_models)]
        for s, te, sd in zip(tr.students, tr.teachers, self.states):
            s.load_state_dict(sd)
            te.load_state_dict(sd)
        tr.generator.manual_seed(s_aug)
        self.aug_seed = s_aug
        self.batches = batch_order(n, n_lab, t["batch_unlabeled"],
                                   t["batch_labeled"], s_order)
        self.flops_per_step = flops.teacher_student_step_flops(
            c["model"], c["kps"], c["inp_res"], self.bs, t["views"],
            tr.n_models, tr.n_models)
        self._check_steps()

    def _dataset(self, seed, device):
        """The dataset rows this rank holds (all of them on one card), and
        the count of labelled rows."""
        from ubpl_torch.train.common import DeviceDataset
        images, kps, islabeled, n_lab = make_dataset(self.cell, seed, device)
        means = torch.tensor(self.cell.config["means"], dtype=torch.float32,
                             device=device)
        n = images.shape[0]
        rows = self.trainer.local_rows(n)
        if rows != slice(0, n):
            images, kps, islabeled = (images[rows].clone(), kps[rows].clone(),
                                      islabeled[rows].clone())
        return DeviceDataset(images, kps, kps.clone(), islabeled, means,
                             rows.start, n), n_lab

    def _step(self, batch):
        return self.trainer.run_train_steps([batch], *self.sched_args)[0]

    @staticmethod
    def _loss_and_counts(m):
        loss = m["pec"].sum() + m["mtc"].sum() + m["epc"].sum() + \
            2.0 * m["fdc"]
        return loss, {k: m[k] for k in COUNTS}

    @staticmethod
    def _terms(m):
        return {k: m[k] for k in TERMS}

    @contextlib.contextmanager
    def _targets(self):
        """Copy each (maps, keypoints) that the heatmap kernel returns
        while the check steps run."""
        from ubpl_torch.ops.kernels import heatmap_synth as K
        synth, maps = K.synthesize_heatmaps, []

        def copied(*args, **kwargs):
            hm, kps = synth(*args, **kwargs)
            maps.append((hm.clone(), kps.clone()))
            return hm, kps
        K.synthesize_heatmaps = copied
        try:
            yield maps
        finally:
            K.synthesize_heatmaps = synth

    def release(self):
        rows = self.check_rows()
        d = self.trainer.train_data
        kept = Kept(self.cell, d.images.device, self.states, self.aug_seed,
                    d.images[rows].clone(), d.kps[rows].clone(),
                    d.islabeled[rows].clone(), d.means.clone(),
                    self.readings)
        del self.trainer, d
        return kept


class Kept(TrainKept):
    def __init__(self, cell, device, states, aug_seed, images, kps,
                 islabeled, means, readings):
        c = cell.config
        self.cell, self.device, self.states = cell, device, states
        self.aug_seed = aug_seed
        self.images, self.kps, self.islabeled = images, kps, islabeled
        self.means, self.readings = means, readings
        self.kernel_bytes = {"heatmap_synth": flops.heatmap_bytes(
            images.shape[0] // cell.traffic["check_steps"], c["kps"],
            c["out_res"])}

    def reference(self, precision="fp32"):
        """The reference's readings over the check steps, from the same
        inputs: the batches' rows, the initial weights, and the
        augmentation draws worked out again from their seed."""
        c, t = self.cell.config, self.cell.traffic
        bs = self.images.shape[0] // t["check_steps"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.aug_seed)
        maps = []

        def step_loss(i, students, teachers):
            rows = slice(i * bs, (i + 1) * bs)
            views = [RP.make_view(self.images[rows], self.kps[rows],
                                  self.means, RA.draw(bs, gen, self.device),
                                  c["inp_res"], c["out_res"],
                                  c["hyper"]["scale_range"],
                                  c["hyper"]["rot_range"])
                     for _ in range(t["views"])]
            maps.extend((hm, kps) for _, hm, kps in views)
            return RP.mt_ubpl_loss(students, teachers, views,
                                   self.islabeled[rows], t["schedule"],
                                   c["hyper"])
        ref = reference_steps(self.cell, c["model"], c["kps"], self.states,
                              self.device, precision, step_loss)
        ref.maps = maps
        return ref
