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
``resume`` (``:624-638``), the UBPL pseudo-label rounds with their
checkpointed state (``:640-741``: ``_ensure_pseudo_loop``,
``_pseudo_checkpoint_meta``, ``_restore_pseudo_state``,
``maybe_pseudo_round``), ``run`` with ``maybe_debug_draw``, the
``profile_dir`` trace, the preemption guard and ``_write_report``
(``:743-837``), the ``torch_init`` warm start
(``ubpl_tpu/models/torch_import.py:196-240``), and ``make_experiment`` /
``run_regime`` (``:851-873``).  With ``stream_data`` the training set stays
on the host and ``train/streaming.py`` moves each batch (``:132-141``,
``:423-497``).  The constructor refuses what the JAX package refuses
(``:57-73``).

Data parallel (``mesh``, one process per card; ``parallel/``): the
datasets are padded to ``batch_mult`` and each rank holds its
``batch_rows`` of them (``_dataset_sharding``, ``:145-158``).  A batch is
gathered as the JAX package lowers it, by masked local gathers and one
batch-sized all-reduce (``gather_rows``), and each rank keeps its own rows
of it.  Every rank draws the same batch order and the augmentation draws of
the global batch, then keeps its rows of them, so a rank's views are the
single-process views' rows.  Validation and the pseudo-label rounds split
their batches over the ranks and gather the predictions in order.  Rank 0
alone writes checkpoints, logs and reports; the ranks' losses, metrics and
validation results are global, so every rank returns the same history.

Branch parallel (a ``model`` axis; ``make_branch_forward``'s ``shard_map``
and ``_shard_for_mesh``, ``:210-379``): a rank builds only its branches of
the regime's ``n_models`` (``BranchGroup.local``; branch ``i`` still from
``cfg.seed + i``, so a world equals one process) and names them in
``self.networks`` as one process does; its AdamW covers its students.  The
step exchanges the teachers' outputs and the students' features over the
branch group (``train/mt_ubpl.py``), validation gathers the heads'
coordinates, checkpoints gather every branch and its AdamW state into one
process's layout, and ``resume`` gives each rank its own.  A regime without
a branch axis (``n_models`` 1) runs whole on every ``model`` index.  The
barriers and the preemption flag span the world.

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
from ..models.layers import set_batch_group
from ..models.weights import (export_reference_state,
                              load_reference_checkpoint, load_state,
                              port_state_from_reference)
from ..ops import augment as A
from ..parallel import collectives as PC
from ..parallel.launch import launch, under_torchrun, world_size_from_env
from ..parallel.mesh import (batch_rows, build_mesh, local_branches,
                             local_mesh_size)
from ..utils import Logger, json_save
from ..utils.preemption import PreemptionGuard
from ..utils.profiling import span, trace
from ..utils.report import RunReport
from . import losses as L
from .checkpointing import restore_checkpoint, save_checkpoint
from .common import (make_view, pck_heads, predict_heads_batch, put_dataset,
                     sample_weights, update_pck_counters)
from .pseudo_loop import PseudoLabelingLoop, round_draws
from .step_graph import StepGraph, engages as graph_engages
from .streaming import BatchStreamer, StreamedBatch, host_dataset

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
    #: dual-teacher regimes run the UBPL rounds of cfg.pseudo_rounds
    supports_pseudo_loop = False
    #: regimes with a primary/secondary loss split run cfg.optimizer="mld"
    supports_mld = False
    #: the stacked branch axis that a ``model`` mesh axis splits (1: none)
    n_models = 1
    #: the regime's step after the views goes through ``step_graph``
    graphs_step = False

    def __init__(self, cfg: Config, device=None, logger=None, mesh=None):
        if cfg.optimizer not in ("adamw", "mld"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                             "(adamw | mld)")
        if cfg.optimizer == "mld" and not self.supports_mld:
            raise ValueError(
                "optimizer='mld' needs a primary/secondary loss split; "
                f"{self.regime} has a single loss group "
                "(supported: MT_UBPL, DualPose_UBPL)")
        if cfg.stream_data and cfg.scan_batches > 1:
            raise ValueError(
                "stream_data streams one batch per step; scan_batches>1 "
                "gathers several batches from the device-resident dataset "
                "per call — pick one")
        if cfg.stream_data and cfg.pseudo_rounds > 0:
            raise ValueError(
                "pseudo_rounds runs UBPL selection over the device-resident "
                "training set; stream_data keeps it on host — pick one")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: ``parallel.mesh.Mesh`` of a run over several devices (one
        #: process per device, started by ``parallel.launch``); None on one
        self.mesh = mesh
        #: the ranks that split each batch, those that split the branches,
        #: and the world (``parallel.collectives``); None where not split
        self.group = PC.batch_group(mesh, self.device)
        self.branches = PC.branch_group(mesh, self.device, self.n_models)
        self.world = PC.world_group(mesh, self.device)
        self.rank = self.world.rank if self.world else 0
        #: replays the step after the views as one CUDA graph where that
        #: step's work stays on one card (``train/step_graph.py``)
        self.step_graph = StepGraph(self.device, enabled=(
            self.graphs_step and graph_engages(self.device, self.group,
                                               self.branches, cfg)))
        self.logger = logger or Logger(f"{cfg.data_source}_{self.regime}")
        if not PC.is_writer():      # data parallel: rank 0 alone logs
            self.logger = Logger(self.logger.experiment, console_level=None)
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
        #: tokens through transformer blocks, and drop-path mask sets made,
        #: over the teacher-student steps taken (``count_backbone``)
        self.backbone_tokens = self.drop_path_draws = 0
        self._pseudo_loop = None
        self._pseudo_rounds_done = 0

    # ------------------------------------------------------------------ data
    def _setup_data(self):
        """The dataset in device memory: from ``cfg.data_source`` on disk
        (split, materialised once, the split's means), or synthetic.  With
        ``cfg.stream_data`` the training split stays on the host
        (``train_host``, ``train_data`` None) and ``streamer`` moves its
        batches; the validation split is on the device either way."""
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
        if cfg.stream_data:
            self.train_host = host_dataset(train["images"], train["kps"],
                                           train["islabeled"], self.device)
            self.train_data = None
            self.streamer = BatchStreamer(self.train_host, self.device)
        else:
            self.train_host = self.streamer = None
            self.train_data = put_dataset(**train, means=means,
                                          device=self.device, mesh=self.mesh,
                                          rank=self.rank)
        self.valid_data = put_dataset(**valid, means=means, device=self.device,
                                      mesh=self.mesh, rank=self.rank)
        self.means = self.valid_data.means
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

    def gather_rows(self, data, idxs,
                    fields=("images", "kps", "islabeled")):
        """The rows ``idxs`` (global indices) of ``data``'s ``fields``, on
        the device of every rank.  Sharded, each rank fills the rows it
        holds (zeros elsewhere) and one all-reduce of their bytes
        completes the batch everywhere."""
        idxs = np.asarray(idxs, np.int64)
        if self.group is None:
            i = torch.from_numpy(idxs)
            if self.device.type == "cuda":
                # through pinned memory: a pageable copy would make the host
                # wait for the card (the caching host allocator keeps the
                # block until the copy is done)
                i = i.pin_memory().to(self.device, non_blocking=True)
            return [getattr(data, f)[i] for f in fields]
        local = idxs - data.offset
        own = (local >= 0) & (local < data.images.shape[0])
        at = torch.as_tensor(np.flatnonzero(own), device=self.device)
        src = torch.as_tensor(local[own], device=self.device)
        bufs = []
        for f in fields:
            x = getattr(data, f)
            buf = x.new_zeros((len(idxs),) + tuple(x.shape[1:]))
            bufs.append(buf.index_copy_(0, at, x[src]))
        return PC.sum_rows_bytes(bufs, self.group)

    def local_rows(self, n):
        """This rank's rows of an ``n``-row global batch (a slice)."""
        rows = batch_rows(self.mesh if self.group else None, self.rank, n)
        return slice(rows.start, rows.stop)

    def fetch_batch(self, data, batch):
        """This rank's rows of one batch on the device: ``batch`` is a
        global index list gathered from the device-resident ``data``, or
        (``stream_data``) a ``StreamedBatch`` of this rank's rows already
        on its way."""
        if isinstance(batch, StreamedBatch):
            return batch.take()
        rows = self.local_rows(len(batch))
        return [x[rows] for x in self.gather_rows(data, batch)]

    def augmented_view(self, imgs, kps, *, scale_range=None, rot_range=None,
                       occlude=None):
        """One augmented view of this rank's rows of a gathered batch: the
        augmentation draws of the global batch (then its occlusion draws,
        where ``occlude`` — by default ``cfg.use_occlusion`` — is on and
        there is a bank) from the trainer's generator, this rank's rows of
        them, and one heatmap-kernel launch."""
        cfg = self.cfg
        B = imgs.shape[0] * PC.size(self.group)
        rows = self.local_rows(B)
        draws = A.draw_augment(B, self.generator, self.device)
        draws = type(draws)(*(x[rows] for x in draws))
        occlude = cfg.use_occlusion if occlude is None else occlude
        occlusion = None
        if occlude and self.occluder_bank is not None:
            rgb, alpha = self.occluder_bank
            occ = A.draw_occlusion(B, cfg.num_occluder, rgb.shape[0],
                                   self.generator, self.device)
            occlusion = (rgb, alpha, type(occ)(*(x[rows] for x in occ)))
        return make_view(imgs, kps, self.means, cfg, draws,
                         scale_range=scale_range, rot_range=rot_range,
                         occlusion=occlusion)

    def view_options(self, i):
        """``augmented_view``'s keyword arguments for view ``i`` of a step:
        none, every view draws from the configured ranges."""
        return {}

    def make_views(self, idxs, n_views):
        """Gather a training batch and build ``n_views`` independently
        augmented views of it (view i with ``view_options(i)``).  Returns
        (views, islabeled)."""
        with span("train.views"):
            imgs, kps, islabeled = self.fetch_batch(self.train_data, idxs)
            views = [self.augmented_view(imgs, kps, **self.view_options(i))
                     for i in range(n_views)]
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
        """One network, initialised from ``seed`` (cfg.seed by default) on
        the CPU (a ViTPose on the trainer's device), in the device's
        activation layout.  Data parallel, its BatchNorms use the global
        batch's statistics, and the batch group's first rank's weights are
        broadcast once (every rank drew the same ones: a guard)."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed if seed is None else seed)
            model = create_pose_model(cfg.model, cfg.kps_count,
                                      cfg.feature_mode, self.device)
        model = model.to(self.device,
                         memory_format=memory_format(self.device))
        with torch.no_grad():
            PC.broadcast_([*model.parameters(), *model.buffers()],
                          self.group)
        return set_batch_group(model, self.group)

    def branch_ids(self, n):
        """The branches of an ``n``-branch axis this rank holds: its
        ``BranchGroup.local``, or all of them."""
        return self.branches.local if self.branches else range(n)

    def _make_models(self, n):
        """This rank's student branches of ``n``, branch i initialised from
        cfg.seed + i, each with an EMA teacher that starts as a copy of it:
        parameters (frozen: the EMA moves them) and BatchNorm running
        stats."""
        students = [self._make_model(self.cfg.seed + i)
                    for i in self.branch_ids(n)]
        teachers = [copy.deepcopy(s).requires_grad_(False) for s in students]
        return students, teachers

    def _setup_branches(self, n):
        """The student/teacher regimes' ``_setup_model``: n branches (this
        rank's of them), one AdamW over their students' parameters, and the
        networks named as the reference checkpoints name them:
        ``model[_ema]_state`` for one branch, ``model{i}[_ema]_state`` for
        several."""
        cfg = self.cfg
        self.students, self.teachers = self._make_models(n)
        self.networks = {}
        for i, s, t in zip(self.branch_ids(n), self.students, self.teachers):
            tag = "" if n == 1 else str(i + 1)
            self.networks[f"model{tag}_state"] = s
            self.networks[f"model{tag}_ema_state"] = t
        # wd passed explicitly: Config's is 0.0, torch's AdamW default 0.01;
        # a CUDA graph replays a capturable AdamW, fused: a few kernels
        graphed = self.step_graph.enabled
        self.optimizer = torch.optim.AdamW(
            [p for s in self.students for p in s.parameters()], lr=cfg.lr,
            weight_decay=cfg.wd, capturable=graphed, fused=graphed or None)

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
        self.step_graph.reset()
        return meta

    # ------------------------------------------------------------- step exec
    def train_step(self, idxs, *sched_args):
        raise NotImplementedError

    @property
    def param_dtype(self):
        """The students' parameters' dtype: the graphed step's schedule
        has it, so a float64 run weighs its losses by doubles."""
        return next(self.students[0].parameters()).dtype

    @property
    def graph_captures(self):
        """CUDA graphs captured of the step after the views (always on)."""
        return self.step_graph.graph_captures

    @property
    def graph_replays(self):
        """Steps replayed from a CUDA graph, the capturing steps included."""
        return self.step_graph.graph_replays

    @property
    def eager_steps(self):
        """Steps of a ``graphs_step`` regime run eagerly: every one where
        the graph does not engage, else the first at each input shape."""
        return self.step_graph.eager_steps

    def count_backbone(self, views):
        """Add one teacher-student step to ``backbone_tokens`` and
        ``drop_path_draws``, from its views' shapes (no sync): each student
        and teacher runs every view, one forward per view or one for the
        views folded together, and a transformer (``tokens``) with drop
        path makes one mask set per forward.  Networks without blocks add
        nothing."""
        n, _, h, w = views[0].images.shape
        calls = 1 if self.cfg.fold_views else len(views)
        for net in (*self.students, *self.teachers):
            if hasattr(net, "tokens"):
                self.backbone_tokens += len(views) * n * net.tokens(h, w)
                if net.drop_path_rate > 0:
                    self.drop_path_draws += calls

    def run_train_steps(self, batch_iter, *sched_args):
        """Drive batches through ``train_step`` (with ``stream_data``, each
        batch's copy — this rank's rows of it — issued one step ahead).
        Returns the per-step metric dicts as device tensors; reading them
        (the caller's reduction) is the only host sync."""
        if self.streamer is not None:
            batch_iter = self.streamer.batches(
                np.asarray(b)[self.local_rows(len(b))] for b in batch_iter)
        metrics = []
        for batch in batch_iter:
            self._step_num += 1
            with span("train.step"):
                metrics.append(self.train_step(batch, *sched_args))
        return metrics

    # ------------------------------------------------------------ validation
    def predict_split(self, predict, n_rows):
        """``predict(pick)`` -> [len(pick), ...] over the rows of an
        ``n_rows`` batch that every rank holds whole, split over the ranks:
        each predicts its share (the batch padded to a multiple of the
        rank count with copies of its last row) and the shares are
        gathered in order.  ``pick`` indexes the batch's rows (all of them,
        ``slice(None)``, on one process).  Returns ``n_rows`` rows."""
        d = PC.size(self.group)
        if d == 1:
            return predict(slice(None))
        n_pad = -(-n_rows // d) * d
        rows = self.local_rows(n_pad)
        pick = torch.arange(rows.start, rows.stop,
                            device=self.device).clamp(max=n_rows - 1)
        return PC.all_gather_rows(predict(pick), self.group)[:n_rows]

    def _validate_heads(self, models, with_mean):
        """Validation pass of several heads over the resident validation
        set with the reference's counter weighting; one device-to-host
        read per batch; ``with_mean``: the mean of the heads' coordinates
        is one more head.  Data parallel, each rank predicts its share of
        every batch and all compute the PCK of the whole batch; branch
        parallel, ``models`` are this rank's and their coordinates are
        gathered over the branch group before the mean head is formed.
        Returns (preds, accs, errs), one entry per head."""
        cfg = self.cfg
        n_heads, k = len(self.valid_heads), cfg.kps_count
        n_nets = len(models) * (self.branches.size if self.branches else 1)
        assert n_heads == n_nets + bool(with_mean)
        acc_cs = [L.AvgCounters() for _ in range(n_heads)]
        err_cs = [L.AvgCounters() for _ in range(n_heads)]
        preds_arrays = [[] for _ in range(n_heads)]
        for idxs in valid_batches(self.n_valid, cfg.infer_bs):
            imgs, kps = self.gather_rows(self.valid_data, idxs,
                                         ("images", "kps"))
            coords = self.predict_split(
                lambda pick: predict_heads_batch(
                    models, imgs[pick], self.means, cfg).transpose(0, 1),
                len(idxs)).transpose(0, 1)
            if self.branches is not None:
                coords = self.branches.gather_branches(coords)
            if with_mean:       # as ops/heatmap.py:decode_heatmaps_mul
                coords = torch.cat([coords, coords.mean(dim=0)[None]])
            errs, accs = pck_heads(coords, kps, cfg)
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
        """The regime's state in the reference checkpoint layout, each
        network with the keys the reference's strict load requires
        (``export_reference_state``).  Branch parallel, every rank of the
        branch group takes part: the state is gathered into one process's
        layout (``_gather_branches_state``)."""
        state = {k: export_reference_state(m)
                 for k, m in self.networks.items()}
        optim = self.optimizer.state_dict()
        if self.branches is not None:
            return self._gather_branches_state(state, optim)
        state["optim_state"] = optim
        return state

    def _gather_branches_state(self, nets, optim):
        """Every branch's exported networks (``nets``: this rank's) and
        AdamW state (``optim``: over this rank's students) gathered over
        the branch group in one collective: the networks in branch order
        under their reference names, and ``optim_state`` laid out as one
        AdamW over every student, parameter indices in branch order."""
        br = self.branches
        n_loc, per = len(br.local), len(nets) // len(br.local)
        names = list(nets)
        n_par = len(optim["param_groups"][0]["params"]) // n_loc
        # every branch runs the same losses: the same parameters have state
        present = [p for p in range(n_par) if p in optim["state"]]
        opt_keys = list(optim["state"][present[0]]) if present else []
        # one tensor [n_loc, ...] per network entry and per AdamW entry
        net_items = [(k, key) for k in range(per) for key in nets[names[k]]]
        opt_items = [(p, key) for p in present for key in opt_keys]
        local = ([torch.stack([nets[names[j * per + k]][key]
                               for j in range(n_loc)])
                  for k, key in net_items]
                 + [torch.stack([optim["state"][j * n_par + p][key]
                                 for j in range(n_loc)])
                    for p, key in opt_items])
        every = [t.flatten(0, 1) for t in br.gather_many(local)]
        state = {}
        for b in range(br.n_branch):
            for k in range(per):
                ema = _NETWORK_KEY.fullmatch(names[k]).group(2) or ""
                state[f"model{b + 1}{ema}_state"] = {
                    key: t[b].to(nets[names[k]][key].device)
                    for (kk, key), t in zip(net_items, every) if kk == k}
        opt_every = every[len(net_items):]
        state["optim_state"] = {
            "state": {b * n_par + p: {
                key: t[b].to(optim["state"][p][key].device)
                for (pp, key), t in zip(opt_items, opt_every) if pp == p}
                for b in range(br.n_branch) for p in present},
            "param_groups": [dict(g, params=list(range(br.n_branch * n_par)))
                             for g in optim["param_groups"]]}
        return state

    def _local_optimizer_state(self, optim):
        """This rank's share of a checkpoint's ``optim_state`` (one AdamW
        over every branch's students, in branch order): its branches'
        entries, renumbered from 0."""
        if self.branches is None:
            return optim
        local = list(self.branches.local)
        n_par = len(optim["param_groups"][0]["params"]) // \
            self.branches.n_branch
        return {"state": {j * n_par + p: optim["state"][b * n_par + p]
                          for j, b in enumerate(local) for p in range(n_par)
                          if b * n_par + p in optim["state"]},
                "param_groups": [dict(g, params=list(range(len(local)
                                                            * n_par)))
                                 for g in optim["param_groups"]]}

    def _load_optimizer_state(self, optim):
        """Load a checkpoint's optimiser state, keeping this AdamW's own
        ``capturable`` and ``fused`` (the checkpoint carries its writer's:
        a graphed trainer's, or an eager one's); torch then puts each
        ``step`` where this AdamW keeps it, on the card for a graphed
        trainer, as its writer left it (on the host) otherwise."""
        own = self.optimizer.param_groups
        self.optimizer.load_state_dict(dict(optim, param_groups=[
            dict(g, **{k: o[k] for k in ("capturable", "fused") if k in o})
            for g, o in zip(optim["param_groups"], own)]))

    def save(self, base_path, epo, is_best):
        """Write the checkpoint of epoch ``epo`` (rank 0 writes; every rank
        takes part in gathering the pseudo-round state and, branch
        parallel, the branches' state)."""
        extra = {"best_acc": self.best_acc, "best_epoch": self.best_epoch,
                 **self._pseudo_checkpoint_meta()}
        if self.branches is not None or PC.is_writer():
            state = self.checkpoint_state()
        if PC.is_writer():
            save_checkpoint(base_path, epo, state, is_best, extra=extra)

    def resume(self, base_path, best=False):
        """Restore networks, optimiser and counters from ``base_path``;
        returns the epoch to continue from (0 without a checkpoint).  Over
        several processes every rank reads it after a barrier and takes
        its branches' networks and AdamW state."""
        PC.barrier(self.world)
        state, meta = restore_checkpoint(base_path, best=best)
        if state is None:
            return 0
        for key, net in self.networks.items():
            net.load_state_dict(port_state_from_reference(state[key]))
        self._load_optimizer_state(
            self._local_optimizer_state(state["optim_state"]))
        self.step_graph.reset()
        self.best_acc = [float(a) for a in
                         np.atleast_1d(meta.get("best_acc", self.best_acc))]
        self.best_epoch = [int(e) for e in np.atleast_1d(
            meta.get("best_epoch", self.best_epoch))]
        self._restore_pseudo_state(meta)
        return int(meta["current_epoch"]) + 1

    # --------------------------------------------------------- pseudo rounds
    def _ensure_pseudo_loop(self):
        """The PseudoLabelingLoop, built at first use.  It must be built
        while ``train_data`` is pristine: it snapshots the kps / islabeled
        before any injection as its reset baseline."""
        if self._pseudo_loop is None:
            cfg = self.cfg
            self._pseudo_loop = PseudoLabelingLoop(
                self, aug_views=cfg.pseudo_aug_views,
                reliable_pct=cfg.pseudo_reliable_pct,
                batch_size=cfg.infer_bs)
        return self._pseudo_loop

    def _pseudo_checkpoint_meta(self):
        """The pseudo-round state for the checkpoint (host tensors): rounds
        spent, the injected kps / islabeled and the LMA distance histories
        ``[3, N, K, 3]`` (NaN where empty), so a resumed run continues from
        the same dataset and round budget as an uninterrupted one.  Data
        parallel, the ranks' rows of kps / islabeled are gathered (the
        padded arrays, as the JAX package saves its sharded ones)."""
        if self._pseudo_rounds_done == 0:
            return {}
        data = self.train_data
        meta = {"pseudo_rounds_done": self._pseudo_rounds_done,
                "pseudo_kps": PC.all_gather_rows(data.kps, self.group).cpu(),
                "pseudo_islabeled": PC.all_gather_rows(
                    data.islabeled, self.group).cpu()}
        loop = self._pseudo_loop
        if loop is not None and loop.lma_ext is not None:
            meta["pseudo_lma"] = torch.from_numpy(np.stack(
                [loop.lma_int[0].history, loop.lma_int[1].history,
                 loop.lma_ext.history]))
        return meta

    def _restore_pseudo_state(self, meta):
        """Put a checkpoint's pseudo-round state back (regimes without the
        rounds ignore it); a dataset of another (padded) shape raises with
        the JAX package's message.  Each rank takes its own rows."""
        rounds = meta.get("pseudo_rounds_done")
        if not rounds or not self.supports_pseudo_loop:
            return
        kps, islabeled = meta["pseudo_kps"], meta["pseudo_islabeled"]
        data = self.train_data
        have = (data.total,) + tuple(data.kps.shape[1:])
        if tuple(kps.shape) != have or tuple(islabeled.shape) != have[:1]:
            # the padding depends on the mesh (a multiple of its batch
            # axes), so a checkpoint from another device count can carry
            # differently padded arrays
            raise ValueError(
                f"pseudo-state resume: checkpointed kps {tuple(kps.shape)} "
                f"vs dataset {have} — the checkpoint was written with a "
                "different mesh/device count; resume on a matching mesh "
                "(mesh_shape) or restart the pseudo rounds")
        # the loop first: its reset baseline must be the pristine arrays,
        # and train_data is still pristine here
        loop = self._ensure_pseudo_loop()
        self._pseudo_rounds_done = int(rounds)
        rows = slice(data.offset, data.offset + data.kps.shape[0])
        self.train_data = data._replace(
            kps=kps[rows].to(self.device),
            islabeled=islabeled[rows].to(self.device))
        lma = meta.get("pseudo_lma")
        if lma is not None and loop.lma_ext is not None:
            lma = lma.numpy()
            loop.lma_int[0].history = lma[0].copy()
            loop.lma_int[1].history = lma[1].copy()
            loop.lma_ext.history = lma[2].copy()
        self.logger.print(
            "L2", "resumed pseudo-round state: {} round(s) spent, "
            "{} sample(s) in the labeled pool".format(
                self._pseudo_rounds_done, int(islabeled.sum())))

    def maybe_pseudo_round(self, epo, base_path=None):
        """``cfg.pseudo_rounds > 0``: one UBPL selection round every
        ``pseudo_interval`` epochs until the budget is spent (dual-teacher
        regimes only), its audit written to
        ``logs/pseudoRounds/round_{epo + 1}.json``.  Returns the Selection
        or None."""
        cfg = self.cfg
        if not (self.supports_pseudo_loop and cfg.pseudo_rounds > 0):
            return None
        if (epo + 1) % max(cfg.pseudo_interval, 1) != 0:
            return None
        if self._pseudo_rounds_done >= cfg.pseudo_rounds:
            return None
        if not self.unlabeled_idxs:
            return None
        loop = self._ensure_pseudo_loop()
        sel, _ = loop.round(round_draws(cfg.seed, epo, self.device))
        self._pseudo_rounds_done += 1
        n_sel = int(sel.sel_counts[-1])
        self.logger.print(
            "L1", "[pseudo round {}/{}] selected {} kps "
            "(sel acc: {:.4f}, sel err: {:.3f}, thr: {:.4f})".format(
                self._pseudo_rounds_done, cfg.pseudo_rounds, n_sel,
                float(sel.sel_accs[-1]), float(sel.sel_errs[-1]),
                sel.threshold))
        if base_path and PC.is_writer():
            json_save({"epoch": epo + 1, "selected": n_sel,
                       "threshold": sel.threshold,
                       "sel_counts": np.asarray(sel.sel_counts).tolist(),
                       "sel_accs": np.asarray(sel.sel_accs).tolist(),
                       "sel_errs": np.asarray(sel.sel_errs).tolist()},
                      f"{base_path}/logs/pseudoRounds/round_{epo + 1}.json",
                      is_cover=True)
        return sel

    def maybe_debug_draw(self, base_path, epo):
        """``cfg.debug``: dump the augmentation of the first labeled batch
        (up to 4 samples; draws from ``cfg.seed + epo``, apart from the
        training stream) under ``{base_path}/draw`` (reference --debug).
        Data parallel, every rank takes part in the gather and rank 0
        draws."""
        if not (self.cfg.debug and base_path):
            return
        from ..utils.draw import DebugDrawer
        cfg = self.cfg
        idxs = np.asarray(self.labeled_idxs[:min(4, len(self.labeled_idxs))])
        if self.train_data is not None:
            imgs, kps = self.gather_rows(self.train_data, idxs,
                                         ("images", "kps"))
        else:       # stream_data: gather from the host arrays
            i = torch.as_tensor(idxs)
            imgs = self.train_host.images[i].to(self.device)
            kps = self.train_host.kps[i].to(self.device)
        if not PC.is_writer():
            return
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed + epo)
        view = make_view(imgs, kps, torch.zeros(3, device=self.device), cfg,
                         A.draw_augment(len(idxs), gen, self.device))
        DebugDrawer(base_path).dump_view([str(i) for i in idxs], view,
                                         prefix=f"epo{epo + 1}_")

    def run(self, base_path=None, start_epoch=0, resume=False):
        """The epoch loop: debug drawings -> schedules -> train (under a
        profiler trace in the first epoch when ``cfg.profile_dir``) ->
        validate -> a pseudo-label round when one is due -> best tracking
        per head -> checkpoint (with the pseudo-round state) and JSON logs
        under ``base_path`` -> the epoch's log line -> stop here if a
        preemption was requested; then the report.  Returns the per-epoch
        history.  Data parallel, rank 0 alone traces, writes and logs (no
        collective on those paths), and a preemption requested on any rank
        stops every rank after the same checkpoint."""
        cfg = self.cfg
        writer = PC.is_writer()
        if resume and base_path:
            start_epoch = self.resume(base_path)
        history = []
        for epo in range(start_epoch, cfg.epochs):
            epo_tm = datetime.datetime.now()
            self.epoch = epo
            self.maybe_debug_draw(base_path, epo)
            schedules = self.epoch_schedules(epo)
            with trace(cfg.profile_dir, enabled=cfg.profile_dir is not None
                       and epo == start_epoch and writer):
                losses = self.train_epoch(epo, schedules)
            preds, accs, errs = self.validate()
            self.maybe_pseudo_round(epo, base_path)
            is_best = []
            for m in range(len(self.valid_heads)):
                flag = accs[m][-1] > self.best_acc[m]
                is_best.append(flag)
                if flag:
                    self.best_epoch[m], self.best_acc[m] = epo, accs[m][-1]
            if base_path:
                self.save(base_path, epo, is_best[-1])
            if base_path and writer:
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
            if base_path and PC.any_true(self._preemption_requested(),
                                         self.world):
                self.logger.print("L1", "preemption requested — checkpointed "
                                        f"at epoch {epo + 1}; resume with "
                                        "run(resume=True)")
                break
        if base_path and history and writer:
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


def experiment_name(cfg: Config, exp_mark: str):
    return "{}({}_{})_{}_{}".format(
        cfg.data_source, cfg.train_count, cfg.label_ratio, exp_mark,
        datetime.datetime.now().strftime("%Y%m%d%H%M%S"))


def make_experiment(cfg: Config, exp_mark: str, experiment=None):
    """Reference exec(): experiment naming + logger + base path
    (``experiment`` given: that name)."""
    experiment = experiment or experiment_name(cfg, exp_mark)
    base_path = f"{cfg.experiment_root}/{experiment}"
    logger = Logger(experiment, base_path=base_path)
    return experiment, base_path, logger


def regime_mesh(cfg: Config, device=None):
    """The mesh of an entry point: ``parallel.build_mesh`` over the cards
    of this host (over torchrun's world when it started the process).  On
    the CPU (``device="cpu"``) the mesh may ask for as many processes as it
    likes, and ``mesh_shape=None`` runs one process: the JAX package's CPU
    auto-mesh over virtual devices has no counterpart."""
    if under_torchrun():
        n = world_size_from_env()
    elif device is not None and torch.device(device).type == "cpu":
        if cfg.mesh_shape is None:
            return None
        n = None
    else:
        n = local_mesh_size()
    if n is None:
        n = int(np.prod(cfg.mesh_shape))
    return build_mesh(cfg, n)


def _run_rank(ctx, trainer_cls, exp_mark, params, experiment, guard):
    """One rank of ``run_regime``'s data-parallel run (``experiment``
    None under torchrun: rank 0 names the run; ``guard``: install a
    PreemptionGuard, as the launching process has one)."""
    cfg = Config().override(params)
    np.random.seed(cfg.seed)
    if guard:
        PreemptionGuard.get()
    if experiment is None:
        import torch.distributed as dist
        names = [experiment_name(cfg, exp_mark)]
        dist.broadcast_object_list(names, 0)
        experiment = names[0]
    base_path = f"{cfg.experiment_root}/{experiment}"
    logger = (make_experiment(cfg, exp_mark, experiment)[2]
              if PC.is_writer() else None)
    return trainer_cls(cfg, device=ctx.device, logger=logger,
                       mesh=ctx.mesh).run(base_path)


def run_regime(trainer_cls, exp_mark: str, params=None, device=None):
    """Shared exec() body of every regime's entry point: config override,
    experiment naming, the device mesh (``Config.mesh_shape``/
    ``mesh_axes``, ``regime_mesh``), the trainer on ``device`` (None: the
    card) or one trainer per device of the mesh (``parallel.launch``), its
    run.  A mesh of one device trains in this process, as the JAX package's
    one-device mesh is its single-device path.  Returns the history (rank
    0's under torchrun: every rank has the same)."""
    cfg = Config().override(params)
    np.random.seed(cfg.seed)
    mesh = regime_mesh(cfg, device)
    local_branches(mesh, 0, trainer_cls.n_models)   # raises before a launch
    if mesh is None or mesh.size == 1:
        _, base_path, logger = make_experiment(cfg, exp_mark)
        return trainer_cls(cfg, device=device, logger=logger).run(base_path)
    device_type = "cpu" if (device is not None and torch.device(
        device).type == "cpu") else "cuda"
    experiment = None
    if not under_torchrun():
        experiment, _, logger = make_experiment(cfg, exp_mark)
        logger.print("L1", "=> mesh {} over {} devices ({} processes)"
                     .format(mesh.shape, mesh.size, mesh.size))
    guard = PreemptionGuard._installed is not None
    return launch(_run_rank, mesh, device_type,
                  args=(trainer_cls, exp_mark, params, experiment, guard))[0]
