"""The ranks' side of ``tests/test_torch_dp.py`` and
``tests/test_torch_branch.py``: functions that run inside the processes of
a gloo world on the CPU (``ubpl_torch.parallel.launch``).

Each scenario builds the trainer twice in the rank: once on one process
(no mesh: the single-process path, no collective) and once on the world's
mesh, runs both on the same batch and returns small numpy results (the
metrics of both, the largest differences of their parameters, gradients
and BatchNorm statistics, and whether every rank holds rank 0's
parameters), which the tests hold to their tolerances.

The shape is tiny (HG1, 64 -> 16, K=5, a global batch of 4 = 2 unlabeled
+ 2 labeled) and the networks compute in float64: at this size the
train-mode network is ill-conditioned in float32 (ROADMAP C.3), and in
float32 the ranks' partial sums round differently from one process's sum.
``forward_heatmaps`` is replaced by one that keeps float64 (the port's casts
its outputs to float32) so that losses, counts and gradients can be held
to 1e-9.  The batch is the sampler's first: unlabeled rows first, so with
two ranks rank 0 holds only unlabeled rows and rank 1 only labeled ones.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

import ubpl_torch.train.common as C
import ubpl_torch.train.mt_ubpl as MT
import ubpl_torch.train.pseudo_loop as PL
import ubpl_torch.train.supervised as SV
from ubpl_torch.config import Config
from ubpl_torch.data.sampler import supervised_epoch_batches
from ubpl_torch.models.layers import BatchNorm
from ubpl_torch.parallel import collectives as PC
from ubpl_torch.train.base_trainer import synthetic_arrays
from ubpl_torch.train.checkpointing import restore_checkpoint
from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
from ubpl_torch.train.mean_teacher import MeanTeacherTrainer
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
from ubpl_torch.train.supervised import SupervisedTrainer, supervised_step

K, R, OUT = 5, 64, 16
KW = dict(model="HG1", synthetic_data=True, synthetic_kps=K, inp_res=R,
          out_res=OUT, train_count=8, valid_count=7, label_ratio=0.5,
          train_bs=4, train_bs_labeled=2, infer_bs=4,
          compute_dtype="float32", pseudo_score_thr=0.02, seed=3)
#: cons_weight, fdl_weight, pseudo_weight, ema_alpha
SSL_SCHED = (3.0, 0.7, 0.8, 0.5)
TRAINERS = {"mt_ubpl": MTUBPLTrainer, "mt": MeanTeacherTrainer,
            "dualpose_ubpl": DualPoseUBPLTrainer,
            "supervised": SupervisedTrainer}


def forward_float64(model, images, train, compute_dtype, remat=False):
    """``common.forward_heatmaps`` for float64 networks, without the cast
    of its outputs to float32 (``remat`` as there)."""
    import contextlib
    from torch.utils.checkpoint import checkpoint
    model.train(train)
    x = images.double()
    if train and remat:
        out = checkpoint(model, x, use_reentrant=False,
                         context_fn=lambda: (contextlib.nullcontext(),
                                             C._frozen_bn_stats(model)))
    else:
        out = model(x)
    return out if isinstance(out, tuple) else (out, None)


def setup_rank():
    """One torch thread per rank (several pytest workers share the host)
    and the float64 forward everywhere the trainers call it."""
    torch.set_num_threads(1)
    for mod in (C, MT, PL, SV):
        mod.forward_heatmaps = forward_float64


def make(regime, mesh=None, **kw):
    """A trainer on the CPU with float64 networks."""
    tr = TRAINERS[regime](Config(**{**KW, **kw}), device="cpu", mesh=mesh)
    for net in tr.networks.values():
        net.double()
    return tr


def _sched(regime):
    return {"mt": (SSL_SCHED[0], SSL_SCHED[3]), "supervised": ()}.get(
        regime, SSL_SCHED)


def supervised_batches(labeled_idxs, batch_size, seed):
    """The supervised regime's batches of a fresh trainer (its numpy
    generator seeded with ``seed``, as in the JAX package)."""
    return supervised_epoch_batches(labeled_idxs, batch_size,
                                    np.random.default_rng(seed))


def _batches(tr, regime):
    if regime == "supervised":
        return supervised_batches(tr.labeled_idxs, tr.cfg.train_bs,
                                  tr.cfg.seed)
    return list(tr.make_sampler())


def held_by_every_rank(tensors, group):
    """True on every rank of ``group`` when each tensor equals the group's
    first rank's (True without a group)."""
    if group is None:
        return True
    same = True
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, group.ranks[0], group=group.pg)
        same &= bool(torch.equal(ref, t.detach()))
    return not PC.any_true(not same, group)


@torch.no_grad()
def compare_nets(ones, dps):
    """Largest differences between two lists of networks: parameters
    beyond 1e-9 of their size (``param_excess``), the summed gradients
    relative to the network's largest gradient (``grad_rel``), BatchNorm
    running stats relative to the tensor's largest (``stat_rel``)."""
    out = {"param_excess": 0.0, "grad_rel": 0.0, "stat_rel": 0.0}
    for a, b in zip(ones, dps):
        grads = [(p.grad, q.grad) for p, q in zip(a.parameters(),
                                                  b.parameters())
                 if p.grad is not None]
        if grads:
            scale = max(float(g.abs().max()) for g, _ in grads)
            out["grad_rel"] = max(out["grad_rel"], max(
                float((g - h).abs().max()) for g, h in grads) / scale)
        for pa, pb in zip(a.parameters(), b.parameters()):
            d = (pa - pb).abs() - 1e-9 * pa.abs()
            out["param_excess"] = max(out["param_excess"], float(d.max()))
        for (name, sa), sb in zip(a.named_buffers(), b.buffers()):
            if name.endswith(("running_mean", "running_var")):
                out["stat_rel"] = max(out["stat_rel"], float(
                    (sa - sb).abs().max() / sa.abs().max()))
    return out


def _numpy(metrics):
    return {k: v.detach().numpy().copy() for k, v in metrics.items()}


def step(ctx, regime, steps=1, sched=None, **kw):
    """``steps`` training steps of ``regime`` on one process and on the
    world, from the same weights on the same batches (``sched``: the
    schedule's scalars, else the regime's ``SSL_SCHED``).  The world's
    networks are held to one process's of the same name; the ranks that
    should hold the same networks (those of a branch's batch group, or
    the whole world where the branches are not split) to one another."""
    sched = _sched(regime) if sched is None else sched
    one, dp = make(regime, **kw), make(regime, ctx.mesh, **kw)
    batches = _batches(one, regime)[:steps]
    assert [b.tolist() for b in _batches(dp, regime)[:steps]] == \
        [b.tolist() for b in batches]
    m_one = [_numpy(m) for m in one.run_train_steps(batches, *sched)]
    m_dp = [_numpy(m) for m in dp.run_train_steps(batches, *sched)]
    nets = list(dp.networks.values())
    return {"batch": batches[0].tolist(), "one": m_one, "dp": m_dp,
            "islabeled_rows": dp.fetch_batch(dp.train_data, batches[0])[2]
            .tolist() if dp.train_data is not None else None,
            "networks": list(dp.networks),
            **compare_nets([one.networks[k] for k in dp.networks], nets),
            "ranks_equal": held_by_every_rank(
                [t for n in nets for t in n.state_dict().values()],
                dp.group if dp.branches else dp.world)}


def batchnorm(ctx):
    """A BatchNorm alone: each rank normalises its rows of a batch with
    the global statistics; against one process on the whole batch.
    Forward, input gradient, parameter gradients (summed), running stats,
    in train mode and in the ``update_stats=False`` recompute."""
    group = PC.batch_group(ctx.mesh, ctx.device)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.normal(3.0, 2.0, (4, 6, 5, 3)))
    w_out = torch.as_tensor(rng.normal(size=(4, 6, 5, 3)))
    rows = slice(2 * PC.shard(group), 2 * PC.shard(group) + 2)
    out = {}
    for update in (True, False):
        res = []
        for g, xs, ws in ((None, x, w_out), (group, x[rows], w_out[rows])):
            bn = BatchNorm(6).double()
            with torch.no_grad():
                bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
                bn.bias.copy_(torch.linspace(-1, 1, 6))
            bn.group, bn.update_stats = g, update
            xi = xs.clone().requires_grad_(True)
            y = bn(xi)
            (y * ws).sum().backward()
            grads = [bn.weight.grad, bn.bias.grad]
            PC.all_reduce_grads(grads, g)
            res.append((y.detach(), xi.grad, grads,
                        [bn.running_mean.clone(), bn.running_var.clone()]))
        (y1, gx1, gp1, st1), (y2, gx2, gp2, st2) = res
        key = "train" if update else "recompute"
        out[key] = {
            "y": float((y1[rows] - y2).abs().max()),
            "x_grad": float((gx1[rows] - gx2).abs().max()),
            "param_grad": max(float((a - b).abs().max())
                              for a, b in zip(gp1, gp2)),
            "stats": max(float((a - b).abs().max())
                         for a, b in zip(st1, st2)),
            "stats_moved": bool(not torch.equal(st2[0], torch.zeros(6))),
            "scale": float(gx1.abs().max())}
    return out


def dataset(ctx):
    """The sharded dataset (train_count 31, padded to 32 over 2 ranks) and
    ``gather_rows`` against a gather from the host arrays (rows of both
    shards, one twice)."""
    tr = make("mt_ubpl", ctx.mesh, train_count=31)
    host, _, _ = synthetic_arrays(Config(**{**KW, "train_count": 31}))
    data = tr.train_data
    idxs = np.array([30, 0, 17, 15, 16, 3, 17, 29])
    got = tr.gather_rows(data, idxs, ("images", "kps", "kps_test",
                                      "islabeled"))
    want = [host[k][idxs] for k in ("images", "kps", "kps_test",
                                    "islabeled")]
    nbytes = sum(getattr(data, f).numel() * getattr(data, f).element_size()
                 for f in ("images", "kps", "kps_test", "islabeled"))
    return {"rows": data.images.shape[0], "offset": data.offset,
            "total": data.total, "bytes": nbytes,
            "valid_rows": tr.valid_data.images.shape[0],
            "gather_equal": all(np.array_equal(g.numpy(), w)
                                for g, w in zip(got, want))}


def validation(ctx):
    """The three-head validation (7 images in batches of 4: a ragged last
    batch) on one process and split over the world, same weights."""
    one, dp = make("mt_ubpl"), make("mt_ubpl", ctx.mesh)
    return {"one": one.validate(), "dp": dp.validate()}


def pseudo_round(ctx):
    """One UBPL round (``pseudo_rounds=1``) on one process and over the
    world: the teachers' predictions on every unlabeled sample (the
    inference split over the ranks, 7 samples in batches of 4), the
    selection, and the injection.  At 64 px the random-init teachers'
    predictions leave the image, so the round selects nothing; the
    injection is then driven with a fixed selection of every other
    keypoint, and the gathered kps / islabeled of the whole training set
    are compared."""
    out = {}
    for name, mesh in (("one", None), ("dp", ctx.mesh)):
        tr = make("mt_ubpl", mesh, pseudo_rounds=1, pseudo_interval=1,
                  train_count=13)
        sel = tr.maybe_pseudo_round(0)
        loop = tr._pseudo_loop
        ori, augs = loop.predict_all(PL.round_draws(KW["seed"], 1, "cpu"))
        n = len(tr.unlabeled_idxs)
        enable = (np.arange(n * K).reshape(n, K) % 2).astype(np.int32)
        coords = np.random.default_rng(5).uniform(0, R, (n, K, 2))
        loop._apply(np.asarray(tr.unlabeled_idxs), coords, enable)
        data = tr.train_data
        out[name] = {
            "rounds": tr._pseudo_rounds_done,
            "selected": int(sel.sel_counts[-1]), "enable": sel.enable,
            "ori": ori, "augs": augs,
            "kps": PC.all_gather_rows(data.kps, tr.group).numpy(),
            "islabeled": PC.all_gather_rows(data.islabeled,
                                            tr.group).numpy(),
            "rows": data.kps.shape[0]}
    return out


def stream(ctx):
    """Two ``stream_data`` steps over the world against two resident
    ones (same weights, same batches)."""
    res = make("mt_ubpl", ctx.mesh)
    streamed = make("mt_ubpl", ctx.mesh, stream_data=True)
    batches = list(res.make_sampler())[:2]
    m_res = [_numpy(m) for m in res.run_train_steps(batches, *SSL_SCHED)]
    m_str = [_numpy(m) for m in streamed.run_train_steps(batches,
                                                         *SSL_SCHED)]
    return {"resident": m_res, "streamed": m_str,
            "streamed_data": streamed.train_data is None,
            **compare_nets(list(res.networks.values()),
                           list(streamed.networks.values()))}


def checkpoint(ctx, base_dir):
    """One epoch of ``run`` (one step, validation, a pseudo round, the
    checkpoint) over the world, written under ``base_dir``: its files, and
    (rank 0, after the world's run) its keys and values against one
    process's run of the same epoch, and the error of a single-process
    trainer that resumes it.  Five training images: the world pads them
    to 6.  The run directory is removed at the end (a float64 checkpoint
    of two HG1 branches is 160 MB)."""
    import shutil
    kw = dict(epochs=1, pseudo_rounds=1, pseudo_interval=1, train_count=5)
    dp = make("mt_ubpl", ctx.mesh, **kw)
    dp.run(base_dir)
    PC.barrier(dp.group)
    files = sorted(os.listdir(os.path.join(base_dir, "ckpts")))
    if ctx.rank != 0:
        PC.barrier(dp.group)
        return {"files": files}
    one = make("mt_ubpl", **kw)
    one.run()
    s_one = one.checkpoint_state()
    m_one = {"current_epoch": 0, "best_acc": one.best_acc,
             "best_epoch": one.best_epoch, **one._pseudo_checkpoint_meta()}
    s_dp, m_dp = restore_checkpoint(base_dir)
    worst = 0.0
    for key in s_one:
        if key == "optim_state":
            continue
        for name, t in s_one[key].items():
            u = s_dp[key][name]
            worst = max(worst, float((t.double() - u.double()).abs().max()
                                     - 1e-9 * t.double().abs().max()))
    try:
        make("mt_ubpl", **kw).resume(base_dir)
        resume_error = None
    except ValueError as e:
        resume_error = str(e)
    shutil.rmtree(base_dir)
    PC.barrier(dp.group)
    return {"files": files, "keys": (list(s_one), list(s_dp)),
            "net_keys": all(list(s_one[k]) == list(s_dp[k]) for k in s_one
                            if k != "optim_state"),
            "worst": worst, "resume_error": resume_error,
            "meta": ({k: np.asarray(v) for k, v in m_one.items()},
                     {k: np.asarray(v) for k, v in m_dp.items()})}


def preemption(ctx, base_dir):
    """A preemption requested on rank 1 alone, during epoch 1 of 2: every
    rank stops after epoch 1's checkpoint.  Returns the epochs run."""
    import shutil
    from ubpl_torch.utils.preemption import PreemptionGuard
    guard = PreemptionGuard.get()
    tr = make("supervised", ctx.mesh, epochs=2)
    guard.requested = ctx.rank == 1
    try:
        history = tr.run(base_dir)
    finally:
        guard.requested = False
    PC.barrier(tr.group)
    if ctx.rank == 0:
        shutil.rmtree(base_dir)
    return len(history)


def supervised_on_views(ctx, state, views, lr):
    """The supervised step on given views (``views``: NCHW images, heatmaps
    of the global batch, numpy), this rank's rows of them; returns the loss,
    count and (rank 0) the new parameters."""
    group = PC.batch_group(ctx.mesh, ctx.device)
    from ubpl_torch.models import create_pose_model
    from ubpl_torch.models.layers import set_batch_group
    from ubpl_torch.models.weights import load_state
    model = load_state(create_pose_model("HG1", K), state).double()
    set_batch_group(model, group)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=0.0)
    rows = batch_rows_of(group, views["images"].shape[0])
    view = C.ViewBatch(*(None if views.get(f) is None else
                         torch.as_tensor(views[f][rows])
                         for f in C.ViewBatch._fields))
    m = supervised_step(model, opt, view, Config(**KW), group)
    return {"loss": float(m["pec_loss"]), "count": float(m["pec_count"]),
            "params": ({k: v.detach().numpy().copy()
                        for k, v in model.state_dict().items()}
                       if ctx.rank == 0 else None)}


def _state_excess(a, b):
    """Largest difference of two state dicts' tensors beyond 1e-9 of the
    first's largest magnitude, and whether their keys (in order) agree."""
    worst = 0.0
    for name, t in a.items():
        u = b[name]
        worst = max(worst, float((t.double() - u.double()).abs().max()
                                 - 1e-9 * t.double().abs().max()))
    return worst, list(a) == list(b)


def _optim_excess(a, b):
    """``_state_excess`` of two AdamW state dicts: their entries' indices
    and tensors, and their param groups."""
    worst, same = 0.0, list(a["state"]) == list(b["state"]) and \
        a["param_groups"] == b["param_groups"]
    for i, entry in a["state"].items():
        w, same_keys = _state_excess(entry, b["state"][i])
        worst, same = max(worst, w), same and same_keys
    return worst, same


def branch_checkpoint(ctx, base_dir):
    """Checkpoints across the ``model`` axis, both ways.  One epoch of
    ``run`` (one step, validation, a pseudo round, the checkpoint) over the
    world and on one process: the world's file against one process's
    state, key for key (networks and AdamW state).  Then the world's file
    resumed on one process, and one process's file resumed in the world:
    the next step of each (same batch, same augmentation draws) against
    that of one process resumed from its own file (a resume rounds
    float64 weights to float32: ``port_state_from_reference``).  Every
    rank runs the single-process trainers too; the run directories are
    removed at the end."""
    import shutil
    kw = dict(epochs=1, pseudo_rounds=1, pseudo_interval=1, train_count=5)
    world_dir, one_dir = (os.path.join(base_dir, d) for d in ("w", "o"))
    dp = make("mt_ubpl", ctx.mesh, **kw)
    dp.run(world_dir)
    one = make("mt_ubpl", **kw)
    one.run()
    one.save(one_dir, 0, False)         # rank 0 writes
    PC.barrier(dp.world)
    files = sorted(os.listdir(os.path.join(world_dir, "ckpts")))
    s_one, (s_file, meta) = one.checkpoint_state(), restore_checkpoint(
        world_dir)
    out = {"files": files, "keys": (list(s_one), list(s_file)),
           "meta_rounds": int(meta["pseudo_rounds_done"]),
           "net_worst": 0.0, "net_keys": True}
    for key in s_one:
        if key != "optim_state":
            w, same = _state_excess(s_one[key], s_file[key])
            out["net_worst"] = max(out["net_worst"], w)
            out["net_keys"] &= same
    out["optim_worst"], out["optim_layout"] = _optim_excess(
        s_one["optim_state"], s_file["optim_state"])
    resumed = {"one": (make("mt_ubpl", **kw), one_dir),
               "file_on_one": (make("mt_ubpl", **kw), world_dir),
               "one_file_in_world": (make("mt_ubpl", ctx.mesh, **kw),
                                     one_dir)}
    out["resume_epochs"] = [tr.resume(path) for tr, path in resumed.values()]
    batch = list(one.make_sampler())[:1]
    out["steps"] = {}
    for name, (tr, _) in resumed.items():
        tr.generator.manual_seed(17)
        out["steps"][name] = _numpy(tr.run_train_steps(batch, *SSL_SCHED)[0])
    base = resumed["one"][0].networks
    for name in ("file_on_one", "one_file_in_world"):
        nets = resumed[name][0].networks
        out[name] = compare_nets([base[k] for k in nets], list(nets.values()))
    PC.barrier(dp.world)
    if ctx.rank == 0:
        shutil.rmtree(base_dir)
    return out


def mt_ubpl_on_views(ctx, students, teachers, views, islabeled, sched):
    """The MT_UBPL step of the world's branches on given views and states
    (``students``/``teachers``: one state dict per branch, numpy;
    ``views``: NCHW numpy ViewBatch fields of the whole batch, every rank
    holding it whole), with an AdamW over each rank's student.  Returns the
    step's metrics and this rank's networks after it."""
    from ubpl_torch.models import create_pose_model
    from ubpl_torch.models.layers import set_batch_group
    from ubpl_torch.models.weights import load_state
    group = PC.batch_group(ctx.mesh, ctx.device)
    branches = PC.branch_group(ctx.mesh, ctx.device, 2)
    cfg = Config(**{**KW, "model": "HG1"})
    cfg.kps_count = K

    def net(sd):
        model = load_state(create_pose_model("HG1", K), {
            k: torch.as_tensor(v) for k, v in sd.items()}).double()
        return set_batch_group(model, group)
    s = [net(students[b]) for b in branches.local]
    t = [net(teachers[b]).requires_grad_(False) for b in branches.local]
    opt = torch.optim.AdamW([p for m in s for p in m.parameters()],
                            lr=cfg.lr, weight_decay=cfg.wd)
    rows = batch_rows_of(group, views[0]["images"].shape[0])
    view = [C.ViewBatch(*(None if v.get(f) is None else
                          torch.as_tensor(v[f][rows])
                          for f in C.ViewBatch._fields)) for v in views]
    m = MT.mt_ubpl_step(s, t, opt, view, torch.as_tensor(islabeled[rows]),
                        *sched, cfg, group, branches)
    return {"metrics": _numpy(m), "branches": list(branches.local),
            "students": [{k: v.numpy().copy() for k, v in
                          x.state_dict().items()} for x in s],
            "teachers": [{k: v.numpy().copy() for k, v in
                          x.state_dict().items()} for x in t]}


def batch_rows_of(group, n):
    """The rows of an ``n``-row batch that this rank holds."""
    d = PC.size(group)
    return slice(PC.shard(group) * n // d, (PC.shard(group) + 1) * n // d)


def world(ctx, scenarios):
    """Run ``scenarios`` ([(name, function name, kwargs)]) in order;
    returns {name: result} and their seconds under "seconds"."""
    import time
    setup_rank()
    out, seconds = {}, {}
    for name, fn, kw in scenarios:
        t0 = time.perf_counter()
        out[name] = globals()[fn](ctx, **kw)
        seconds[name] = time.perf_counter() - t0
    return {**out, "seconds": seconds}
