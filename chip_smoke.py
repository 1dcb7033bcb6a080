"""Smoke run of the PyTorch port (``ubpl_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Builds every hand-written kernel from the checkout, holds each against its
plain PyTorch version on the card, then drives the port's paths at full
width through their user entry points:

  * serve: ``PoseEstimator`` (HG3, K=9, 256->64, bf16, batch 32) answers
    3 requests of 50 images (ragged last chunk), weights loaded through
    ``models/weights.py`` from a seeded random reference-layout checkpoint;
  * train: ``SupervisedTrainer`` (HG3, K=9, bf16, bs 32, synthetic data)
    takes 8 steps — one heatmap-kernel launch per step — then validates;
  * train_mt_ubpl: ``MTUBPLTrainer`` (HG3, K=9, bf16, bs 32 = 16 unlabeled
    + 16 labeled, two students and two EMA teachers over two views) takes
    the 8 steps of one ``TwoStreamBatchSampler`` epoch — two kernel launches
    per step — then validates its three heads, writes a checkpoint and
    serves it through ``PoseEstimator.from_checkpoint``; a few more steps
    run with ``remat`` for its memory and time;
  * train_mt_ubpl_mld: the same trainer with ``optimizer="mld"`` (two
    pullbacks per step, combined by the MLD surgery): its first step, at
    mld_alpha 0, held to an AdamW trainer's on the same views, then 7 at
    0.5 — two kernel launches per step;
  * train_mt_ubpl_stream: the same shape with ``stream_data`` (pinned host
    arrays, batches copied on a side stream one step ahead): its first step
    held to a resident trainer's, 8 steps, when the copies ran on the
    device clock, and the profile's host-to-device copies with their stream;
  * train_mt: ``MeanTeacherTrainer``, same shape, 4 steps and a validation;
  * data_disk: writes a Mouse tree in the reference layout (320 PNG crops of
    320x240, 9 keypoints each, under ``chiprun_out/smoke_data``, removed at
    the end) with the port's ``write_png``, and times ``get_semi_data`` +
    ``materialize`` and the PNG decode per image;
  * cli_dualpose_ubpl: ``python -m ubpl_torch dualpose_ubpl`` in-process
    (``ubpl_torch.__main__.main``) on that tree: HG3 at its published
    widths, K=9, 256->64, bf16, bs 32 = 16 + 16, 256 training and 64
    validation images, 2 epochs with a profiler trace of the first; two
    heatmap-kernel launches per step, the run's artifacts, and its
    checkpoint served by ``PoseEstimator.from_checkpoint``;
  * cli_mt_ubpl_pseudo: ``python -m ubpl_torch mt_ubpl`` on that tree with
    a UBPL pseudo-label round after each of 2 epochs (128 unlabeled images,
    2 augmented views) and ``optimizer="mld"``, then a third epoch resumed
    from its checkpoint with the pseudo-round state restored exactly; the
    rounds' views skip target synthesis, so only the steps launch the
    kernel;
  * cli_exec_quick: ``python -m ubpl_torch exec --quick`` on the same tree:
    all five regimes, 2 epochs each, HG2 (the depth cut), 24 images;
  * train_classification: ``ClassificationTrainer`` in ``mt_ubpl`` mode,
    ResNet18 at its published widths, bf16, bs 128 = 96 + 32, CIFAR-10's
    shapes (50,000 + 10,000 seeded images), one epoch of 32 steps on a
    4096-image split and a validation over the 10,000 (+profile); then one
    epoch of ``supervised`` x VGG11 and of ``mt`` x MobileNet;
  * classification_fp32: ResNet18 and MobileNet in fp32 on the card
    against the CPU, eval and train mode;
  * litepose: LitePose (K=9, 256x256, bs 32, bf16) eval forward and
    train-mode forward + backward, and an fp32 forward against the CPU;
  * cli_classification: ``python -m ubpl_torch classification
    --mode=mt_ubpl`` on a CIFAR-10 tree in torchvision's layout written
    under ``chiprun_out/smoke_data``, 2 epochs.  The classification and
    LitePose paths launch no heatmap kernel.

The SSL training phases are followed by a ``torch.profiler`` window over a
few more steps (device busy time, idle share, device time by kind).

It also runs the port's HG2 on the reference golden
(``tests/goldens/torch_import_hg2.npz``) in fp32 with TF32 off and holds it
to the reference outputs.  One JSON line per phase; the line before the
last lists every kernel with its launches on the paths, its error against
the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0,
no result line).  Without CUDA it exits 2 before doing anything.

Build outputs (Triton cache, the compiled PNG unfilter, the smoke
checkpoints, the CLI runs and their trace) go to ``.kernel_build/``.
"""
import contextlib
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(REPO, ".kernel_build")
SMOKE_DATA = os.path.join(REPO, "chiprun_out", "smoke_data")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_median_ms(fn, reps=11, inner=50):
    """Median over `reps` CUDA-event windows of `inner` calls, per call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cuda_graph_ms(fn, reps=11, inner=50):
    """Device time per call without the host's launch cost: `inner` calls
    captured in one CUDA graph, median replay time over `reps`, per call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_median_ms(graph.replay, reps, 1) / inner


def phase_env():
    import torch
    import triton
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton.__version__,
          "device": torch.cuda.get_device_name(0)})
    return smi


def phase_kernel_heatmap():
    """Triton heatmap kernel vs its plain version, at the main-path shape
    (B=32, K=9, 256 -> 64) on kps drawn from uniform(-5, 260)."""
    import torch
    from ubpl_torch.ops.heatmap import synthesize_heatmaps as plain
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    B, K, inp, out = 32, 9, 256, 64
    kps = torch.as_tensor(np.random.default_rng(0).uniform(
        -5, 260, (B, K, 3)).astype(np.float32), device="cuda")
    hm_k, kn_k = HS.synthesize_heatmaps(kps, inp, out)
    hm_p, kn_p = plain(kps, inp, out)
    torch.cuda.synchronize()
    err = (hm_k - hm_p).abs().max().item()
    if not err <= 1e-6:
        raise AssertionError(f"heatmap kernel max abs err {err} > 1e-6")
    if not torch.equal(kn_k, kn_p):
        raise AssertionError("heatmap kernel kps_new differs from plain")
    kernel_ms = cuda_median_ms(lambda: HS.synthesize_heatmaps(kps, inp, out))
    plain_ms = cuda_median_ms(lambda: plain(kps, inp, out))
    kernel_graph_ms = cuda_graph_ms(
        lambda: HS.synthesize_heatmaps(kps, inp, out))
    plain_graph_ms = cuda_graph_ms(lambda: plain(kps, inp, out))
    nbytes = 4 * (2 * B * K * 3 + B * K * out * out)
    # per output element: 2 sub, 3 mul, 1 add, exp, compare, min, select
    nops = 10 * B * K * out * out
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": nops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    rec = {"name": HS.NAME, "route": "triton", "source": HS.SOURCE,
           "replaces": HS.REPLACES, "max_abs_err": err, "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": bounds[bound_by],
           "bound_by": bound_by, "library_ms": None}
    emit({"phase": "kernel:heatmap_synth", "shape": [B, K, out, out],
          "max_abs_err": err, "kps_new_equal": True, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "bound_ms": rec["bound_ms"],
          "kernel_graph_ms": kernel_graph_ms, "plain_graph_ms": plain_graph_ms,
          "launches_while_checking": HS.launches})
    return rec


def phase_reference():
    """Port HG2 on the reference golden, fp32, TF32 off: preds and feats
    within rtol 1e-4 / atol 2e-4 of the reference's eval forward."""
    import torch
    from ubpl_torch.models import create_pose_model
    from ubpl_torch.models.weights import load_reference_checkpoint, load_state
    g = np.load(os.path.join(REPO, "tests", "goldens", "torch_import_hg2.npz"))
    sd = {k[4:]: torch.from_numpy(g[k]) for k in g.files
          if k.startswith("sd::")}
    path = os.path.join(BUILD, "golden_hg2.pth.tar")
    torch.save({"model_state": sd}, path)
    model = create_pose_model(f"HG{int(g['n_stack'])}", int(g["k"]))
    load_state(model, load_reference_checkpoint(path)[0])
    model = model.cuda().eval()
    with torch.inference_mode():
        preds, feats = model(torch.as_tensor(g["input"], device="cuda"))
    errs = {}
    for name, got in (("preds", preds), ("feats", feats)):
        ref = g[name]
        got = got.float().cpu().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-4)
        errs[name] = float(np.abs(got - ref).max())
    emit({"phase": "reference", "model": "HG2 golden", "dtype": "float32",
          "max_abs_err": errs})


def phase_serve(counts):
    import torch
    from ubpl_torch.infer import PoseEstimator
    from ubpl_torch.models import create_pose_model
    K, R, n_req, n_img = 9, 256, 3, 50
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1388)
        net = create_pose_model("HG3", K, "AvgPool")
    path = os.path.join(BUILD, "smoke_hg3.pth.tar")
    torch.save({"current_epoch": 0, "model_state": net.state_dict()}, path)
    est = PoseEstimator.from_torch_checkpoint(
        path, model="HG3", kps_count=K, feature_mode="AvgPool",
        means=(0.5, 0.5, 0.5), batch_size=32, device="cuda",
        compute_dtype="bfloat16", inp_res=R, out_res=64)
    rng = np.random.default_rng(7)
    counts.reset()
    lat = []
    for _ in range(n_req):
        imgs = rng.integers(0, 256, (n_img, R, R, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        kps, scores = est.predict(imgs)
        lat.append((time.perf_counter() - t0) * 1e3)
        if kps.shape != (n_img, K, 2) or scores.shape != (n_img, K):
            raise AssertionError(f"serve shapes {kps.shape} {scores.shape}")
        if not (np.isfinite(kps).all() and np.isfinite(scores).all()):
            raise AssertionError("serve produced non-finite values")
    launches = counts.read()
    emit({"phase": "serve", "model": "HG3", "k": K, "inp_res": R,
          "dtype": "bfloat16", "batch_size": 32, "requests": n_req,
          "images_per_request": n_img, "latency_ms": lat,
          "kernel_launches": launches})
    return launches


def train_config(**kw):
    """The full-width training shape: HG3, K=9, 256 -> 64, bf16, bs 32,
    256 synthetic training images."""
    from ubpl_torch.config import Config
    base = dict(model="HG3", synthetic_data=True, synthetic_kps=9,
                inp_res=256, out_res=64, train_count=256, valid_count=64,
                train_bs=32, infer_bs=32, compute_dtype="bfloat16")
    return Config(**{**base, **kw})


def timed_steps(tr, batches, sched, launches_per_step, done=0):
    """Drive `batches` one by one through the trainer's step loop; returns
    (per-step ms, per-step metrics).  Fails unless every step launched the
    heatmap kernel exactly `launches_per_step` times (`done` steps were
    taken since the counts were set to 0)."""
    import torch
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    step_ms, metrics = [], []
    for i, idxs in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.run_train_steps([idxs], *sched)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: v.tolist() for k, v in m.items()})
        if HS.launches != launches_per_step * (done + i + 1):
            raise AssertionError(f"heatmap kernel launched {HS.launches} "
                                 f"times in {done + i + 1} steps")
    return step_ms, metrics


def timed_steps_ms(tr, idxs, sched):
    """Host time of one training step, synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_train_steps([idxs], *sched)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def assert_finite(what, *values):
    for v in values:
        if not np.isfinite(np.asarray(v, np.float64)).all():
            raise AssertionError(f"non-finite {what}: {values}")


def phase_train(counts):
    from ubpl_torch.data.sampler import supervised_epoch_batches
    from ubpl_torch.train.supervised import SupervisedTrainer
    n_steps = 8
    cfg = train_config(label_ratio=1.0)
    tr = SupervisedTrainer(cfg, device="cuda")
    batches = supervised_epoch_batches(tr.labeled_idxs, cfg.train_bs,
                                       tr.rng)[:n_steps]
    if len(batches) != n_steps:
        raise AssertionError(f"only {len(batches)} batches")
    counts.reset()
    step_ms, metrics = timed_steps(tr, batches, (), 1)
    _, accs, errs = tr.validate()
    launches = counts.read()
    losses = [m["pec_loss"] for m in metrics]
    assert_finite("loss/PCK", losses, accs[0], errs[0])
    steady = statistics.median(step_ms[1:])
    emit({"phase": "train", "regime": "supervised", "model": cfg.model,
          "dtype": cfg.compute_dtype, "train_bs": cfg.train_bs,
          "steps": n_steps,
          "step_ms": step_ms, "steady_step_ms_median": steady,
          "images_per_s": cfg.train_bs / steady * 1e3, "pec_loss": losses,
          "valid_pck_mean": accs[0][-1], "kernel_launches": launches})
    profile_steps("train_profile", tr, batches[:3], (), steady)
    return launches


def same_parameters(a, b):
    import torch
    return all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))


def phase_train_mt_ubpl(counts):
    """The flagship regime through its entry points: 8 steps (epoch-1
    schedules, so the consistency weight is on and the EMA weight is 0.5),
    3-head validation, checkpoint, serving of the checkpoint."""
    import torch
    from ubpl_torch.infer import PoseEstimator
    from ubpl_torch.train.checkpointing import save_checkpoint
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    cfg = train_config(label_ratio=0.5, train_bs_labeled=16)
    torch.cuda.reset_peak_memory_stats()
    tr = MTUBPLTrainer(cfg, device="cuda")
    sched = tuple(tr.epoch_schedules(1).values())
    batches = list(tr.make_sampler())
    if len(batches) != 8:
        raise AssertionError(f"{len(batches)} batches in the epoch, not 8")
    pairs = list(zip(tr.students, tr.teachers))
    if not all(same_parameters(s, t) for s, t in pairs):
        raise AssertionError("a teacher does not start as its student")
    counts.reset()
    step_ms, metrics = timed_steps(tr, batches[:1], sched, 2)
    if any(same_parameters(s, t) for s, t in pairs):
        raise AssertionError("EMA teacher still equals its student after "
                             "a step at ema_alpha 0.5")
    more_ms, more = timed_steps(tr, batches[1:], sched, 2, done=1)
    step_ms, metrics = step_ms + more_ms, metrics + more
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, accs, errs = tr.validate()
    launches = counts.read()
    for m in metrics:
        assert_finite("MT_UBPL metric", *m.values())
    assert_finite("PCK", accs, errs)
    if len(accs) != 3 or len(accs[0]) != cfg.kps_count + 1:
        raise AssertionError(f"validation heads {np.shape(accs)}")
    base = os.path.join(BUILD, "smoke_mt_ubpl")
    save_checkpoint(base, 0, tr.checkpoint_state(), True,
                    extra={"best_acc": tr.best_acc,
                           "best_epoch": tr.best_epoch})
    est = PoseEstimator.from_checkpoint(
        base, model=cfg.model, kps_count=cfg.kps_count,
        means=(0.5, 0.5, 0.5), batch_size=32, device="cuda",
        compute_dtype=cfg.compute_dtype,
        inp_res=cfg.inp_res, out_res=cfg.out_res)
    if not same_parameters(est.model, tr.teachers[0]):
        raise AssertionError("from_checkpoint did not serve teacher 1")
    kps, scores = est.predict(tr.valid_data.images[:8].cpu().numpy())
    if kps.shape != (8, cfg.kps_count, 2):
        raise AssertionError(f"served shape {kps.shape}")
    assert_finite("served keypoints", kps, scores)
    steady = statistics.median(step_ms[1:])
    last = metrics[-1]
    emit({"phase": "train_mt_ubpl", "regime": "MT_UBPL", "model": cfg.model,
          "dtype": cfg.compute_dtype, "train_bs": cfg.train_bs,
          "train_bs_labeled": cfg.train_bs_labeled, "views": tr.n_views,
          "remat": cfg.remat, "steps": len(step_ms), "step_ms": step_ms,
          "steady_step_ms_median": steady,
          "images_per_s": cfg.train_bs / steady * 1e3,
          "peak_memory_gb": peak_gb, "schedules": sched,
          "pec": last["pec"], "mtc": last["mtc"], "epc": last["epc"],
          "fdc": last["fdc"], "n_pseudo": last["n_pseudo"],
          "n_sel": last["n_sel"],
          "valid_pck_mean": [a[-1] for a in accs],
          "served_images": 8, "kernel_launches": launches,
          "kernel_launches_per_step": 2})
    profile_steps("train_mt_ubpl_profile", tr, list(tr.make_sampler())[:3],
                  sched, steady)
    phase_remat(tr, sched, steady, peak_gb)
    return launches, steady


def phase_remat(tr, sched, plain_ms, plain_gb):
    """The same trainer with cfg.remat: the students' forwards are
    recomputed in the backward.  Its memory and step time beside the plain
    step's (not part of the counted path)."""
    import torch
    torch.cuda.synchronize()
    tr.optimizer.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr.cfg.remat = True
    step_ms = []
    for idxs in list(tr.make_sampler())[:4]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.run_train_steps([idxs], *sched)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert_finite("MT_UBPL metric with remat",
                      *(v.tolist() for v in m.values()))
    tr.cfg.remat = False
    emit({"phase": "train_mt_ubpl_remat", "steps": len(step_ms),
          "step_ms": step_ms,
          "steady_step_ms_median": statistics.median(step_ms[1:]),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "plain_step_ms": plain_ms, "plain_peak_memory_gb": plain_gb})


def phase_train_mt(counts):
    """Mean teacher: one student, one teacher, two views; 4 steps and a
    validation of its two heads."""
    import torch
    from ubpl_torch.train.mean_teacher import MeanTeacherTrainer
    cfg = train_config(label_ratio=0.5, train_bs_labeled=16)
    torch.cuda.reset_peak_memory_stats()
    tr = MeanTeacherTrainer(cfg, device="cuda")
    sched = tuple(tr.epoch_schedules(1).values())
    batches = list(tr.make_sampler())[:4]
    counts.reset()
    step_ms, metrics = timed_steps(tr, batches, sched, 2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, accs, errs = tr.validate()
    launches = counts.read()
    for m in metrics:
        assert_finite("MT metric", *m.values())
    assert_finite("PCK", accs, errs)
    if len(accs) != 2:
        raise AssertionError(f"validation heads {np.shape(accs)}")
    steady = statistics.median(step_ms[1:])
    emit({"phase": "train_mt", "regime": "MT", "model": cfg.model,
          "dtype": cfg.compute_dtype, "train_bs": cfg.train_bs, "views": 2,
          "steps": len(step_ms), "step_ms": step_ms,
          "steady_step_ms_median": steady,
          "images_per_s": cfg.train_bs / steady * 1e3,
          "peak_memory_gb": peak_gb,
          "pec_loss": [m["pec_loss"] for m in metrics],
          "mtc_loss": [m["mtc_loss"] for m in metrics],
          "valid_pck_mean": [a[-1] for a in accs],
          "kernel_launches": launches, "kernel_launches_per_step": 2})
    return launches


def phase_train_mt_ubpl_mld(counts):
    """MT_UBPL with ``optimizer="mld"``: one forward and two pullbacks per
    step, combined by the MLD surgery.  Its first step, at mld_alpha 0,
    is held to an AdamW trainer's step on the same weights, batch and
    views (the surgery is then the identity on the summed gradient); the
    other 7 run at mld_alpha 0.5; then a profiler window."""
    import torch
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    cfg_kw = dict(label_ratio=0.5, train_bs_labeled=16)
    adam = MTUBPLTrainer(train_config(**cfg_kw), device="cuda")
    tr = MTUBPLTrainer(train_config(optimizer="mld", mld_alpha=0.0, **cfg_kw),
                       device="cuda")
    sched = tuple(tr.epoch_schedules(1).values())
    batches = list(tr.make_sampler())
    if [list(b) for b in batches] != [list(b) for b in adam.make_sampler()]:
        raise AssertionError("the two trainers sample different batches")
    want = {k: v.tolist() for k, v in
            adam.run_train_steps(batches[:1], *sched)[0].items()}
    torch.cuda.synchronize()
    counts.reset()
    step_ms, metrics = timed_steps(tr, batches[:1], sched, 2)
    for key in ("pec", "mtc", "epc", "fdc"):
        np.testing.assert_allclose(metrics[0][key], want[key], rtol=1e-3,
                                   atol=1e-7, err_msg=key)
    lr = tr.cfg.lr
    with torch.no_grad():
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(tr.optimizer.param_groups[0]["params"],
                       adam.optimizer.param_groups[0]["params"]))
    if not diff <= 2.1 * lr:
        raise AssertionError(f"MLD at alpha 0 vs AdamW: params differ by "
                             f"{diff} > 2.1 lr")
    del adam                    # the peak below is the MLD trainer's alone
    torch.cuda.reset_peak_memory_stats()
    tr.cfg.mld_alpha = 0.5
    more_ms, more = timed_steps(tr, batches[1:], sched, 2, done=1)
    step_ms, metrics = step_ms + more_ms, metrics + more
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts.read()
    for m in metrics:
        assert_finite("MLD metric", *m.values())
    steady = statistics.median(step_ms[1:])
    emit({"phase": "train_mt_ubpl_mld", "regime": "MT_UBPL",
          "optimizer": "mld", "mld_alpha": [0.0] + [0.5] * (len(step_ms) - 1),
          "model": tr.cfg.model, "dtype": tr.cfg.compute_dtype,
          "train_bs": tr.cfg.train_bs, "steps": len(step_ms),
          "step_ms": step_ms, "steady_step_ms_median": steady,
          "images_per_s": tr.cfg.train_bs / steady * 1e3,
          "peak_memory_gb": peak_gb,
          "alpha0_vs_adamw": {"losses": {k: [metrics[0][k], want[k]]
                                         for k in ("pec", "mtc", "epc",
                                                   "fdc")},
                              "max_param_diff": diff, "lr": lr},
          "kernel_launches": launches, "kernel_launches_per_step": 2})
    profile_steps("train_mt_ubpl_mld_profile", tr, list(tr.make_sampler())[:3],
                  sched, steady)
    return launches


def stream_profile(tr, batches, sched, step_ms):
    """Profiler window (device activity only) over streamed steps; see
    ``copy_stats``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(BUILD, "stream_trace.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.run_train_steps(batches, *sched)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return copy_stats(events, len(batches), step_ms)


def copy_stats(events, n, step_ms):
    """From a Chrome trace's device events over ``n`` steps: device busy
    time (kernels, copies, memsets) and kernels per step, and the
    host-to-device copies the trace recorded, with their streams, bytes
    and rates.  The card's CUPTI does not record every issued copy (the
    ``cudaMemcpyAsync`` calls are all there), so when the copies ran is
    timed with CUDA events instead (``stream_timeline``)."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if "memcpy" in e.get("cat", "").lower()
              and "HtoD" in e.get("name", "")]
    issued = sum(1 for e in events if e.get("name") == "cudaMemcpyAsync")
    if not kernels or not copies:
        raise AssertionError(f"profile: {len(kernels)} kernels, "
                             f"{len(copies)} HtoD copies")

    def stream(e):
        return e.get("args", {}).get("stream", e.get("tid"))

    compute = statistics.mode(stream(k) for k in kernels)
    copy_streams = {stream(c) for c in copies}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                      "gpu_memset")]
    busy = sum(e["dur"] for e in device) / 1e3 / n
    big = [c for c in copies if c.get("args", {}).get("bytes", 0) >= 1 << 20]
    return {"steps": n, "memcpy_calls": issued,
            "htod_batch_copy_us": [c["dur"] for c in big],
            "htod_batch_copy_gb_s": [c["args"]["bytes"] / c["dur"] / 1e3
                                     for c in big], "device_busy_ms_per_step": busy, "step_ms": step_ms,
            "idle_share": 1 - busy / step_ms,
            "device_kernels_per_step": len(kernels) / n,
            "compute_stream": compute,
            "htod_copies_recorded": len(copies),
            "htod_copy_streams": sorted(copy_streams),
            "htod_copy_names": sorted({c["name"] for c in copies}),
            "htod_recorded_bytes": sum(c.get("args", {}).get("bytes", 0)
                                       for c in copies)}


def stream_timeline(tr, batches, sched):
    """The prefetch on the device clock, with no host sync between steps:
    for each step j, when batch j + 1's copy had finished on the side
    stream, in ms after step j began on the compute stream, beside step
    j's span there (CUDA events recorded after each copy and around each
    step)."""
    import torch
    copies, spans = [], []
    real_put, real_step = tr.streamer.put, tr.train_step

    def event(stream=None):
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    def put(idxs):
        batch = real_put(idxs)
        copies.append(event(tr.streamer.stream))
        return batch

    def step(*args):
        start = event()
        out = real_step(*args)
        spans.append((start, event()))
        return out

    tr.streamer.put, tr.train_step = put, step
    try:
        torch.cuda.synchronize()
        tr.run_train_steps(batches, *sched)
        torch.cuda.synchronize()
    finally:
        del tr.streamer.put, tr.train_step
    return [{"copy_done_ms": s.elapsed_time(copies[j + 1]),
             "step_ms": s.elapsed_time(e)}
            for j, (s, e) in enumerate(spans[:-1])]


def phase_train_mt_ubpl_stream(counts, resident_ms):
    """MT_UBPL with ``stream_data``: the training set in pinned host memory,
    each batch gathered into a pinned staging buffer and copied on a side
    stream one step ahead.  Its first step is held to a resident trainer's
    on the same batch and draws; 8 steps through ``run_train_steps`` (the
    prefetch spans them; the step timer's syncs serialise it), then the
    prefetch on the device clock over 4 steps without syncs, and a
    profiler window over 3 more."""
    import torch
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    cfg_kw = dict(label_ratio=0.5, train_bs_labeled=16)
    resident = MTUBPLTrainer(train_config(**cfg_kw), device="cuda")
    tr = MTUBPLTrainer(train_config(stream_data=True, **cfg_kw),
                       device="cuda")
    if tr.train_data is not None or not tr.train_host.images.is_pinned():
        raise AssertionError("stream_data: the training set is not in "
                             "pinned host memory")
    if tr.streamer.stream == torch.cuda.default_stream():
        raise AssertionError("stream_data copies on the default stream")
    sched = tuple(tr.epoch_schedules(1).values())
    batches = list(tr.make_sampler())
    want = {k: v.tolist() for k, v in
            resident.run_train_steps(batches[:1], *sched)[0].items()}
    del resident
    torch.cuda.synchronize()
    counts.reset()
    with observe(MTUBPLTrainer) as seen:
        metrics = tr.run_train_steps(batches, *sched)
    launches = counts.read()
    metrics = [{k: v.tolist() for k, v in m.items()} for m in metrics]
    for key in ("pec", "mtc", "epc", "fdc"):
        np.testing.assert_allclose(metrics[0][key], want[key], rtol=1e-3,
                                   atol=1e-7, err_msg=key)
    for m in metrics:
        assert_finite("streamed metric", *m.values())
    step_ms = [t for _, t in seen["steps"]]
    if len(step_ms) != 8 or launches[HS.NAME] != 16:
        raise AssertionError(f"{len(step_ms)} steps, {launches[HS.NAME]} "
                             "heatmap launches")
    steady = statistics.median(step_ms[1:])
    timeline = stream_timeline(tr, list(tr.make_sampler())[:5], sched)
    if any(t["copy_done_ms"] > t["step_ms"] for t in timeline):
        raise AssertionError(f"a prefetched copy outlasted its step: "
                             f"{timeline}")
    prof = stream_profile(tr, list(tr.make_sampler())[:3], sched, steady)
    # every copy the trace recorded is from pinned memory, on a stream
    # other than the compute stream (the trace may miss a copy record:
    # on the card's CUPTI some of the issued copies do not appear)
    if prof["htod_copy_streams"] == [] or prof["compute_stream"] in \
            prof["htod_copy_streams"] or any(
                "Pinned" not in name for name in prof["htod_copy_names"]):
        raise AssertionError(f"streamed copies: {prof}")
    emit({"phase": "train_mt_ubpl_stream", "regime": "MT_UBPL",
          "stream_data": True, "model": tr.cfg.model,
          "dtype": tr.cfg.compute_dtype, "train_bs": tr.cfg.train_bs,
          "steps": len(step_ms), "step_ms": step_ms,
          "steady_step_ms_median": steady,
          "resident_steady_step_ms_median": resident_ms,
          "images_per_s": tr.cfg.train_bs / steady * 1e3,
          "first_step_vs_resident": {k: [metrics[0][k], want[k]]
                                     for k in ("pec", "mtc", "epc", "fdc")},
          "batch_bytes": sum(a[0].numel() * a.element_size() * tr.cfg.train_bs
                             for a in tr.train_host),
          "kernel_launches": launches, "kernel_launches_per_step": 2})
    emit({"phase": "train_mt_ubpl_stream_profile", **prof,
          "prefetch_timeline": timeline})
    return launches


def profile_steps(phase, tr, batches, sched, step_ms):
    """torch.profiler over a few more training steps (after the counted
    run): device time per step by kernel and by kind, and the device's idle
    share of the unprofiled step time `step_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run_train_steps(batches, *sched)
        torch.cuda.synchronize()
    n = len(batches)
    # device activity only: user annotations ("Optimizer.step#AdamW.step")
    # also appear on the device timeline, spanning their kernels and the
    # gaps between them.  Kernel names may hold '#' too ("{lambda(float)#1}"),
    # so an annotation is told by its form, not by the '#' alone.
    dev = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not re.fullmatch(r"[\w.]+#[\w.]+", e.key)]
    kinds = {"memcpy_memset": ("memcpy", "memset"),
             "convolution": ("conv", "xmma", "cutlass", "gemm", "cudnn",
                             "implicit"),
             "batchnorm": ("batch_norm",),
             "optimizer_ema": ("multi_tensor", "foreach", "adam"),
             "heatmap_synth": ("heatmap_synth",)}
    by_kind = {k: 0.0 for k in list(kinds) + ["other"]}
    n_copies = 0.0
    for key, ms, count in dev:
        low = key.lower()
        kind = next((k for k, pats in kinds.items()
                     if any(p in low for p in pats)), "other")
        by_kind[kind] += ms
        n_copies += count if kind == "memcpy_memset" else 0
    busy_ms = sum(d[1] for d in dev)
    top = sorted(dev, key=lambda d: -d[1])[:12]
    emit({"phase": phase, "steps": n,
          "device_busy_ms_per_step": busy_ms, "step_ms": step_ms,
          "idle_share": (1 - busy_ms / step_ms) if busy_ms else None,
          "device_kernels_per_step": sum(d[2] for d in dev) - n_copies,
          "device_copies_memsets_per_step": n_copies,
          "device_ms_per_step_by_kind": by_kind,
          "top_kernels_ms_per_step": [[k[:100], t, c] for k, t, c in top]})

def make_mouse_tree(root, n=320, w=320, h=240, k=9, seed=0):
    """A Mouse dataset in the reference layout under ``root``:
    pose/mouse/croppeds_bbox/{labels_normal.json, images/*.png}; smooth
    synthetic crops with mild noise, keypoints inside the image."""
    from ubpl_torch.data.native_io import write_png
    base = os.path.join(root, "pose", "mouse", "croppeds_bbox")
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    anns = []
    for i in range(n):
        phase = rng.uniform(0, 6.3, 3)
        img = np.stack([96 + 64 * np.sin(xx / (17 + 3 * c) + phase[c])
                        + 48 * np.cos(yy / (11 + 2 * c)) for c in range(3)],
                       -1) + rng.integers(0, 8, (h, w, 3))
        write_png(os.path.join(base, "images", f"im{i:04d}.png"),
                  np.clip(img, 0, 255).astype(np.uint8))
        anns.append({"imageID": f"im{i:04d}",
                     "kps": np.stack([rng.uniform(4, w - 4, k),
                                      rng.uniform(4, h - 4, k)], -1).tolist()})
    with open(os.path.join(base, "labels_normal.json"), "w") as f:
        json.dump(anns, f)


def phase_data_disk():
    """Write the smoke's Mouse tree, then time the data layer on it: the
    PNG decode per image (compiled unfilter; the plain Python version on a
    few images) and get_semi_data + materialize of the 256 + 64 split."""
    from ubpl_torch.data import native_io as N
    from ubpl_torch.data.arrays import materialize
    from ubpl_torch.data.sources import get_datasource
    shutil.rmtree(SMOKE_DATA, ignore_errors=True)
    t0 = time.perf_counter()
    make_mouse_tree(SMOKE_DATA)
    write_s = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(
        SMOKE_DATA, "pose", "mouse", "croppeds_bbox", "images", "*.png")))
    compiled = N._build_unfilter() is not None
    if not compiled:
        raise AssertionError("no C++ compiler for the PNG unfilter")
    t0 = time.perf_counter()
    for p in paths:
        img = N.imread_bgr(p)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    if img.shape != (240, 320, 3):
        raise AssertionError(f"decoded shape {img.shape}")
    lib, N._lib = N._lib, False          # the plain Python unfilter
    try:
        t0 = time.perf_counter()
        for p in paths[:4]:
            plain = N.imread_bgr(p)
        plain_ms = (time.perf_counter() - t0) * 1e3 / 4
    finally:
        N._lib = lib
    if not np.array_equal(plain, N.imread_bgr(paths[3])):
        raise AssertionError("plain and compiled PNG unfilter differ")
    cache = os.path.join(BUILD, "smoke_cache")
    shutil.rmtree(cache, ignore_errors=True)
    t0 = time.perf_counter()
    ds = get_datasource("Mouse", data_root=SMOKE_DATA, cache_dir=cache,
                        seed=1388)
    semi = ds.get_semi_data(256, 64, 0.5)
    t1 = time.perf_counter()
    arrays = [materialize(r, 256, 16, ds.image_cache)
              for r in (semi.semi_train, semi.valid)]
    t2 = time.perf_counter()
    n = sum(len(a.images) for a in arrays)
    if n != 320 or arrays[0].images.shape[1:] != (256, 256, 3):
        raise AssertionError(f"materialized {n} images")
    xy = arrays[0].kps_test[..., :2]
    if not (0 < xy.min() and xy.max() < 256):
        raise AssertionError("resized keypoints leave the image")
    emit({"phase": "data_disk", "images": n, "image_wh": [320, 240],
          "write_s": write_s, "png_decode_ms_per_image": decode_ms,
          "png_decode_plain_ms_per_image": plain_ms,
          "unfilter_compiled": compiled,
          "get_semi_data_ms": (t1 - t0) * 1e3,
          "materialize_ms": (t2 - t1) * 1e3,
          "load_ms_per_image": (t2 - t0) * 1e3 / n,
          "means": semi.means, "stds": semi.stds})


@contextlib.contextmanager
def observe(*classes, method="train_step"):
    """Wrap each class's ``method`` (by default ``train_step``): the host
    time of every call, synchronised before and after, its result, and the
    last trainer seen."""
    import torch
    seen = {"steps": [], "results": [], "trainer": None}
    real = {cls: cls.__dict__.get(method) for cls in classes}

    def wrap(cls, fn):
        def timed(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kw)
            torch.cuda.synchronize()
            seen["steps"].append((getattr(cls, "regime", cls.__name__),
                                  (time.perf_counter() - t0) * 1e3))
            seen["results"].append(out)
            seen["trainer"] = self
            return out
        return timed

    for cls, fn in real.items():
        setattr(cls, method, wrap(cls, fn or getattr(cls, method)))
    try:
        yield seen
    finally:
        for cls, fn in real.items():
            if fn is None:
                delattr(cls, method)
            else:
                setattr(cls, method, fn)


def cli_run_dir(root):
    (path,) = glob.glob(os.path.join(root, "*"))
    return path


def phase_cli_dualpose_ubpl(counts):
    """This slice's path through the user's entry point, at full width on
    the smoke's Mouse tree: 2 epochs of DualPose_UBPL (8 steps each), the
    first under the run's own profiler trace."""
    import torch
    from ubpl_torch.__main__ import main
    from ubpl_torch.infer import PoseEstimator
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
    exp = os.path.join(BUILD, "cli_dualpose_ubpl")
    trace_dir = os.path.join(BUILD, "cli_dualpose_ubpl_trace")
    for d in (exp, trace_dir):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["dualpose_ubpl", "--data_source=Mouse",
            f"--data_root={SMOKE_DATA}", "--train_count=256",
            "--valid_count=64", "--label_ratio=0.5", "--train_bs=32",
            "--train_bs_labeled=16", "--infer_bs=32", "--model=HG3",
            "--epochs=2", "--compute_dtype=bfloat16",
            f"--experiment_root={exp}", f"--profile_dir={trace_dir}",
            f"--cache_dir={os.path.join(BUILD, 'smoke_cache')}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    with observe(DualPoseUBPLTrainer) as seen:
        rc = main(argv)
    run_s = time.perf_counter() - t0
    launches = counts.read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    step_ms = [t for _, t in seen["steps"]]
    if len(step_ms) != 16:
        raise AssertionError(f"{len(step_ms)} steps, not 2 epochs of 8")
    if launches[HS.NAME] != 2 * len(step_ms):
        raise AssertionError(f"heatmap kernel launched {launches[HS.NAME]} "
                             f"times in {len(step_ms)} steps")
    base = cli_run_dir(exp)
    for rel in ("ckpts/checkpoint.pth.tar", "ckpts/checkpoint_best.pth.tar",
                "logs/args.json", "logs/logData/logData_1.json",
                "logs/logData/logData_2.json", "logs/report.csv"):
        if not os.path.isfile(os.path.join(base, rel)):
            raise AssertionError(f"missing artifact {rel}")
    logs = []
    for e in (1, 2):
        with open(os.path.join(base, f"logs/logData/logData_{e}.json")) as f:
            logs.append(json.load(f))
    for log in logs:
        assert_finite("logged loss/PCK", *log.values())
    traces = glob.glob(os.path.join(trace_dir, "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"{len(traces)} trace files")
    tr = seen["trainer"]
    cfg = tr.cfg
    est = PoseEstimator.from_checkpoint(
        base, model=cfg.model, kps_count=cfg.kps_count,
        means=tuple(tr.means.tolist()), batch_size=32,
        compute_dtype=cfg.compute_dtype, inp_res=cfg.inp_res,
        out_res=cfg.out_res)
    kps, scores = est.predict(tr.valid_data.images[:8].cpu().numpy())
    if kps.shape != (8, cfg.kps_count, 2):
        raise AssertionError(f"served shape {kps.shape}")
    assert_finite("served keypoints", kps, scores)
    steady = statistics.median(step_ms[9:])     # epoch 2: no trace
    # the same trainer once more, outside main(): 8 steps of a fresh epoch
    # (not counted as the path's launches; the profile window follows)
    sched = tuple(tr.epoch_schedules(1).values())
    more = [timed_steps_ms(tr, batch, sched)
            for batch in list(tr.make_sampler())[:8]]
    emit({"phase": "cli_dualpose_ubpl", "regime": "DualPose_UBPL",
          "model": cfg.model, "dtype": cfg.compute_dtype,
          "train_bs": cfg.train_bs, "train_bs_labeled": cfg.train_bs_labeled,
          "inp_res": cfg.inp_res, "out_res": cfg.out_res,
          "kps": cfg.kps_count, "train_count": cfg.train_count,
          "valid_count": cfg.valid_count, "epochs": cfg.epochs,
          "run_s": run_s, "step_ms": step_ms,
          "steady_step_ms_median": steady,
          "images_per_s": cfg.train_bs / steady * 1e3,
          "after_run_step_ms": more,
          "after_run_steady_step_ms_median": statistics.median(more[1:]),
          "peak_memory_gb": peak_gb,
          "trace_mb": os.path.getsize(traces[0]) / 1e6,
          "losses": {k: v for k, v in logs[-1].items()
                     if k not in ("accs", "errs")},
          "valid_pck_mean": [a[-1] for a in logs[-1]["accs"]],
          "served_images": 8, "kernel_launches": launches,
          "kernel_launches_per_step": 2})
    profile_steps("cli_dualpose_ubpl_profile", tr,
                  list(tr.make_sampler())[:3], sched, steady)
    return launches


def phase_cli_mt_ubpl_pseudo(counts):
    """The UBPL workflow through the user's entry point on the smoke's Mouse
    tree: ``python -m ubpl_torch mt_ubpl`` with a pseudo-label round after
    each of 2 epochs and the MLD optimiser, HG3 at its published widths,
    bf16, bs 32 = 16 + 16, 256 training images (128 unlabeled) and 64
    validation images; then a third epoch resumed from its checkpoint,
    which must restore the pseudo-round state exactly."""
    import torch
    from ubpl_torch.__main__ import main, parse_overrides
    from ubpl_torch.config import Config
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    exp = os.path.join(BUILD, "cli_mt_ubpl_pseudo")
    shutil.rmtree(exp, ignore_errors=True)
    argv = ["mt_ubpl", "--data_source=Mouse", f"--data_root={SMOKE_DATA}",
            "--train_count=256", "--valid_count=64", "--label_ratio=0.5",
            "--train_bs=32", "--train_bs_labeled=16", "--infer_bs=32",
            "--model=HG3", "--epochs=2", "--compute_dtype=bfloat16",
            "--pseudo_rounds=2", "--pseudo_interval=1",
            "--pseudo_aug_views=2", "--optimizer=mld",
            f"--experiment_root={exp}",
            f"--cache_dir={os.path.join(BUILD, 'smoke_cache')}"]
    torch.cuda.synchronize()
    counts.reset()
    t0 = time.perf_counter()
    with observe(MTUBPLTrainer) as seen, \
            observe(MTUBPLTrainer, method="maybe_pseudo_round") as rounds:
        rc = main(argv)
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    tr = seen["trainer"]
    step_ms = [t for _, t in seen["steps"]]
    round_ms = [t for (_, t), sel in zip(rounds["steps"], rounds["results"])
                if sel is not None]
    if len(step_ms) != 16 or len(round_ms) != 2:
        raise AssertionError(f"{len(step_ms)} steps, {len(round_ms)} rounds")
    base = cli_run_dir(exp)
    logs = []
    for e in (1, 2):
        with open(os.path.join(base, "logs", "pseudoRounds",
                               f"round_{e}.json")) as f:
            logs.append(json.load(f))
    unl = tr.unlabeled_idxs
    flipped = int(tr.train_data.islabeled[unl].sum())
    injected = int((tr.train_data.kps[unl, :, 2] > 0).sum())
    selected = logs[-1]["selected"]
    if tr._pseudo_rounds_done != 2 or injected != selected or (
            (selected > 0) != (flipped > 0)):
        raise AssertionError(f"rounds {tr._pseudo_rounds_done}, selected "
                             f"{selected}, injected {injected}, flipped "
                             f"{flipped}")
    # a third epoch, resumed: the pseudo state comes back exactly
    params = parse_overrides(argv[1:])
    params["epochs"] = 3
    resumed = MTUBPLTrainer(Config().override(params), device="cuda",
                            logger=tr.logger)
    with observe(MTUBPLTrainer) as more:
        history = resumed.run(base, resume=True)
    launches = counts.read()
    a, b = resumed._pseudo_loop, tr._pseudo_loop
    same = (resumed._pseudo_rounds_done == 2 and len(history) == 1
            and torch.equal(resumed.train_data.kps, tr.train_data.kps)
            and torch.equal(resumed.train_data.islabeled,
                            tr.train_data.islabeled)
            and all(np.array_equal(x.history, y.history, equal_nan=True)
                    for x, y in zip(a.lma_int + [a.lma_ext],
                                    b.lma_int + [b.lma_ext])))
    if not same:
        raise AssertionError("resume did not restore the pseudo state")
    n_steps = len(step_ms) + len(more["steps"])
    if launches[HS.NAME] != 2 * n_steps:
        raise AssertionError(f"heatmap kernel launched {launches[HS.NAME]} "
                             f"times in {n_steps} steps")
    assert_finite("resumed epoch", *history[0].values())
    emit({"phase": "cli_mt_ubpl_pseudo", "regime": "MT_UBPL",
          "optimizer": "mld", "model": tr.cfg.model,
          "dtype": tr.cfg.compute_dtype, "train_bs": tr.cfg.train_bs,
          "train_count": tr.cfg.train_count, "unlabeled": len(unl),
          "valid_count": tr.cfg.valid_count, "aug_views": 2,
          "run_s": run_s, "step_ms": step_ms,
          "steady_step_ms_median": statistics.median(step_ms[9:]),
          "round_ms": round_ms,
          "round_ms_per_image": [t / len(unl) for t in round_ms],
          "rounds": [{k: r[k] for k in ("epoch", "selected", "threshold")}
                     for r in logs],
          "flipped_samples": flipped, "injected_joints": injected,
          "resumed_epochs": len(history),
          "resumed_step_ms": [t for _, t in more["steps"]],
          "kernel_launches": launches, "kernel_launches_per_step": 2,
          "round_kernel_launches": 0})
    return launches


def phase_cli_exec_quick(counts):
    """``exec --quick``: every CLI regime once on the card (HG2, 2 epochs,
    24 training images at the source's 256 -> 64)."""
    import torch
    from ubpl_torch.__main__ import main
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
    from ubpl_torch.train.mean_teacher import MeanTeacherTrainer
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    from ubpl_torch.train.supervised import SupervisedTrainer
    exp = os.path.join(BUILD, "cli_exec_quick")
    shutil.rmtree(exp, ignore_errors=True)
    counts.reset()
    t0 = time.perf_counter()
    with observe(SupervisedTrainer, MeanTeacherTrainer, MTUBPLTrainer,
                 DualPoseUBPLTrainer) as seen:
        rc = main(["exec", "--quick", f"--data_root={SMOKE_DATA}",
                   f"--experiment_root={exp}",
                   f"--cache_dir={os.path.join(BUILD, 'smoke_cache')}"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts.read()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    runs = sorted(os.listdir(exp))
    if len(runs) != 5:
        raise AssertionError(f"{len(runs)} runs: {runs}")
    per_regime = {}
    for regime, ms in seen["steps"]:
        per_regime.setdefault(regime, []).append(ms)
    want = sum(len(v) * (1 if r == "Supervised" else 2)
               for r, v in per_regime.items())
    if launches[HS.NAME] != want or want == 0:
        raise AssertionError(f"heatmap kernel launched {launches[HS.NAME]} "
                             f"times, expected {want}")
    results = {}
    for run in runs:
        base = os.path.join(exp, run)
        with open(os.path.join(base, "logs", "logData", "logData_2.json")) as f:
            log = json.load(f)
        assert_finite(f"{run} logged loss/PCK", *log.values())
        if not os.path.isfile(os.path.join(base, "logs", "report.csv")):
            raise AssertionError(f"{run}: no report")
        results[run.rsplit("_", 1)[0]] = [a[-1] for a in log["accs"]]
    emit({"phase": "cli_exec_quick", "runs": len(runs), "run_s": run_s,
          "steps": {r: len(v) for r, v in per_regime.items()},
          "median_step_ms": {r: statistics.median(v)
                             for r, v in per_regime.items()},
          "valid_pck_mean": results, "kernel_launches": launches})
    return launches


# ------------------------------------------------- classification, LitePose
class ClassSteps:
    """``run_train_steps`` over a ClassificationTrainer's ``train_step``
    (the interface ``profile_steps`` drives)."""

    def __init__(self, tr):
        self.tr = tr

    def run_train_steps(self, batches, *sched):
        return [self.tr.train_step(idxs, *sched) for idxs in batches]


def cifar_like(n_train, n_valid, seed=0):
    """uint8 32x32x3 images and labels of 10 classes, from the seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n_train, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, n_train),
            rng.integers(0, 256, (n_valid, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, n_valid))


def class_epoch(mode, model, arrays, phase, counts, **kw):
    """One epoch of ``ClassificationTrainer(mode)`` on ``arrays`` under the
    epoch-1 schedules (EMA weight 0.5), each step timed; then checks: the
    mode's losses finite, no heatmap kernel launched, every EMA teacher
    apart from its student, and a validation accuracy in [0, 1].  Returns
    (trainer, step ms, losses, accuracy, validation ms, the epoch's peak
    GB)."""
    import torch
    from ubpl_torch.config import Config
    from ubpl_torch.data.cifar import CIFAR10Data
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.train.classification import ClassificationTrainer
    cfg = Config(**{**dict(model=model, data_source="cifar10",
                           feature_mode="AvgPool", compute_dtype="bfloat16",
                           label_ratio=0.25, train_bs=128,
                           train_bs_labeled=32, infer_bs=500,
                           cache_dir=os.path.join(BUILD, "smoke_cache",
                                                  phase)), **kw})
    tr = ClassificationTrainer(cfg, mode, datasource=CIFAR10Data.from_arrays(
        *arrays, cache_dir=cfg.cache_dir, seed=cfg.seed), device="cuda")
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    with observe(ClassificationTrainer) as seen:
        losses = tr.train_epoch(1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = tr.validate()
    valid_ms = (time.perf_counter() - t0) * 1e3
    if counts.read()[HS.NAME] != 0:
        raise AssertionError(f"{phase}: the heatmap kernel was launched")
    keys = {"supervised": {"ce"}, "mt": {"ce", "cons"},
            "mt_ubpl": {"ce", "cons", "pseudo", "fdl"}}[mode]
    if set(losses) != keys:
        raise AssertionError(f"{phase}: losses {sorted(losses)}")
    for m in seen["results"]:
        assert_finite(f"{phase} step metric", *(v.item() for v in m.values()))
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"{phase}: accuracy {acc}")
    if any(same_parameters(s, t) for s, t in zip(tr.students, tr.teachers)):
        raise AssertionError(f"{phase}: a teacher equals its student")
    return tr, [t for _, t in seen["steps"]], losses, acc, valid_ms, peak_gb


def phase_train_classification(counts):
    """The classification branch at full width: ResNet18 (published
    widths) in ``mt_ubpl`` mode (two students, two EMA teachers, AvgPool
    feature tap), bf16, bs 128 = 96 unlabeled + 32 labeled, on CIFAR-10's
    shapes: 50,000 + 10,000 seeded images, a 4096-image training split at
    label ratio 0.25 (one epoch: 32 steps) and all 10,000 validation
    images; then a profiler window over 3 more steps.  Then one epoch of
    ``supervised`` x VGG11 and of ``mt`` x MobileNet at 1024 images, so
    that every family and mode runs on the card."""
    import torch
    from ubpl_torch.data.sampler import TwoStreamBatchSampler
    from ubpl_torch.train import schedules as S
    arrays = cifar_like(50000, 10000)
    tr, step_ms, losses, acc, valid_ms, peak_gb = class_epoch(
        "mt_ubpl", "ResNet", arrays, "train_classification", counts,
        train_count=4096, valid_count=10000)
    if len(step_ms) != 32:
        raise AssertionError(f"{len(step_ms)} steps, not 32")
    steady = statistics.median(step_ms[1:])
    emit({"phase": "train_classification", "mode": "mt_ubpl",
          "model": "ResNet18", "dtype": tr.cfg.compute_dtype,
          "train_bs": tr.cfg.train_bs,
          "train_bs_labeled": tr.cfg.train_bs_labeled,
          "dataset_images": len(arrays[0]) + len(arrays[2]),
          "train_count": tr.cfg.train_count,
          "valid_count": tr.cfg.valid_count,
          "bytes_on_card": sum(t.numel() * t.element_size() for t in (
              tr.train_images, tr.valid_images)),
          "steps": len(step_ms), "step_ms": step_ms,
          "steady_step_ms_median": steady,
          "images_per_s": tr.cfg.train_bs / steady * 1e3,
          "peak_memory_gb": peak_gb, "losses": losses, "valid_acc": acc,
          "valid_ms": valid_ms, "kernel_launches": counts.read()})
    cfg = tr.cfg
    sched = (S.cons_weight(1, cfg.cons_weight_max, cfg.cons_weight_min,
                           cfg.cons_weight_rampup),
             S.pseudo_weight(1, cfg.pseudo_weight_max, cfg.pseudo_weight_min,
                             cfg.pseudo_weight_rampup), S.ema_alpha(1))
    batches = list(TwoStreamBatchSampler(
        tr.unlabeled_idxs, tr.labeled_idxs, cfg.train_bs,
        cfg.train_bs_labeled, tr.rng))[:3]
    profile_steps("train_classification_profile", ClassSteps(tr), batches,
                  sched, steady)
    del tr
    torch.cuda.empty_cache()
    small = cifar_like(1024, 1000, seed=1)
    for mode, model in (("supervised", "VGG"), ("mt", "MobileNet")):
        tr, step_ms, losses, acc, valid_ms, _ = class_epoch(
            mode, model, small, f"train_classification_{mode}", counts,
            train_count=1024, valid_count=1000)
        emit({"phase": f"train_classification_{mode}", "mode": mode,
              "model": tr.cfg.model, "steps": len(step_ms),
              "step_ms": step_ms, "losses": losses, "valid_acc": acc,
              "valid_ms": valid_ms})
    return counts.read()


def close_on_cpu(what, net, x, train, rtol=1e-4, atol=1e-4):
    """The same module with the same weights on the card (fp32, TF32 off)
    and on the CPU: every output within rtol / atol.  Returns the max abs
    difference."""
    import copy
    import torch
    outs = []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(net).to(dev).train(train)
        with torch.no_grad():
            out = m(x.to(dev))
        outs.append([o.float().cpu().numpy() for o in flatten(out)])
    err = 0.0
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)
        err = max(err, float(np.abs(a - b).max()))
    return err


def flatten(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flatten(o)]
    return [out]


def phase_classification_fp32():
    """ResNet18 and MobileNet (AvgPool tap), eval and train-mode forwards
    of 32 images in fp32 with TF32 off on the card, against the same
    module with the same weights on the CPU: logits and features within
    rtol 1e-4 / atol 1e-4."""
    import torch
    from ubpl_torch.models import create_class_model
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (32, 3, 32, 32)).astype(np.float32))
    errs = {}
    for model in ("ResNet", "MobileNet"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1388)
            net = create_class_model(model, 10, "AvgPool")
        for train in (False, True):
            errs[f"{model}-{'train' if train else 'eval'}"] = close_on_cpu(
                model, net, x, train)
    emit({"phase": "classification_fp32", "dtype": "float32",
          "batch": 32, "max_abs_err": errs})


def phase_litepose():
    """LitePose (K=9, AvgPool tap) at 256x256, bs 32, bf16 on the card: an
    eval forward and a train-mode forward + backward, timed; the output
    shapes [32, 9, 64, 64], [32, 9, 128, 128] and the feature
    [32, 1, 9, 32, 32], all finite; then an fp32 eval forward of 4 images
    held to the CPU's with the same weights (rtol 1e-4 / atol 1e-4)."""
    import torch
    from ubpl_torch.device import autocast
    from ubpl_torch.models import create_pose_model, param_count
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1388)
        net = create_pose_model("LitePose", 9, "AvgPool")
    net = net.to("cuda", memory_format=torch.channels_last)
    x = torch.as_tensor(np.random.default_rng(3).uniform(
        -0.5, 0.5, (32, 3, 256, 256)).astype(np.float32), device="cuda")
    x = x.contiguous(memory_format=torch.channels_last)
    dev = torch.device("cuda")

    def forward(train):
        net.train(train)
        with autocast(dev, "bfloat16"):
            return net(x)

    with torch.no_grad():
        (o1, o2), feat = forward(False)
    shapes = [list(t.shape) for t in (o1, o2, feat)]
    if shapes != [[32, 9, 64, 64], [32, 9, 128, 128], [32, 1, 9, 32, 32]]:
        raise AssertionError(f"LitePose shapes {shapes}")
    assert_finite("LitePose outputs", *(t.float().cpu().numpy()
                                        for t in (o1, o2, feat)))

    def train_step():
        (a, b), f = forward(True)
        (a.float().square().mean() + b.float().square().mean()
         + f.float().mean()).backward()

    train_step()
    grads = [p.grad for p in net.parameters()]
    if any(g is None for g in grads):
        raise AssertionError("a LitePose parameter got no gradient")
    assert_finite("LitePose gradients", *(g.float().norm().item()
                                          for g in grads))
    with torch.no_grad():
        eval_ms = cuda_median_ms(lambda: forward(False), reps=5, inner=5)
    train_ms = cuda_median_ms(train_step, reps=5, inner=3)
    err = close_on_cpu("LitePose fp32", net, x[:4], False)
    emit({"phase": "litepose", "k": 9, "inp_res": 256, "batch": 32,
          "dtype": "bfloat16", "params": param_count(net),
          "shapes": shapes, "eval_forward_ms": eval_ms,
          "train_forward_backward_ms": train_ms,
          "fp32_vs_cpu_max_abs_err": err})


def write_cifar10_tree(root, per_file=1000, seed=0):
    """CIFAR-10 in torchvision's layout under ``root``:
    cifar10(Classification)/data/cifar-10-batches-py/data_batch_1..5 and
    test_batch, ``per_file`` seeded images each (uint8 [N, 3072] CHW rows
    under b"data", labels under b"labels")."""
    import pickle
    base = os.path.join(root, "cifar10(Classification)", "data",
                        "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (per_file, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, per_file).tolist()},
                        f)


def phase_cli_classification(counts):
    """``python -m ubpl_torch classification --mode=mt_ubpl --model=VGG``
    in-process on a CIFAR-10 tree in torchvision's layout (6 x 1,000
    seeded images): 2048 training images at label ratio 0.25, 1,000
    validation images, 2 epochs of 16 steps; exit 0,
    logs/classification.json with two history entries, the split cache."""
    import torch
    from ubpl_torch.__main__ import main
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.train.classification import ClassificationTrainer
    write_cifar10_tree(SMOKE_DATA)
    exp = os.path.join(BUILD, "cli_classification")
    cache = os.path.join(BUILD, "smoke_cache", "cli_classification")
    shutil.rmtree(exp, ignore_errors=True)
    shutil.rmtree(cache, ignore_errors=True)
    counts.reset()
    t0 = time.perf_counter()
    with observe(ClassificationTrainer) as seen:
        rc = main(["classification", "--mode=mt_ubpl", "--model=VGG",
                   "--data_source=cifar10", f"--data_root={SMOKE_DATA}",
                   "--train_count=2048", "--valid_count=1000",
                   "--label_ratio=0.25", "--train_bs=128",
                   "--train_bs_labeled=32", "--epochs=2",
                   f"--experiment_root={exp}", f"--cache_dir={cache}"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    if counts.read()[HS.NAME] != 0:
        raise AssertionError("the classification CLI launched the heatmap "
                             "kernel")
    with open(os.path.join(cli_run_dir(exp), "logs",
                           "classification.json")) as f:
        log = json.load(f)
    if len(log["history"]) != 2 or set(log) != {"history", "best_acc",
                                                "best_epoch"}:
        raise AssertionError(f"classification.json: {log}")
    for h in log["history"]:
        assert_finite("classification.json", *h.values())
    if os.listdir(cache) != ["cifar10_2048_1000_0.25.json"]:
        raise AssertionError(f"split cache: {os.listdir(cache)}")
    step_ms = [t for _, t in seen["steps"]]
    emit({"phase": "cli_classification", "mode": "mt_ubpl",
          "model": "VGG11", "run_s": run_s, "steps": len(step_ms),
          "steady_step_ms_median": statistics.median(step_ms[1:]),
          "history": log["history"], "best_acc": log["best_acc"]})
    return counts.read()


class Counts:
    """Reset and read the launch counters of every port kernel."""

    def __init__(self):
        from ubpl_torch.ops.kernels import KERNELS
        self.kernels = KERNELS

    def reset(self):
        for k in self.kernels:
            k.launches = 0

    def read(self):
        return {k.NAME: k.launches for k in self.kernels}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    counts = Counts()       # imports the port: fails first outside a checkout
    os.makedirs(BUILD, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_env()
    records = {"heatmap_synth": phase_kernel_heatmap()}
    phase_reference()
    paths = [phase(counts) for phase in (phase_serve, phase_train)]
    launches, resident_ms = phase_train_mt_ubpl(counts)
    paths += [launches, phase_train_mt_ubpl_mld(counts),
              phase_train_mt_ubpl_stream(counts, resident_ms),
              phase_train_mt(counts)]
    try:
        paths.append(phase_train_classification(counts))
        phase_classification_fp32()
        phase_litepose()
        phase_data_disk()
        paths += [phase_cli_dualpose_ubpl(counts),
                  phase_cli_mt_ubpl_pseudo(counts),
                  phase_cli_exec_quick(counts),
                  phase_cli_classification(counts)]
    finally:
        shutil.rmtree(SMOKE_DATA, ignore_errors=True)
    for name, rec in records.items():
        rec["launches"] = sum(launches[name] for launches in paths)
        if rec["launches"] == 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
    emit({"kernels": list(records.values())})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
