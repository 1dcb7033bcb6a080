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
  * cli_exec_quick: ``python -m ubpl_torch exec --quick`` on the same tree:
    all five regimes, 2 epochs each, HG2 (the depth cut), 24 images.

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
    return launches


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
    # kernels only: user annotations ("Optimizer.step#...") also appear on
    # the device timeline, spanning their kernels and the gaps between them
    dev = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "#" not in e.key
           and not getattr(e, "is_user_annotation", False)]
    kinds = {"convolution": ("conv", "xmma", "cutlass", "gemm", "cudnn",
                             "implicit"),
             "batchnorm": ("batch_norm",),
             "optimizer_ema": ("multi_tensor", "foreach", "adam"),
             "heatmap_synth": ("heatmap_synth",)}
    by_kind = {k: 0.0 for k in list(kinds) + ["other"]}
    for key, ms, _ in dev:
        low = key.lower()
        kind = next((k for k, pats in kinds.items()
                     if any(p in low for p in pats)), "other")
        by_kind[kind] += ms
    busy_ms = sum(d[1] for d in dev)
    top = sorted(dev, key=lambda d: -d[1])[:12]
    emit({"phase": phase, "steps": n,
          "device_busy_ms_per_step": busy_ms, "step_ms": step_ms,
          "idle_share": (1 - busy_ms / step_ms) if busy_ms else None,
          "device_kernels_per_step": sum(d[2] for d in dev),
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
def observe(*classes):
    """Wrap each class's ``train_step``: the host time of every step,
    synchronised before and after, and the last trainer seen."""
    import torch
    seen = {"steps": [], "trainer": None}
    real = {cls: cls.__dict__.get("train_step") for cls in classes}

    def wrap(cls, fn):
        def train_step(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args)
            torch.cuda.synchronize()
            seen["steps"].append((cls.regime, (time.perf_counter() - t0) * 1e3))
            seen["trainer"] = self
            return out
        return train_step

    for cls, fn in real.items():
        cls.train_step = wrap(cls, fn or getattr(cls, "train_step"))
    try:
        yield seen
    finally:
        for cls, fn in real.items():
            if fn is None:
                del cls.train_step
            else:
                cls.train_step = fn


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
    paths = [phase(counts) for phase in (phase_serve, phase_train,
                                         phase_train_mt_ubpl,
                                         phase_train_mt)]
    try:
        phase_data_disk()
        paths += [phase_cli_dualpose_ubpl(counts),
                  phase_cli_exec_quick(counts)]
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
