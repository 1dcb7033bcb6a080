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
  * train_mt_ubpl_dp: train_mt_ubpl's shape data-parallel through
    ``parallel.launch.launch``: two ranks on card 0 under gloo (16 rows
    each).  gloo's collectives on CUDA tensors checked per dtype and timed;
    in fp32 with TF32 off, step 1 is held to one process's step 1 on the
    same seed and batch (losses, summed gradients), and the validation
    split over the ranks to one process's counters; in float64 step 1
    with one process's views and with the ranks' own; then 8 bf16 steps (2
    heatmap launches per step per rank) with the ranks' step time, global
    images/s, peak memory and collective time, and one checkpoint, written
    once, that ``PoseEstimator.from_checkpoint`` serves;
  * cli_mt_ubpl_mesh: ``python -m ubpl_torch mt_ubpl --synthetic_data=True
    --mesh_shape=N`` (N = the host's cards under NCCL; one card: two gloo
    ranks on it) against the same run with ``--mesh_shape=1`` (in this
    process), HG3, fp32, 2 epochs of 1 step: equal first-epoch losses;
    rank 0's trace of epoch 1 holds 2 heatmap kernels;
  * dp_nccl (hosts with several cards only): the MT_UBPL step under NCCL
    over 1 and over all cards, step time, images/s and scaling;
  * train_mt_ubpl_branch: train_mt_ubpl's shape branch-parallel, a
    ``("model",)`` mesh of 2: two ranks on card 0 under gloo, each with one
    (student, EMA teacher) branch and the whole batch.  In fp32 with TF32
    off, step 1 (whole, and with FDC alone) is held to one process's on
    the same seed and batch (losses, each branch's gradients) and the
    validation to one process's counters; in float64 step 1 with one
    process's views; then 8 bf16 steps (2 heatmap launches per step per
    rank) with the ranks' step time, images/s, peak memory and the branch
    exchanges' time, and one checkpoint, gathered into one process's
    layout and written once, that ``PoseEstimator.from_checkpoint`` serves;
  * cli_mt_ubpl_model: ``python -m ubpl_torch mt_ubpl --synthetic_data=True
    --mesh_shape=2 --mesh_axes=model`` (two cards under NCCL; one card: two
    gloo ranks on it) against ``--mesh_shape=1`` in this process, as
    cli_mt_ubpl_mesh;
  * model_nccl (hosts with several cards only): the MT_UBPL step under
    NCCL on 1 card, on ``model=2`` over 2, and on 4 cards ``data=4`` and
    ``(model=2, data=2)``: step time, images/s and scaling;
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
    all five regimes, 2 epochs each, HG2 (the depth cut), 24 images (these
    three CLI phases pass ``--mesh_shape=1``: they train in this process,
    where the launch counts are read, on a host with any number of cards);
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
    LitePose paths launch no heatmap kernel;
  * bench: ``python -m ubpl_torch bench`` in-process
    (``ubpl_torch/bench.py``) at its default shape, MT_UBPL HG3 bs 32
    bf16, one warm-up and 20 timed steps: exactly one JSON line on stdout
    whose ``device`` is this card's name and power limit, and 2 heatmap
    launches per step;
  * bench_stream: the same with ``UBPL_BENCH_STREAM=1`` (the streamed
    path);
  * mfu: ``bench.mfu_report`` (flops of one step by ``FlopCounterMode``,
    the mean step of a 20-step window, TFLOP/s and MFU), its flops held to 16
    forwards per image (0.98-1.02x of an HG3 forward's count on the card);
  * serve_bench: ``bench.main_serving`` (``tools/bench_infer_torch.py``)
    at bs 1, 8, 32 and 64, with host input and with input on the card: one
    line each, no heatmap launch.

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

``--only=NAME[,NAME...]`` runs the kernel check and the named phases alone
(``train_mt_ubpl`` stands for the four single-process training phases).
"""
import contextlib
import glob
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from unittest import mock

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
    """Triton heatmap kernel vs its plain version at the main paths' shapes
    (K=9, 256 -> 64; B=32 in one process, B=16 on each of two data-parallel
    ranks) on kps drawn from uniform(-5, 260); timed at B=32."""
    import torch
    from ubpl_torch.ops.heatmap import synthesize_heatmaps as plain
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    K, inp, out = 9, 256, 64
    rng = np.random.default_rng(0)
    errs = {}
    for B in (32, 16):
        kps = torch.as_tensor(rng.uniform(-5, 260, (B, K, 3)).astype(
            np.float32), device="cuda")
        if B == 32:
            timed = kps
        hm_k, kn_k = HS.synthesize_heatmaps(kps, inp, out)
        hm_p, kn_p = plain(kps, inp, out)
        torch.cuda.synchronize()
        errs[B] = (hm_k - hm_p).abs().max().item()
        if not errs[B] <= 1e-6:
            raise AssertionError(f"heatmap kernel max abs err {errs[B]} > "
                                 f"1e-6 at B={B}")
        if not torch.equal(kn_k, kn_p):
            raise AssertionError(f"heatmap kernel kps_new differs from plain "
                                 f"at B={B}")
    err = max(errs.values())
    kps = timed
    B = kps.shape[0]
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
          "max_abs_err": err, "max_abs_err_by_batch": errs,
          "kps_new_equal": True, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "bound_ms": rec["bound_ms"],
          "kernel_graph_ms": kernel_graph_ms, "plain_graph_ms": plain_graph_ms,
          "launches_while_checking": HS.launches})
    return rec


def hg3_batch_norm_calls():
    """(C, H, conv bias?) of each train-mode BatchNorm of an HG3 forward at
    256 px, in order (139: ``pre`` 10, each stack 43)."""
    def res(inp, mid, hw):          # a Residual: bn1, bn2, bn3
        return [(inp, hw, False), (mid, hw, True), (mid, hw, True)]
    calls = [(64, 128, True)] + res(64, 64, 128) + res(128, 64, 64) \
        + res(128, 128, 64)
    for _ in range(3):
        calls += res(256, 128, 64)                  # up1 at 64
        for hw in (32, 16, 8, 4):                   # low1, low2/up1, low3
            calls += 3 * res(256, 128, hw)
        calls += res(256, 128, 64) + [(256, 64, True)]   # features
    return calls


def batch_norm_chain_ms(fn, calls, bs, grad):
    """Device ms of one HG3 forward's BatchNorm chains (``fn(x, conv bias,
    bn)`` for each of ``calls``, bf16 channels_last at ``bs``), and with
    ``grad`` their backward too, all captured in one CUDA graph."""
    import torch
    from ubpl_torch.models.layers import BatchNorm
    g = torch.Generator(device="cuda").manual_seed(0)
    args = []
    for C, hw, has_bias in calls:
        x = torch.randn(bs, C, hw, hw, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        cb = (0.1 * torch.randn(C, device="cuda", generator=g)
              if has_bias else None)
        args.append((x.requires_grad_(grad),
                     None if cb is None else cb.requires_grad_(grad),
                     BatchNorm(C).cuda().train(), torch.randn_like(x)))

    def chain():
        for x, cb, bn, dy in args:
            y = fn(x, cb, bn)
            if grad:
                leaves = [x, bn.weight, bn.bias] + ([] if cb is None
                                                    else [cb])
                torch.autograd.grad(y, leaves, dy, allow_unused=True)
    with contextlib.nullcontext() if grad else torch.no_grad():
        return cuda_graph_ms(chain, reps=5, inner=1)


def batch_norm_relu_grads(fn, x, cb, dy, bn):
    """y, the running statistics and the gradients of x, gamma, beta and
    the conv bias (None without one) of ``fn(x, cb, bn)`` against ``dy``."""
    import torch
    x = x.detach().clone().requires_grad_()
    cb = None if cb is None else cb.detach().clone().requires_grad_()
    y = fn(x, cb, bn)
    leaves = [x, bn.weight, bn.bias] + ([] if cb is None else [cb])
    grads = torch.autograd.grad(y, leaves, dy.to(y.dtype))
    return (y.detach(), bn.running_mean.clone(), bn.running_var.clone(),
            *grads, *([None] if cb is None else []))


def phase_kernel_batch_norm_relu():
    """Triton BatchNorm + ReLU kernels vs their plain version at the main
    path's shapes (bf16 channels_last, bs 32: C 64 at 128x128, 128 and 256
    at 64x64, 256 at 16x16, 128 and 256 at 4x4; with and without a conv
    bias), forward and backward against the plain version run in fp32 on
    the same values: y and dx within one bf16 ulp of their scale (dx where
    the pre-activation is not within 1e-4 of 0, where a rounding of the
    statistics may flip the ReLU's mask), running stats rtol 1e-5, gamma's
    and beta's gradients within 5e-3 of their norm, the conv bias's
    gradient the fp32 sum of dx (within 2^-8 of the sum of |dx|, against
    the returned dx and against the plain version's), two calls bit-equal.
    Timed per MT_UBPL step (4 forwards without gradient and 4 with, each of
    HG3's 139 calls; CUDA graphs) beside the byte bound, the plain version
    and ATen's ``F.batch_norm`` + ``F.relu`` (``library_ms``)."""
    import copy as _copy
    import torch
    import torch.nn.functional as F
    from ubpl_torch.models.layers import BatchNorm
    from ubpl_torch.ops.kernels import batch_norm_relu as BR
    bs, errs = 32, {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for C, hw, has_bias in ((64, 128, True), (128, 64, False),
                            (256, 64, True), (256, 16, True), (128, 4, True),
                            (256, 4, False)):
        x = (1.5 * torch.randn(bs, C, hw, hw, device="cuda", generator=g)
             + 0.3).to(torch.bfloat16).contiguous(
                 memory_format=torch.channels_last)
        cb = (0.2 * torch.randn(C, device="cuda", generator=g)
              if has_bias else None)
        dy = torch.randn(bs, C, hw, hw, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bn = BatchNorm(C).cuda().train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.uniform_(-0.5, 0.5, generator=g)
        ref_bn, again = _copy.deepcopy(bn), _copy.deepcopy(bn)
        got = batch_norm_relu_grads(BR.batch_norm_relu, x, cb, dy, bn)
        rep = batch_norm_relu_grads(BR.batch_norm_relu, x, cb, dy, again)
        ref = batch_norm_relu_grads(BR.batch_norm_relu_plain, x.float(), cb,
                                    dy.float(), ref_bn)
        torch.cuda.synchronize()

        def ulps(a, b, keep=None):
            d = (a.float() - b).abs()
            d = d if keep is None else d * keep
            scale = float(b.abs().max())
            return float(d.max()) / 2.0 ** (math.floor(math.log2(scale)) - 7)
        v = x.double() + (0 if cb is None else cb.double().view(1, -1, 1, 1))
        pre = ((v - v.mean((0, 2, 3), keepdim=True))
               * v.var((0, 2, 3), unbiased=False, keepdim=True).add(
                   bn.eps).rsqrt() * bn.weight.double().view(1, -1, 1, 1)
               + bn.bias.double().view(1, -1, 1, 1)).abs() > 1e-4
        stat = max(float(((a - b).abs() / b.abs().clamp_min(1e-3)).max())
                   for a, b in zip(got[1:3], ref[1:3]))
        affine = max(float((a - b).norm() / b.norm())
                     for a, b in zip(got[4:6], ref[4:6]))
        e = {"y_ulps": ulps(got[0], ref[0]), "running_rel": stat,
             "dx_ulps": ulps(got[3], ref[3], pre), "dgamma_dbeta_rel": affine,
             "repeat_equal": all(
                 (a is None and b is None) or torch.equal(a, b)
                 for a, b in zip(got, rep))}
        ok = (e["y_ulps"] <= 1.0 and stat <= 1e-5 and e["dx_ulps"] <= 1.0
              and affine <= 5e-3 and e["repeat_equal"])
        if has_bias:
            spread = got[3].double().abs().sum((0, 2, 3))
            e["dbias_vs_dx_sum"] = float(((
                got[6].double() - got[3].double().sum((0, 2, 3))).abs()
                / spread).max())
            e["dbias_vs_plain"] = float(
                ((got[6].double() - ref[6].double()).abs() / spread).max())
            ok = (ok and e["dbias_vs_dx_sum"] <= 2.0 ** -8
                  and e["dbias_vs_plain"] <= 2.0 ** -8)
        key = f"C{C}_{hw}x{hw}_{'bias' if has_bias else 'nobias'}"
        errs[key] = e
        if not ok:
            raise AssertionError(f"batch_norm_relu {key}: {e}")
    calls = hg3_batch_norm_calls()

    def library(x, cb, bn):
        return F.relu(F.batch_norm(x, bn.running_mean, bn.running_var,
                                   bn.weight, bn.bias, True, bn.momentum,
                                   bn.eps))

    def step_ms(fn):
        return (4 * batch_norm_chain_ms(fn, calls, bs, False)
                + 4 * batch_norm_chain_ms(fn, calls, bs, True))
    launches = BR.launches
    kernel_ms = step_ms(BR.batch_norm_relu)
    plain_ms = step_ms(BR.batch_norm_relu_plain)
    library_ms = step_ms(library)
    # bytes at the bound: forward reads x twice and writes y; backward
    # reads x and dy twice and writes dx (bf16)
    elems = sum(bs * C * hw * hw for C, hw, _ in calls)
    nbytes = 2 * elems * (8 * 3 + 4 * 5)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {"name": BR.NAME, "route": "triton", "source": BR.SOURCE,
           "replaces": BR.REPLACES, "max_err_bf16_ulps": max(
               max(e["y_ulps"], e["dx_ulps"]) for e in errs.values()),
           "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
           "library_ms": library_ms}
    emit({"phase": "kernel:batch_norm_relu", "errors": errs,
          "per": "MT_UBPL step (HG3, bs 32: 8 forwards, 4 backwards)",
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": bound_ms,
          "bytes": nbytes, "launches_while_checking": BR.launches - launches})
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
    step's (not part of the counted path).  The trainer's CUDA graph,
    decided at set-up without ``remat``, is switched off for these steps:
    they run eagerly."""
    import torch
    torch.cuda.synchronize()
    tr.optimizer.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr.cfg.remat = True
    graphed, tr.step_graph.enabled = tr.step_graph.enabled, False
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
    tr.step_graph.enabled = graphed
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


def dp_config(**kw):
    """train_mt_ubpl's shape: HG3, K=9, 256 -> 64, bs 32 = 16 unlabeled +
    16 labeled, 256 synthetic training images."""
    return train_config(**{"label_ratio": 0.5, "train_bs_labeled": 16,
                           **kw})


DP_FP32 = dict(compute_dtype="float32")
#: fp32 bounds of the branch-parallel step 1 against one process's: each
#: rank computes its branch on the whole batch as one process does, so
#: the losses came out equal and the gradients' median per-tensor
#: difference 4.2e-7 to 7.0e-7 (cuDNN's order of summation; "NVIDIA H100
#: 80GB HBM3, 700.00 W"); FDC counted on every rank is 100% off in the
#: FDC-only step
BRANCH_FP32_RTOL = 1e-6
BRANCH_FP32_GRAD_MEDIAN = 1e-5


def forward_float64(model, images, train, compute_dtype, remat=False):
    """``train/common.py:forward_heatmaps`` for float64 networks, without
    the cast of its outputs to float32."""
    model.train(train)
    out = model(images.double())
    return out if isinstance(out, tuple) else (out, None)


def float64_step(device, mesh=None, views=None):
    """Step 1 of MT_UBPL in float64 (networks and losses), train_mt_ubpl's
    shape.  One process (``mesh`` None) records its augmented views;
    ranks are handed their rows of ``views`` instead (their draws still
    made).  Returns (views or None, metrics, {name: (weights, gradient)}
    of the students, on the host)."""
    import torch
    import ubpl_torch.train.common as C
    import ubpl_torch.train.mt_ubpl as MT
    from ubpl_torch.parallel import collectives as PC
    from ubpl_torch.train.base_trainer import BaseTrainer
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    real = C.forward_heatmaps, MT.forward_heatmaps, BaseTrainer.augmented_view
    seen = []
    handed = iter(views or ())

    def view(self, imgs, kps, **kw):
        v = real[2](self, imgs, kps, **kw)
        if views is None:
            seen.append(type(v)(*(t.cpu() for t in v)))
            return v
        rows = self.local_rows(imgs.shape[0] * PC.size(self.group))
        return type(v)(*(t[rows].to(self.device) for t in next(handed)))
    C.forward_heatmaps = MT.forward_heatmaps = forward_float64
    BaseTrainer.augmented_view = view
    try:
        tr = MTUBPLTrainer(dp_config(**DP_FP32), device=device, mesh=mesh)
        for net in tr.networks.values():
            net.double()
        batch = list(tr.make_sampler())[0]
        m = tr.run_train_steps([batch], *tr.epoch_schedules(1).values())[0]
        nets = {f"{name}:{k}": (p.detach().cpu(), p.grad.cpu())
                for name, net in tr.networks.items() if "_ema" not in name
                for k, p in net.named_parameters()}
        return (seen or None, {k: v.tolist() for k, v in m.items()}, nets)
    finally:
        C.forward_heatmaps, MT.forward_heatmaps = real[:2]
        BaseTrainer.augmented_view = real[2]


def collective_ms(prof, n):
    """Per-step times of the collectives in a profile of ``n`` steps: the
    host spans of the c10d calls (gloo runs them on the host) and the
    device time of NCCL's kernels."""
    from torch.autograd import DeviceType
    host, device = {}, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if e.key.lower().startswith("nccl"):
                device += e.self_device_time_total / 1e3 / n
        elif re.match(r"(c10d::|gloo:|nccl:)", e.key):
            host[e.key] = e.cpu_time_total / 1e3 / n
    return {"host_ms_per_step": host, "nccl_device_ms_per_step": device}


def step_differences(tr, ref):
    """Step 1 of ``tr`` against one process's (``ref``), on the card: the
    summed gradients' differences relative to each tensor's gradient
    (norms, tensors with a gradient above rounding noise: median and
    largest), the largest weight and running-stat differences, and the
    five tensors whose gradients differ most."""
    import torch
    dev = tr.device
    out = {"param": 0.0, "stat": 0.0}
    rel = []
    with torch.no_grad():
        for name, net in tr.networks.items():
            grads = ref["grads"][name.replace("_ema", "")]
            top = max(float(g.norm()) for g in grads.values())
            for key, p in net.named_parameters():
                g = grads[key].to(dev)
                out["param"] = max(out["param"], float(
                    (p - ref["states"][name][key].to(dev)).abs().max()))
                if p.grad is not None and float(g.norm()) > 1e-6 * top:
                    rel.append((float((p.grad - g).norm() / g.norm()),
                                f"{name}:{key}"))
            for key, t in net.named_buffers():
                out["stat"] = max(out["stat"], float(
                    (t - ref["states"][name][key].to(dev)).abs().max()))
    rel.sort(reverse=True)
    out["grad_rel_max"] = rel[0][0]
    out["grad_rel_median"] = statistics.median(r for r, _ in rel)
    return out, rel[:5]


def float64_differences(one, dp):
    """The float64 step of the ranks (``dp``) against one process's
    (``one``): losses and counts (largest relative difference), each
    student tensor's summed gradient (relative, norms; tensors with a
    gradient above rounding noise: largest and median), and the weights
    beyond 1e-9 of their size."""
    loss = max(float(np.max(np.abs(np.subtract(dp["metrics"][k], v))
                            / np.maximum(np.abs(v), 1e-300)))
               for k, v in one["metrics"].items())
    weight, rel = 0.0, []
    top = max(float(g.norm()) for _, g in one["nets"].values())
    for key, (p, g) in one["nets"].items():
        q, h = dp["nets"][key]
        if float(g.norm()) > 1e-6 * top:    # not a zero gradient's noise
            rel.append(float((h - g).norm() / g.norm()))
        weight = max(weight, float(((q - p).abs() - 1e-9 * p.abs()).max()))
    return {"loss_rel": loss, "grad_rel": max(rel),
            "grad_rel_median": statistics.median(rel),
            "weight_excess": weight}


def gloo_probe(ctx):
    """gloo on CUDA tensors between the ranks: whether ``all_reduce``,
    ``all_gather`` and ``broadcast`` are right for each dtype, and the host
    time of a 4 KB and of an 80 MB all-reduce (a BatchNorm's statistics;
    HG3's two students' gradients)."""
    import torch
    import torch.distributed as dist
    out = {"dtypes_ok": {}}
    for dt in (torch.uint8, torch.int32, torch.int64, torch.float32,
               torch.float64, torch.bfloat16, torch.float16):
        x = torch.full((5,), ctx.rank + 1, dtype=dt, device=ctx.device)
        dist.all_reduce(x)
        pieces = [torch.empty_like(x) for _ in range(ctx.mesh.size)]
        dist.all_gather(pieces, torch.full_like(x, ctx.rank + 1))
        y = torch.full_like(x, ctx.rank + 1)
        dist.broadcast(y, 0)
        out["dtypes_ok"][str(dt)] = (
            x.float().tolist() == [3.0] * 5
            and [p.float().tolist() for p in pieces] == [[1.0] * 5, [2.0] * 5]
            and y.float().tolist() == [1.0] * 5)
    for nbytes, n in ((4096, 200), (80 * 2 ** 20, 20)):
        t = torch.zeros(nbytes // 4, device=ctx.device)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        out[f"all_reduce_ms_{nbytes}_bytes"] = (
            (time.perf_counter() - t0) / n * 1e3)
    return out


def fp32_reference(validate=True, **kw):
    """Step 1 of one process's MT_UBPL trainer in fp32 (TF32 off) on
    ``dp_config(**kw)``: its batch, metrics, networks after the step,
    students' gradients and (``validate``) validation, on the host."""
    import torch
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    one = MTUBPLTrainer(dp_config(**DP_FP32, **kw), device="cuda")
    sched = tuple(one.epoch_schedules(1).values())
    batch = list(one.make_sampler())[0]
    metrics = {k: v.tolist() for k, v in
               one.run_train_steps([batch], *sched)[0].items()}
    ref = {"batch": batch.tolist(), "metrics": metrics,
           "states": {name: {k: t.cpu() for k, t in
                             net.state_dict().items()}
                      for name, net in one.networks.items()},
           "grads": {name: {k: p.grad.cpu() for k, p in
                            net.named_parameters()}
                     for name, net in one.networks.items()
                     if "_ema" not in name},
           "valid": one.validate() if validate else None}
    del one
    torch.cuda.empty_cache()
    return ref


def dp_rank(ctx, ref_path, base):
    """One rank of ``train_mt_ubpl_dp`` (see there)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.parallel import collectives as PC
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(ref_path, weights_only=False)
    out = {"rank": ctx.rank, "device": str(ctx.device),
           "backend": dist.get_backend(), "seconds": {}}
    clock = [time.perf_counter()]

    def lap(part):
        torch.cuda.synchronize()
        out["seconds"][part] = time.perf_counter() - clock[0]
        clock[0] = time.perf_counter()
    # 0. the collectives the port uses, on CUDA tensors under gloo
    out["gloo"] = gloo_probe(ctx)
    problems = [f"gloo collectives wrong for {dt} on rank {ctx.rank}"
                for dt, ok in out["gloo"]["dtypes_ok"].items() if not ok]
    lap("gloo_probe")
    # 1. fp32: step 1 against one process's step 1 on the same batch
    tr = MTUBPLTrainer(dp_config(**DP_FP32), device=ctx.device,
                       mesh=ctx.mesh)
    sched = tuple(tr.epoch_schedules(1).values())
    batch = list(tr.make_sampler())[0]
    if batch.tolist() != ref["batch"]:
        raise AssertionError("the ranks sample another batch")
    got = {k: v.tolist() for k, v in
           tr.run_train_steps([batch], *sched)[0].items()}
    lap("fp32_setup_and_step")
    for key, want in ref["metrics"].items():
        try:
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=0,
                                       err_msg=key)
        except AssertionError as e:
            problems.append(str(e))
    # In fp32 the ranks' summed gradients differ from one process's by a
    # few percent of a tensor's norm at most (median 0.46-1.0% measured):
    # cuDNN's algorithms for 16 and for 32 rows round differently and this
    # network amplifies it, while in float64 the two agree to rounding (the
    # checks after this one).  A gradient that is not summed over the ranks,
    # or halved, is 50% off or more; the median is held to 5%.  (AdamW's
    # first step moves every weight by about lr in its gradient's sign, so
    # the weights cannot tell a right reduction from a wrong one.)
    worst, top_grads = step_differences(tr, ref)
    if not worst["grad_rel_median"] <= 5e-2:
        problems.append(f"step 1's gradients differ from one process's: "
                        f"{worst}")
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1).float() for net in
                          tr.networks.values()
                          for t in net.state_dict().values()])
        rank0 = flat.clone()
        dist.broadcast(rank0, 0)
        if PC.any_true(not torch.equal(rank0, flat), tr.group):
            problems.append("the ranks hold different networks")
    del flat, rank0
    # 2. validation, split over the ranks, on one process's weights
    for name, net in tr.networks.items():
        net.load_state_dict(ref["states"][name])
    lap("fp32_checks")
    preds, accs, errs = tr.validate()
    lap("validation")
    if (accs, errs) != (ref["valid"][1], ref["valid"][2]):
        problems.append(f"validation counters {accs} {errs} != one "
                        f"process's {ref['valid'][1:]}")
    pred_err = float(np.abs(np.asarray(preds) - np.asarray(ref["valid"][0]))
                     .max())
    out["fp32"] = {"metrics": got, "max_abs_diff": worst,
                   "grad_diff_top": top_grads,
                   "valid_pred_max_abs_diff": pred_err,
                   "valid_pck_mean": [a[-1] for a in accs]}
    del tr
    torch.cuda.empty_cache()
    # 2b. float64, handed one process's views, then with the ranks' own
    # views: rank 0's students go back
    for key, views in (("ranks64", torch.load(ref["views64"],
                                              weights_only=False)),
                       ("own64", None)):
        _, got64, nets = float64_step(ctx.device, ctx.mesh, views)
        if ctx.rank == 0:
            torch.save({"metrics": got64, "nets": nets}, ref[key])
        del views, nets
        torch.cuda.empty_cache()
        lap(f"float64_step_{key}")
    # 3. bf16: 8 timed steps, then a profile of 2 (rank 0's)
    tr = MTUBPLTrainer(dp_config(), device=ctx.device, mesh=ctx.mesh)
    batches = list(tr.make_sampler())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    HS.launches = 0
    step_ms, metrics = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.run_train_steps([b], *sched)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: v.tolist() for k, v in m.items()})
    launches = HS.launches
    lap("bf16_setup_and_8_steps")
    if launches != 2 * len(batches):
        raise AssertionError(f"heatmap kernel launched {launches} times in "
                             f"{len(batches)} steps on rank {ctx.rank}")
    for m in metrics:
        assert_finite("data-parallel metric", *m.values())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    window = list(tr.make_sampler())[:2]
    if ctx.rank == 0:
        # host activity alone: gloo's collectives run on the host, and the
        # device's events would take minutes to sort at this many ops
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.run_train_steps(window, *sched)
            torch.cuda.synchronize()
        collectives = collective_ms(prof, len(window))
    else:
        tr.run_train_steps(window, *sched)
        collectives = None
    lap("profile_2_steps")
    steady = statistics.median(step_ms[1:])
    out["bf16"] = {"step_ms": step_ms, "steady_step_ms_median": steady,
                   "global_images_per_s": tr.cfg.train_bs / steady * 1e3,
                   "peak_memory_gb": peak_gb, "launches": launches,
                   "rows_per_rank": tr.cfg.train_bs // ctx.mesh.size,
                   "last": metrics[-1], "collectives": collectives}
    # 4. one checkpoint: rank 0 writes it
    tr.save(base, 0, True)
    PC.barrier(tr.group)
    lap("checkpoint")
    out["launches"] = {HS.NAME: launches}
    out["problems"] = problems
    return out


def phase_train_mt_ubpl_dp(counts):
    """Data-parallel MT_UBPL through ``parallel.launch``: two ranks on card
    0 under gloo (NCCL refuses two ranks on one card), train_mt_ubpl's
    shape (HG3, K=9, bf16, bs 32 = 16 + 16: 16 rows per rank).

    First the collectives of the port under gloo on CUDA tensors (each
    dtype; a 4 KB and an 80 MB all-reduce timed).  Then, fp32 with TF32
    off, the ranks' step 1 is held to one process's step 1 on the same
    seed and batch (losses rtol 1e-4, the summed gradients' median per-
    tensor difference 5%: see ``dp_rank``; both ranks' networks equal), and
    their validation, split over the ranks on that process's post-step
    weights, to its counters.  Then the same step in float64, the ranks
    handed one process's views: losses and summed gradients within 1e-9,
    weights within 1e-9 of their size + 2.5e-8 (AdamW's step on a zero
    gradient's rounding noise); and with their own views, whose float32
    last bits depend on the batch size: losses within 1e-6, gradients
    within 2% (median 0.2%).
    Then 8 bf16 steps (2 heatmap launches per step per rank) and a profile
    of 2 (rank 0's), and one checkpoint, written once, that
    ``PoseEstimator.from_checkpoint`` serves.  gloo stages every collective
    through the host: its times here are not what NCCL across cards
    costs."""
    import torch
    from ubpl_torch.parallel import make_mesh
    from ubpl_torch.parallel.launch import launch
    ref = fp32_reference()
    views64, metrics64, nets64 = float64_step("cuda")
    ref["views64"] = os.path.join(BUILD, "dp_views64.pt")
    ref["ranks64"] = os.path.join(BUILD, "dp_ranks64.pt")
    ref["own64"] = os.path.join(BUILD, "dp_own64.pt")
    torch.save(views64, ref["views64"])
    del views64
    torch.cuda.empty_cache()
    ref_path = os.path.join(BUILD, "dp_reference.pt")
    torch.save(ref, ref_path)
    base = os.path.join(BUILD, "smoke_mt_ubpl_dp")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = launch(dp_rank, make_mesh((2,), ("data",)), "cuda",
                   backend="gloo", args=(ref_path, base), timeout=900)
    run_s = time.perf_counter() - t0
    # float64: the ranks' step equals one process's on the same views, and
    # is near it on their own
    one64 = {"metrics": metrics64, "nets": nets64}
    f64 = float64_differences(one64, torch.load(ref["ranks64"],
                                                weights_only=False))
    own64 = float64_differences(one64, torch.load(ref["own64"],
                                                  weights_only=False))
    problems = [p for r in ranks for p in r["problems"]]
    if not (f64["loss_rel"] <= 1e-9 and f64["grad_rel"] <= 1e-9
            and f64["weight_excess"] <= 2.5e-8):
        problems.append(f"float64 step differs from one process's: {f64}")
    if not (own64["loss_rel"] <= 1e-6 and own64["grad_rel"] <= 2e-2
            and own64["grad_rel_median"] <= 2e-3):
        problems.append(f"float64 step on the ranks' own views differs from "
                        f"one process's: {own64}")
    for path in (ref["views64"], ref["ranks64"], ref["own64"]):
        os.remove(path)
    files = serve_world_checkpoint(base)
    cfg = dp_config()
    launches = {name: sum(r["launches"][name] for r in ranks)
                for name in ranks[0]["launches"]}
    emit({"phase": "train_mt_ubpl_dp", "problems": problems,
          "regime": "MT_UBPL", "ranks": 2,
          "backend": ranks[0]["backend"],
          "devices": [r["device"] for r in ranks], "model": cfg.model,
          "train_bs": cfg.train_bs, "train_bs_labeled": cfg.train_bs_labeled,
          "run_s": run_s, "rank_seconds": [r["seconds"] for r in ranks],
          "fp32_one_process": ref["metrics"],
          "fp32": [r["fp32"] for r in ranks],
          "gloo": [r["gloo"] for r in ranks],
          "float64_vs_one_process": f64,
          "float64_own_views_vs_one_process": own64,
          "bf16": [r["bf16"] for r in ranks],
          "checkpoint_files": files, "served_images": 8,
          "kernel_launches": launches, "kernel_launches_per_step_per_rank": 2})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def serve_world_checkpoint(base):
    """The checkpoint a world wrote under ``base``: its two files, served
    by ``PoseEstimator.from_checkpoint`` on 8 images.  Returns the file
    names."""
    from ubpl_torch.infer import PoseEstimator
    files = sorted(os.listdir(os.path.join(base, "ckpts")))
    if files != ["checkpoint.pth.tar", "checkpoint_best.pth.tar"]:
        raise AssertionError(f"checkpoint files {files}")
    cfg = dp_config()
    est = PoseEstimator.from_checkpoint(
        base, model=cfg.model, kps_count=cfg.synthetic_kps,
        means=(0.5, 0.5, 0.5), batch_size=32, device="cuda",
        compute_dtype=cfg.compute_dtype, inp_res=cfg.inp_res,
        out_res=cfg.out_res)
    rng = np.random.default_rng(3)
    kps, scores = est.predict(rng.integers(
        0, 256, (8, cfg.inp_res, cfg.inp_res, 3), dtype=np.uint8))
    if kps.shape != (8, cfg.synthetic_kps, 2):
        raise AssertionError(f"served shape {kps.shape}")
    assert_finite("served keypoints", kps, scores)
    return files


def nccl_rank(ctx, n_steps):
    """One rank of ``dp_nccl`` and ``model_nccl``: bf16 MT_UBPL steps at
    16 + 16 rows per index of the batch axes (each ``model`` index holds
    the whole batch of its branch), timed, then one more under the
    profiler (rank 0's).  Returns the step times, the collectives' and the
    heatmap kernel's launches in the timed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.parallel.mesh import batch_mult
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    n = batch_mult(ctx.mesh)
    tr = MTUBPLTrainer(dp_config(train_bs=32 * n, train_bs_labeled=16 * n,
                                 train_count=256 * n), device=ctx.device,
                       mesh=ctx.mesh)
    sched = tuple(tr.epoch_schedules(1).values())
    batches = list(tr.make_sampler())[:n_steps]
    step_ms = []
    HS.launches = 0
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_train_steps([b], *sched)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"step_ms": step_ms, "launches": {HS.NAME: HS.launches}}
    if ctx.rank != 0:
        tr.run_train_steps(batches[:1], *sched)
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run_train_steps(batches[:1], *sched)
        torch.cuda.synchronize()
    return {**out, "collectives": collective_ms(prof, 1)}


def phase_dp_nccl():
    """On a host with several cards: the MT_UBPL step under NCCL over 1 and
    over all N cards (bf16, 16 + 16 rows per card), its step time, images/s
    and the scaling against one card."""
    import torch
    from ubpl_torch.parallel import make_mesh
    from ubpl_torch.parallel.launch import launch
    N = torch.cuda.device_count()
    runs = {}
    for n in (1, N):
        ranks = launch(nccl_rank, make_mesh((n,), ("data",)), "cuda",
                       args=(8,), timeout=900)
        steady = max(statistics.median(r["step_ms"][1:]) for r in ranks)
        runs[n] = {"step_ms": [r["step_ms"] for r in ranks],
                   "steady_step_ms_median": steady,
                   "images_per_s": 32 * n / steady * 1e3,
                   "collectives": ranks[0]["collectives"]}
    emit({"phase": "dp_nccl", "cards": N, "rows_per_card": 32,
          "runs": runs,
          "scaling": runs[N]["images_per_s"] / runs[1]["images_per_s"]})


def phase_model_nccl():
    """On a host with several cards: the MT_UBPL step under NCCL on one
    card, branch parallel over 2 cards (``model=2``, 32 rows per card),
    and on 4 cards data parallel (``data=4``) and both (``model=2,
    data=2``), 16 + 16 rows per batch index: step time, images/s and the
    scaling against one card.  Returns the heatmap launches of the timed
    steps."""
    import torch
    from ubpl_torch.parallel import make_mesh
    from ubpl_torch.parallel.launch import launch
    from ubpl_torch.parallel.mesh import batch_mult
    N = torch.cuda.device_count()
    meshes = [((1,), ("data",)), ((2,), ("model",))]
    if N >= 4:
        meshes += [((4,), ("data",)), ((2, 2), ("model", "data"))]
    runs, launches = {}, {}
    for shape, axes in meshes:
        mesh = make_mesh(shape, axes)
        ranks = launch(nccl_rank, mesh, "cuda", args=(8,), timeout=900)
        steady = max(statistics.median(r["step_ms"][1:]) for r in ranks)
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        runs[",".join(f"{a}={n}" for a, n in zip(axes, shape))] = {
            "cards": mesh.size, "step_ms": [r["step_ms"] for r in ranks],
            "steady_step_ms_median": steady,
            "images_per_s": 32 * batch_mult(mesh) / steady * 1e3,
            "collectives": ranks[0]["collectives"]}
    one = runs["data=1"]["images_per_s"]
    emit({"phase": "model_nccl", "cards": N, "rows_per_batch_index": 32,
          "runs": runs, "scaling": {k: r["images_per_s"] / one
                                    for k, r in runs.items()}})
    return launches


def phase_cli_mt_ubpl_mesh(counts):
    """``python -m ubpl_torch mt_ubpl --synthetic_data=True
    --mesh_shape=N`` through ``__main__.main``, spawned: N = the host's
    cards under NCCL, or on a host with one card N = 2 ranks on it under
    gloo (``cli_mesh_phase``)."""
    import torch
    N = torch.cuda.device_count()
    return cli_mesh_phase(counts, "cli_mt_ubpl_mesh", (max(N, 2),),
                          ("data",))


def phase_cli_mt_ubpl_model(counts):
    """``python -m ubpl_torch mt_ubpl --synthetic_data=True --mesh_shape=2
    --mesh_axes=model``: branch parallel over 2 cards under NCCL, or on a
    host with one card 2 ranks on it under gloo (``cli_mesh_phase``)."""
    return cli_mesh_phase(counts, "cli_mt_ubpl_model", (2,), ("model",))


def cli_mesh_phase(counts, phase, shape, axes):
    """``python -m ubpl_torch mt_ubpl --synthetic_data=True
    --mesh_shape=... --mesh_axes=...`` through ``__main__.main``, spawned:
    one rank per card under NCCL, or where the host has fewer cards than
    the mesh, every rank on card 0 under gloo (NCCL takes one rank per
    card: the CLI's card count and backend are patched for this run).  HG3, bs 32 = 16 + 16, 48 training images
    (one step an epoch), 2 epochs, fp32 with TF32 off, against the same run
    with ``--mesh_shape=1``, which trains in this process: the first
    epoch's losses equal (rtol 1e-5).  The second epoch's are compared, not
    held: after one AdamW step cuDNN's rounding has moved the weights whose
    gradient is near 0 by up to lr either way.  Rank 0 traces epoch 1: the
    trace's heatmap kernels are its launches."""
    import functools
    import gc
    import torch
    import ubpl_torch.train.base_trainer as BT
    from ubpl_torch.__main__ import main
    N = torch.cuda.device_count()
    ranks = int(np.prod(shape))
    backend = "nccl" if N >= ranks else "gloo"
    mesh_argv = ["--mesh_shape=" + ",".join(map(str, shape)),
                 "--mesh_axes=" + ",".join(axes)]
    argv = ["mt_ubpl", "--synthetic_data=True", "--model=HG3",
            "--synthetic_kps=9", "--inp_res=256", "--out_res=64",
            "--train_count=48", "--valid_count=32", "--label_ratio=0.5",
            "--train_bs=32", "--train_bs_labeled=16", "--infer_bs=32",
            "--epochs=2", "--compute_dtype=float32"]
    trace_dir = os.path.join(BUILD, f"{phase}_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    runs = {}
    tf32 = os.environ.get("NVIDIA_TF32_OVERRIDE")
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"      # the spawned ranks' TF32
    real = BT.local_mesh_size, BT.launch
    try:
        for name, extra in (("no_mesh", ["--mesh_shape=1"]),
                            ("mesh", mesh_argv + [
                                f"--profile_dir={trace_dir}"])):
            if name == "mesh" and backend == "gloo":
                BT.local_mesh_size = lambda: ranks
                BT.launch = functools.partial(real[1], backend="gloo")
            exp = os.path.join(BUILD, f"{phase}_{name}")
            shutil.rmtree(exp, ignore_errors=True)
            counts.reset()
            t0 = time.perf_counter()
            rc = main(argv + extra + [f"--experiment_root={exp}"])
            run_s = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"main returned {rc}")
            # the in-process run's cached blocks, its CUDA graph's pool
            # among them, go back before the ranks share the card
            gc.collect()
            torch.cuda.empty_cache()
            base = cli_run_dir(exp)
            logs = []
            for e in (1, 2):
                with open(os.path.join(base, "logs", "logData",
                                       f"logData_{e}.json")) as f:
                    logs.append(json.load(f))
            runs[name] = {"run_s": run_s, "logs": logs,
                          "launches": counts.read()}
    finally:
        BT.local_mesh_size, BT.launch = real
        if tf32 is None:
            del os.environ["NVIDIA_TF32_OVERRIDE"]
        else:
            os.environ["NVIDIA_TF32_OVERRIDE"] = tf32
    keys = ("pec_losses", "mtc_losses", "epc_losses", "fdc_loss")
    rel = [max(float(np.max(np.abs(np.subtract(a[k], b[k]))
                            / np.maximum(np.abs(b[k]), 1e-30)))
               for k in keys)
           for a, b in zip(runs["mesh"]["logs"], runs["no_mesh"]["logs"])]
    for log in runs["mesh"]["logs"]:
        assert_finite("mesh run loss/PCK", *log.values())
    if not rel[0] <= 1e-5:
        raise AssertionError(f"mesh run's epoch-1 losses differ by "
                             f"{rel[0]} (rtol 1e-5)")
    (trace,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    traced = sum(1 for e in events if e.get("cat") == "kernel"
                 and "heatmap_synth" in e.get("name", ""))
    if traced != 2:
        raise AssertionError(f"rank 0 traced {traced} heatmap kernels in "
                             "one step")
    if sum(runs["no_mesh"]["launches"].values()) == 0:
        raise AssertionError("the --mesh_shape=1 run launched no kernel in "
                             "this process")
    emit({"phase": phase, "cards": N, "mesh_shape": list(shape),
          "mesh_axes": list(axes), "backend": backend, "model": "HG3",
          "dtype": "float32",
          "train_bs": 32, "epochs": 2, "steps_per_epoch": 1,
          "run_s": {k: r["run_s"] for k, r in runs.items()},
          "losses": {k: [{kk: log[kk] for kk in keys} for log in r["logs"]]
                     for k, r in runs.items()},
          "max_rel_loss_diff_per_epoch": rel,
          "rank0_traced_heatmap_kernels_epoch1": traced,
          "no_mesh_kernel_launches": runs["no_mesh"]["launches"]})
    return runs["no_mesh"]["launches"]


BRANCH_FDC_ONLY = dict(pose_weight=0.0, ensemble_pseudo_weight=0.0,
                       cons_weight_max=0.0, cons_weight_min=0.0)


def rel_metric_diff(got, want):
    """Largest relative difference between two metric dicts' values."""
    return max(float(np.max(np.abs(np.subtract(got[k], v))
                            / np.maximum(np.abs(v), 1e-30)))
               for k, v in want.items())


def branch_rank(ctx, ref_path, base):
    """One rank of ``train_mt_ubpl_branch`` (see there)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.parallel import collectives as PC
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(ref_path, weights_only=False)
    out = {"rank": ctx.rank, "device": str(ctx.device),
           "backend": dist.get_backend(), "seconds": {}, "fp32": {}}
    problems = []
    clock = [time.perf_counter()]

    def lap(part):
        torch.cuda.synchronize()
        out["seconds"][part] = time.perf_counter() - clock[0]
        clock[0] = time.perf_counter()
    # 1. fp32 step 1, whole and FDC alone, against one process's step 1
    for key, kw in (("fp32", {}), ("fdc_only", BRANCH_FDC_ONLY)):
        tr = MTUBPLTrainer(dp_config(**DP_FP32, **kw), device=ctx.device,
                           mesh=ctx.mesh)
        sched = tuple(tr.epoch_schedules(1).values())
        batch = list(tr.make_sampler())[0]
        if batch.tolist() != ref[key]["batch"]:
            raise AssertionError("the ranks sample another batch")
        got = {k: v.tolist() for k, v in
               tr.run_train_steps([batch], *sched)[0].items()}
        worst, top = step_differences(tr, ref[key])
        out["fp32"][key] = {
            "networks": list(tr.networks), "metrics": got,
            "metric_rel_diff": rel_metric_diff(got, ref[key]["metrics"]),
            "max_abs_diff": worst, "grad_diff_top": top}
        lap(f"{key}_setup_and_step")
        if key == "fp32":       # 2. validation on one process's weights
            for name, net in tr.networks.items():
                net.load_state_dict(ref[key]["states"][name])
            preds, accs, errs = tr.validate()
            lap("validation")
            if (accs, errs) != (ref[key]["valid"][1], ref[key]["valid"][2]):
                problems.append(f"validation counters {accs} {errs} != one "
                                f"process's {ref[key]['valid'][1:]}")
            out["fp32"]["valid_pred_max_abs_diff"] = float(np.abs(
                np.asarray(preds) - np.asarray(ref[key]["valid"][0])).max())
        del tr
        torch.cuda.empty_cache()
    # 3. float64, handed one process's views: each rank's students back
    _, got64, nets = float64_step(ctx.device, ctx.mesh, torch.load(
        ref["views64"], weights_only=False))
    torch.save({"metrics": got64, "nets": nets},
               ref["ranks64"].format(rank=ctx.rank))
    del nets
    torch.cuda.empty_cache()
    lap("float64_step")
    # 4. bf16: 8 timed steps, then a profile of 2 (rank 0's)
    tr = MTUBPLTrainer(dp_config(), device=ctx.device, mesh=ctx.mesh)
    sched = tuple(tr.epoch_schedules(1).values())
    batches = list(tr.make_sampler())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    HS.launches = 0
    step_ms, metrics = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.run_train_steps([b], *sched)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: v.tolist() for k, v in m.items()})
    launches = HS.launches
    lap("bf16_setup_and_8_steps")
    if launches != 2 * len(batches):
        raise AssertionError(f"heatmap kernel launched {launches} times in "
                             f"{len(batches)} steps on rank {ctx.rank}")
    for m in metrics:
        assert_finite("branch-parallel metric", *m.values())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    window = list(tr.make_sampler())[:2]
    if ctx.rank == 0:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.run_train_steps(window, *sched)
            torch.cuda.synchronize()
        exchanges = collective_ms(prof, len(window))
    else:
        tr.run_train_steps(window, *sched)
        exchanges = None
    lap("profile_2_steps")
    steady = statistics.median(step_ms[1:])
    out["bf16"] = {"step_ms": step_ms, "steady_step_ms_median": steady,
                   "images_per_s": tr.cfg.train_bs / steady * 1e3,
                   "peak_memory_gb": peak_gb, "launches": launches,
                   "networks": list(tr.networks), "last": metrics[-1],
                   "exchanges": exchanges}
    # 5. one checkpoint: every rank gathers, rank 0 writes
    tr.save(base, 0, True)
    PC.barrier(tr.world)
    lap("checkpoint")
    out["launches"] = {HS.NAME: launches}
    out["problems"] = problems
    return out


def phase_train_mt_ubpl_branch(counts):
    """Branch-parallel MT_UBPL through ``parallel.launch``: a ``("model",)``
    mesh of 2, two ranks on card 0 under gloo, train_mt_ubpl's shape (HG3,
    K=9, bf16, bs 32 = 16 + 16): each rank holds one (student, EMA
    teacher) branch and the whole batch, and the step exchanges the
    teachers' last stacks, the students' features and the metrics.

    In fp32 with TF32 off, the ranks' step 1 is held to one process's on
    the same seed and batch: losses and counts, and each branch's
    gradients (median per-tensor difference), whole and in a step with
    FDC alone (PEC, MTC and EPC weighted 0: FDC's gradient reaches each
    student through the exchange, and counted once too often it is 100%
    off); their validation, on that process's post-step weights, to its
    counters.  Then the float64 step handed one process's views: losses,
    gradients within 1e-9, weights within 1e-9 of their size + 2.5e-8.
    Then 8 bf16 steps (2 heatmap launches per step per rank) with the
    ranks' step time, images/s, peak memory and, from a profile of 2
    steps (rank 0's host activity), the exchanges' time; and one
    checkpoint, written once in one process's layout, that
    ``PoseEstimator.from_checkpoint`` serves."""
    import torch
    from ubpl_torch.parallel import make_mesh
    from ubpl_torch.parallel.launch import launch
    ref = {"fp32": fp32_reference(),
           "fdc_only": fp32_reference(validate=False, **BRANCH_FDC_ONLY)}
    views64, metrics64, nets64 = float64_step("cuda")
    ref["views64"] = os.path.join(BUILD, "branch_views64.pt")
    ref["ranks64"] = os.path.join(BUILD, "branch_rank{rank}_64.pt")
    torch.save(views64, ref["views64"])
    del views64
    torch.cuda.empty_cache()
    ref_path = os.path.join(BUILD, "branch_reference.pt")
    torch.save(ref, ref_path)
    base = os.path.join(BUILD, "smoke_mt_ubpl_branch")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = launch(branch_rank, make_mesh((2,), ("model",)), "cuda",
                   backend="gloo", args=(ref_path, base), timeout=900)
    run_s = time.perf_counter() - t0
    problems = [p for r in ranks for p in r["problems"]]
    paths64 = [ref["ranks64"].format(rank=r) for r in range(2)]
    got64 = [torch.load(p, weights_only=False) for p in paths64]
    f64 = float64_differences(
        {"metrics": metrics64, "nets": nets64},
        {"metrics": got64[0]["metrics"],
         "nets": {**got64[0]["nets"], **got64[1]["nets"]}})
    for path in [ref["views64"], ref_path] + paths64:
        os.remove(path)
    if not (f64["loss_rel"] <= 1e-9 and f64["grad_rel"] <= 1e-9
            and f64["weight_excess"] <= 2.5e-8):
        problems.append(f"float64 step differs from one process's: {f64}")
    if got64[0]["metrics"] != got64[1]["metrics"]:
        problems.append("the ranks return different float64 metrics")
    # fp32: every rank computes its branch on the whole batch as one
    # process does (the same cuDNN algorithms), and FDC's gradient is the
    # sum of two equal halves: the bounds are rounding's
    for r in ranks:
        for key in ("fp32", "fdc_only"):
            d = r["fp32"][key]
            if not (d["metric_rel_diff"] <= BRANCH_FP32_RTOL
                    and d["max_abs_diff"]["grad_rel_median"]
                    <= BRANCH_FP32_GRAD_MEDIAN):
                problems.append(f"rank {r['rank']}'s fp32 {key} step "
                                f"differs from one process's: "
                                f"{d['metric_rel_diff']} {d['max_abs_diff']}")
    if [r["bf16"]["networks"] for r in ranks] != [
            ["model1_state", "model1_ema_state"],
            ["model2_state", "model2_ema_state"]]:
        problems.append("branch i is not on model index i")
    files = serve_world_checkpoint(base)
    launches = {name: sum(r["launches"][name] for r in ranks)
                for name in ranks[0]["launches"]}
    cfg = dp_config()
    emit({"phase": "train_mt_ubpl_branch", "problems": problems,
          "regime": "MT_UBPL", "mesh": {"model": 2}, "ranks": 2,
          "backend": ranks[0]["backend"],
          "devices": [r["device"] for r in ranks], "model": cfg.model,
          "train_bs": cfg.train_bs, "train_bs_labeled": cfg.train_bs_labeled,
          "run_s": run_s, "rank_seconds": [r["seconds"] for r in ranks],
          "fp32_one_process": {k: ref[k]["metrics"]
                               for k in ("fp32", "fdc_only")},
          "fp32": [r["fp32"] for r in ranks],
          "float64_vs_one_process": f64,
          "bf16": [r["bf16"] for r in ranks],
          "checkpoint_files": files, "served_images": 8,
          "kernel_launches": launches, "kernel_launches_per_step_per_rank": 2})
    if problems:
        raise AssertionError("; ".join(problems))
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
            "--epochs=2", "--compute_dtype=bfloat16", "--mesh_shape=1",
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
            "--pseudo_aug_views=2", "--optimizer=mld", "--mesh_shape=1",
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
    # a round that selects nothing applies nothing (as in the JAX package):
    # the data hold the last round that selected keypoints
    applied = [r["selected"] for r in logs if r["selected"] > 0]
    selected = applied[-1] if applied else 0
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
                   "--mesh_shape=1", f"--experiment_root={exp}",
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


def captured_lines(fn, *args):
    """Run ``fn(*args)`` with stdout captured; (its result, the lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue().splitlines()


def bench_phase(counts, smi, phase, **env):
    """``python -m ubpl_torch bench`` in this process under ``env``: exit
    code 0, exactly one JSON line with ``bench.py``'s keys plus ``device``
    (this card's name and power limit) and ``baseline``, a finite positive
    value, and 2 heatmap launches per step (the warm-up and the timed
    ones).  Returns the launches."""
    from ubpl_torch import __main__ as CLI
    from ubpl_torch import bench as PB
    with mock.patch.dict(os.environ, env):
        steps = PB.env_knobs()["steps"]
        counts.reset()
        t0 = time.perf_counter()
        rc, lines = captured_lines(CLI.main, ["bench"])
        wall_s = time.perf_counter() - t0
        launches = counts.read()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"{phase}: exit {rc}, stdout {lines!r}")
    line = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "device", "baseline"}
    if set(line) != keys or line["device"] != smi:
        raise AssertionError(f"{phase}: line {line} (card {smi!r})")
    if not (math.isfinite(line["value"]) and line["value"] > 0):
        raise AssertionError(f"{phase}: value {line['value']}")
    if launches["heatmap_synth"] != 2 * (steps + 1):
        raise AssertionError(f"{phase}: {launches} heatmap launches in "
                             f"{steps + 1} steps")
    emit({"phase": phase, "line": line, "steps": steps,
          "kernel_launches": launches, "wall_s": wall_s})
    return launches


def phase_bench(counts, smi):
    return bench_phase(counts, smi, "bench")


def phase_bench_stream(counts, smi):
    return bench_phase(counts, smi, "bench_stream", UBPL_BENCH_STREAM="1")


def phase_mfu(counts, smi):
    """``bench.mfu_report`` at bs 32, 20 steps: flops per step within
    0.98-1.02x of 16 HG3 forwards per image (counted on the card), 2
    heatmap launches in each of its 21 steps, the line naming this card."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from ubpl_torch import bench as PB
    from ubpl_torch.models import create_pose_model
    bs, steps = 32, 20
    net = create_pose_model("HG3", 9).cuda().eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, 3, 256, 256, device="cuda"))
    per_image = counter.get_total_flops()
    del net
    counts.reset()
    rep = PB.mfu_report(bs, steps)
    launches = counts.read()
    ratio = rep["flops_per_step"] / (16 * per_image * rep["batch_size"])
    if not 0.98 <= ratio <= 1.02:
        raise AssertionError(f"mfu: {rep['flops_per_step']} flops per step "
                             f"is {ratio} x 16 forwards of {per_image}")
    if rep["device"] != smi or not 0 < rep["mfu"] < 1:
        raise AssertionError(f"mfu: report {rep} (card {smi!r})")
    if launches["heatmap_synth"] != 2 * (rep["steps"] + 1):
        raise AssertionError(f"mfu: {launches} heatmap launches")
    emit({"phase": "mfu", **rep, "forward_flops_per_image": per_image,
          "ratio_to_16_forwards": ratio, "kernel_launches": launches})
    return launches


def phase_serve_bench(counts, smi):
    """``bench.main_serving`` (``tools/bench_infer_torch.py``) at bs 1, 8,
    32, 64 with host input, then with input on the card: one line per
    batch size naming this card, finite positive rates, no heatmap
    launch (serving synthesises no targets)."""
    from ubpl_torch import bench as PB
    sizes = (1, 8, 32, 64)
    counts.reset()
    out = {}
    for mode, flag in (("host_input", "0"), ("device_input", "1")):
        with mock.patch.dict(os.environ, UBPL_INFER_DEVICE_INPUT=flag):
            rc, lines = captured_lines(PB.main_serving, sizes)
        rows = [json.loads(x) for x in lines]
        if rc != 0 or len(rows) != len(sizes) or not all(
                f"bs={b}," in r["metric"] for b, r in zip(sizes, rows)):
            raise AssertionError(f"serve_bench {mode}: {rc} {lines!r}")
        for r in rows:
            if r["device"] != smi or not (
                    math.isfinite(r["value"]) and r["value"] > 0
                    and r["latency_ms"] > 0):
                raise AssertionError(f"serve_bench {mode}: {r}")
        out[mode] = rows
    launches = counts.read()
    if launches["heatmap_synth"] != 0:
        raise AssertionError(f"serve_bench: {launches} heatmap launches")
    emit({"phase": "serve_bench", **out, "kernel_launches": launches})
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


def main(argv=None):
    """Every phase, or with ``--only=NAME[,NAME...]`` the kernel check and
    the named phases alone (``train_mt_ubpl_dp``, ``cli_mt_ubpl_mesh``,
    ``dp_nccl`` ...: a phase's name without ``phase_``)."""
    import torch
    argv = sys.argv[1:] if argv is None else argv
    only = None
    for arg in argv:
        if not arg.startswith("--only="):
            print(f"chip_smoke: unknown argument {arg!r}", file=sys.stderr)
            return 2
        only = set(arg[len("--only="):].split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    counts = Counts()       # imports the port: fails first outside a checkout
    os.makedirs(BUILD, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def want(name):
        return only is None or name in only

    smi = phase_env()
    records = {"heatmap_synth": phase_kernel_heatmap(),
               "batch_norm_relu": phase_kernel_batch_norm_relu()}
    if want("reference"):
        phase_reference()
    paths = [phase(counts) for phase in (phase_serve, phase_train)
             if want(phase.__name__[len("phase_"):])]
    if want("train_mt_ubpl"):
        launches, resident_ms = phase_train_mt_ubpl(counts)
        paths += [launches, phase_train_mt_ubpl_mld(counts),
                  phase_train_mt_ubpl_stream(counts, resident_ms),
                  phase_train_mt(counts)]
    if want("train_mt_ubpl_dp"):
        paths.append(phase_train_mt_ubpl_dp(counts))
    if want("cli_mt_ubpl_mesh"):
        paths.append(phase_cli_mt_ubpl_mesh(counts))
    if want("dp_nccl") and torch.cuda.device_count() >= 2:
        phase_dp_nccl()
    if want("train_mt_ubpl_branch"):
        paths.append(phase_train_mt_ubpl_branch(counts))
    if want("cli_mt_ubpl_model"):
        paths.append(phase_cli_mt_ubpl_model(counts))
    if want("model_nccl") and torch.cuda.device_count() >= 2:
        paths.append(phase_model_nccl())
    paths += [phase(counts, smi) for phase in (
        phase_bench, phase_bench_stream, phase_mfu, phase_serve_bench)
        if want(phase.__name__[len("phase_"):])]
    if only is None:
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
        rec["launches"] = sum(launches.get(name, 0) for launches in paths)
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
