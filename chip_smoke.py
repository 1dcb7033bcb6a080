"""Smoke run of the PyTorch port (``ubpl_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Builds every hand-written kernel from the checkout, holds each against its
plain PyTorch version on the card, then drives the port's paths at full
width through their user entry points:

  * serve: ``PoseEstimator`` (HG3, K=9, 256->64, bf16, batch 32) answers
    3 requests of 50 images (ragged last chunk), weights loaded through
    ``models/weights.py`` from a seeded random reference-layout checkpoint;
  * train: ``SupervisedTrainer`` (HG3, K=9, bf16, bs 32, synthetic data)
    takes 8 steps — one heatmap-kernel launch per step — then validates.

It also runs the port's HG2 on the reference golden
(``tests/goldens/torch_import_hg2.npz``) in fp32 with TF32 off and holds it
to the reference outputs.  One JSON line per phase; the line before the
last lists every kernel with its launches on the paths, its error against
the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0,
no result line).  Without CUDA it exits 2 before doing anything.

Build outputs (Triton cache, the smoke checkpoint) go to ``.kernel_build/``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(REPO, ".kernel_build")
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


def phase_train(counts):
    import torch
    from ubpl_torch.config import Config
    from ubpl_torch.data.sampler import supervised_epoch_batches
    from ubpl_torch.ops.kernels import heatmap_synth as HS
    from ubpl_torch.train.supervised import SupervisedTrainer
    n_steps, bs = 8, 32
    cfg = Config(model="HG3", synthetic_data=True, synthetic_kps=9,
                 inp_res=256, out_res=64, train_count=256, valid_count=64,
                 label_ratio=1.0, train_bs=bs, infer_bs=32,
                 compute_dtype="bfloat16")
    tr = SupervisedTrainer(cfg, device="cuda")
    batches = supervised_epoch_batches(tr.labeled_idxs, bs, tr.rng)[:n_steps]
    if len(batches) != n_steps:
        raise AssertionError(f"only {len(batches)} batches")
    counts.reset()
    step_ms, losses = [], []
    for i, idxs in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.run_train_steps([idxs])[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["pec_loss"]))
        if HS.launches != i + 1:
            raise AssertionError(f"heatmap kernel launched {HS.launches} "
                                 f"times in {i + 1} steps")
    _, accs, errs = tr.validate()
    launches = counts.read()
    if not (np.isfinite(losses).all() and np.isfinite(accs[0]).all()
            and np.isfinite(errs[0]).all()):
        raise AssertionError(f"non-finite loss/PCK: {losses} {accs} {errs}")
    steady = statistics.median(step_ms[1:])
    emit({"phase": "train", "regime": "supervised", "model": "HG3",
          "dtype": "bfloat16", "train_bs": bs, "steps": n_steps,
          "step_ms": step_ms, "steady_step_ms_median": steady,
          "images_per_s": bs / steady * 1e3, "pec_loss": losses,
          "valid_pck_mean": accs[0][-1], "kernel_launches": launches})
    profile_steps(tr, batches[:3], steady)
    return launches


def profile_steps(tr, batches, step_ms):
    """torch.profiler over a few more training steps (after the counted
    run): device time per step by kernel and by kind, and the device's idle
    share of the unprofiled step time `step_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run_train_steps(batches)
        torch.cuda.synchronize()
    n = len(batches)
    # kernels only: user annotations ("Optimizer.step#...") also appear on
    # the device timeline, spanning their kernels and the gaps between them
    dev = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "#" not in e.key
           and not getattr(e, "is_user_annotation", False)]
    kinds = {"convolution": ("conv", "xmma", "cutlass", "gemm", "cudnn",
                             "implicit"),
             "batchnorm": ("batch_norm",),
             "optimizer": ("multi_tensor", "foreach", "adam"),
             "heatmap_synth": ("heatmap_synth",)}
    by_kind = {k: 0.0 for k in list(kinds) + ["other"]}
    for key, ms, _ in dev:
        low = key.lower()
        kind = next((k for k, pats in kinds.items()
                     if any(p in low for p in pats)), "other")
        by_kind[kind] += ms
    busy_ms = sum(d[1] for d in dev)
    top = sorted(dev, key=lambda d: -d[1])[:12]
    emit({"phase": "train_profile", "steps": n,
          "device_busy_ms_per_step": busy_ms, "step_ms": step_ms,
          "idle_share": (1 - busy_ms / step_ms) if busy_ms else None,
          "device_ms_per_step_by_kind": by_kind,
          "top_kernels_ms_per_step": [[k[:100], t, c] for k, t, c in top]})


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
    serve_launches = phase_serve(counts)
    train_launches = phase_train(counts)
    for name, rec in records.items():
        rec["launches"] = serve_launches[name] + train_launches[name]
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
