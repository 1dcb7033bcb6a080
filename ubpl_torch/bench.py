"""The port's measuring layer: MT_UBPL training throughput, serving
throughput and latency, and flops per training step with MFU.

Counterpart of the JAX package's three measuring scripts, which sit beside
``ubpl_tpu/`` (``python -m ubpl_tpu bench`` runs ``bench.py``,
``ubpl_tpu/__main__.py:72-81``):

  * ``bench.py:64-147`` (``measure_ours``) and ``:302-360``
    (``_result_line``, ``main``): ``bench_config``, ``measure_ours``,
    ``result_line`` and ``main``.  One JSON line on stdout with
    ``bench.py``'s keys (``metric``, ``value``, ``unit``,
    ``vs_baseline``) plus ``device`` and ``baseline``;
  * ``tools/bench_infer.py:34-90``: ``measure_serving``, ``serving_line``
    and ``main_serving``, one JSON line per batch size;
  * ``tools/mfu.py:29-83``: ``step_flops``, ``mfu_report`` and
    ``main_mfu``.

Entry points: ``python -m ubpl_torch bench``, ``bench_torch.py``,
``tools/bench_infer_torch.py`` and ``tools/mfu_torch.py``.  They run on the
card unless ``--device=cpu`` is given.  ``device`` in every line is the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, or ``"cpu"``: a CPU figure is never
printed as a card's.

``UBPL_BENCH_BS``, ``_STEPS``, ``_STREAM``, ``_FOLD`` and ``_REMAT`` are
read as in ``bench.py``.  The knobs that steer only the XLA program
(``scan_batches``, ``fuse_teacher_forward``, ``unroll_branches``,
``scan_branches``) are set in the ``Config`` as ``bench.py`` sets them by
default; the port ignores them.  The port always takes one batch per step:
``value`` is ``batch_size * steps`` over the timed window.

Where ``bench.py`` differs on purpose:

  * ``vs_baseline`` divides by the committed ``BENCH_BASELINE.json``
    (the reference PyTorch MT_UBPL loop on a host CPU at bs 4, the
    denominator of the JAX package's line).  The reference itself is not
    in the repository, so it is never measured here; without the file the
    bench raises.
  * There is no stale fallback: ``bench.py:240-360`` replays an older
    number when the step raises or on SIGTERM and writes
    ``BENCH_LAST.json``.  Here an exception propagates (non-zero exit, no
    line) and nothing is written.

Flops come from ``torch.utils.flop_counter.FlopCounterMode`` over one real
training step (``step_flops``), where ``tools/mfu.py`` reads XLA's
``cost_analysis``.  The two count convolutions differently: the counter
counts every k x k tap of each output position, the zero padding's
included (the work cuDNN's implicit GEMM does), while XLA counts only the
taps that fall inside the image and adds the elementwise ops.  At 64 px
an HG1 forward is 6.429e8 flops per image by the counter, 6.026e8 in-image
taps and 6.084e8 by XLA.  XLA's "bytes accessed" has no torch counterpart
and is not reported.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import Config
from .device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "BENCH_BASELINE.json")
BASELINE_NOTE = "reference PyTorch MT_UBPL loop, host CPU, bs 4"
#: the measured shape (``bench.py:85-87``, ``tools/bench_infer.py:41``)
SHAPE = {"model": "HG3", "inp_res": 256, "out_res": 64}
UNIT = "images/sec/chip"

_T0 = time.perf_counter()


def _phase(name):
    """Wall-clock phase marker on stderr (stdout carries only the line)."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {name}",
          file=sys.stderr, flush=True)


def _flag(name):
    return os.environ.get(name, "0") == "1"


def env_knobs():
    """The ``UBPL_BENCH_*`` settings that act, read and defaulted as
    ``bench.py`` reads them."""
    return {"bs": int(os.environ.get("UBPL_BENCH_BS", "32")),
            "steps": int(os.environ.get("UBPL_BENCH_STEPS", "20")),
            "fold": _flag("UBPL_BENCH_FOLD"),
            "remat": _flag("UBPL_BENCH_REMAT"),
            "stream": _flag("UBPL_BENCH_STREAM")}


def bench_config(batch_size, stream=False, fold=False, remat=False) -> Config:
    """The ``Config`` of ``bench.py:85-98``, field for field, with the XLA
    knobs at ``bench.py``'s defaults for ``UBPL_BENCH_BS=batch_size``."""
    scan = 1 if stream or batch_size > 8 else 8
    cfg = Config(model=SHAPE["model"], synthetic_data=True, synthetic_kps=9,
                 inp_res=SHAPE["inp_res"], out_res=SHAPE["out_res"],
                 train_count=max(2 * batch_size, 64), valid_count=8,
                 label_ratio=0.5, train_bs=batch_size,
                 train_bs_labeled=batch_size // 2, infer_bs=8, epochs=1,
                 compute_dtype="bfloat16", scan_batches=scan,
                 fuse_teacher_forward=False, fold_views=fold,
                 unroll_branches=None, remat=remat, stream_data=stream,
                 scan_branches=False)
    cfg.pck_ref = (1, 2)
    cfg.pck_thr = 0.2
    return cfg


def sched_args(sched):
    """An epoch schedule dict -> the step's positional schedule arguments."""
    return (sched["cons_weight"], sched["fdl_weight"],
            sched["pseudo_weight"], sched["ema_alpha"])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def index_batches(trainer, n):
    """``n`` index batches of the trainer's sampler, cycled as
    ``bench.py:106-114`` cycles it."""
    out, it = [], iter(trainer.make_sampler())
    while len(out) < n:
        try:
            out.append(np.asarray(next(it)))
        except StopIteration:
            it = iter(trainer.make_sampler())
    return out


def train_window(trainer, batches, args):
    """Seconds that ``run_train_steps`` takes over ``batches``, one call
    per batch (or one streamed call), in a window with a synchronise at
    each end and none inside."""
    dev = trainer.device
    _sync(dev)
    t0 = time.perf_counter()
    if trainer.cfg.stream_data:
        trainer.run_train_steps(batches, *args)
    else:
        for b in batches:
            trainer.run_train_steps([b], *args)
    _sync(dev)
    return time.perf_counter() - t0


def measure_ours(batch_size=None, steps=None, fold=None, remat=None,
                 stream=None, device=None):
    """MT_UBPL training throughput in images/s (``bench.py:64-147``).
    Knobs left unset take the ``UBPL_BENCH_*`` settings.  One warm-up step
    (cuDNN's first algorithm choice, the Triton kernel's build), then
    ``steps`` steps in one ``train_window``; with ``stream`` the streamed
    path (``train/streaming.py``) over pre-drawn index batches."""
    from .train.mt_ubpl import MTUBPLTrainer
    knobs = env_knobs()
    given = {"bs": batch_size, "steps": steps, "fold": fold, "remat": remat,
             "stream": stream}
    knobs.update({k: v for k, v in given.items() if v is not None})
    bs, n = knobs["bs"], knobs["steps"]
    cfg = bench_config(bs, stream=knobs["stream"], fold=knobs["fold"],
                       remat=knobs["remat"])
    _phase("constructing trainer")
    trainer = MTUBPLTrainer(cfg, device=device)
    _phase("trainer constructed (dataset staged, networks built)")
    args = sched_args(trainer.epoch_schedules(0))
    batches = index_batches(trainer, n + 1)
    _phase("warm-up step")
    train_window(trainer, batches[:1], args)
    _phase("warm-up done, measuring")
    dt = train_window(trainer, batches[1:], args)
    _phase(f"{n} steps in {dt:.3f} s")
    return bs * n / dt


def device_label(device):
    """``"cpu"``, or the card's ``name, power.limit`` from nvidia-smi.  The
    card is named by its UUID: torch's ordinal need not be nvidia-smi's
    index (``CUDA_VISIBLE_DEVICES``, CUDA's fastest-first order)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    if not uuid.startswith("GPU-"):
        uuid = f"GPU-{uuid}"
    out = subprocess.run(
        ["nvidia-smi", f"--id={uuid}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _on(label, what):
    if label == "cpu":
        return f"{what} on cpu (fp32, not a card figure)"
    return f"{what} on {label}"


def load_baseline():
    """The committed baseline; raises where the file is missing."""
    with open(BASELINE) as f:
        return json.load(f)["reference_torch_cpu_images_per_sec"]


def result_line(value, ref, label, batch_size):
    """``bench.py:_result_line``'s keys and rounding, plus ``device`` and
    ``baseline``."""
    what = (f"ubpl_torch MT_UBPL train throughput ({SHAPE['model']}, "
            f"{SHAPE['inp_res']}->{SHAPE['out_res']}, bs={batch_size}, "
            "bf16, incl. on-device augmentation)")
    return json.dumps({"metric": _on(label, what), "value": round(value, 2),
                       "unit": UNIT, "vs_baseline": round(value / ref, 2),
                       "device": label, "baseline": BASELINE_NOTE})


def main(device=None):
    """``python -m ubpl_torch bench``: print the one line; returns 0."""
    dev = resolve_device(device)
    ref = load_baseline()
    label = device_label(dev)
    value = measure_ours(device=dev)
    print(result_line(value, ref, label, env_knobs()["bs"]), flush=True)
    return 0


# ------------------------------------------------------------------ serving
def measure_serving(batch_size, model="HG3", steps=30, device=None,
                    device_input=False, chunks=1):
    """``PoseEstimator`` throughput and latency (``tools/bench_infer.py:
    34-78``): randomly initialised ``model``, bf16, means 0.45, uint8
    images from ``default_rng(0)``; one warm call, then ``steps`` timed
    calls.  ``device_input`` drives ``predict_keypoints`` on a batch
    already on the device (no host copy, ``chunks`` 1); otherwise each
    call is ``predict`` of ``batch_size * chunks`` host images.  Returns
    (images/s, ms per call)."""
    from .infer import PoseEstimator
    from .models import create_pose_model
    from .train.common import predict_keypoints
    dev = resolve_device(device)
    cfg = Config(model=model, compute_dtype="bfloat16", kps_count=9,
                 inp_res=SHAPE["inp_res"], out_res=SHAPE["out_res"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = create_pose_model(model, cfg.kps_count, cfg.feature_mode)
    est = PoseEstimator(net, net.state_dict(), (0.45, 0.45, 0.45), cfg,
                        batch_size=batch_size, device=dev)
    if device_input:
        chunks = 1
    R = cfg.inp_res
    imgs = np.random.default_rng(0).integers(
        0, 256, (batch_size * chunks, R, R, 3), dtype=np.uint8)
    if device_input:
        imgs_d = torch.as_tensor(imgs).to(dev)

        def call():
            with torch.inference_mode():
                return predict_keypoints(est.model, imgs_d, est.means, cfg)
    else:
        def call():
            return est.predict(imgs)
    call()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        call()
    _sync(dev)
    dt = time.perf_counter() - t0
    return imgs.shape[0] * steps / dt, dt / steps * 1e3


def serving_mode(device_input, chunks):
    if device_input:
        return "device-resident input"
    mode = "host input (uint8 numpy, host-to-device copy included)"
    if chunks > 1:
        mode += f", {chunks} pipelined chunks/request"
    return mode


def serving_line(batch_size, ips, ms, mode, label):
    """``tools/bench_infer.py:86-90``'s keys plus ``device``."""
    what = (f"ubpl_torch PoseEstimator serving throughput ({SHAPE['model']}, "
            f"bs={batch_size}, uint8 in -> keypoints out, {mode})")
    return json.dumps({"metric": _on(label, what), "value": round(ips, 2),
                       "unit": UNIT, "latency_ms": round(ms, 2),
                       "device": label})


def main_serving(sizes=(1, 8, 32, 64), device=None):
    """``tools/bench_infer_torch.py``: one line per batch size, the mode
    from ``UBPL_INFER_DEVICE_INPUT`` / ``UBPL_INFER_CHUNKS`` and the steps
    from ``UBPL_BENCH_STEPS`` (default 30).  Returns 0."""
    dev = resolve_device(device)
    label = device_label(dev)
    device_input = _flag("UBPL_INFER_DEVICE_INPUT")
    chunks = 1 if device_input else int(
        os.environ.get("UBPL_INFER_CHUNKS", "1"))
    steps = int(os.environ.get("UBPL_BENCH_STEPS", "30"))
    mode = serving_mode(device_input, chunks)
    for bs in sizes:
        ips, ms = measure_serving(bs, SHAPE["model"], steps, dev,
                                  device_input=device_input, chunks=chunks)
        print(serving_line(bs, ips, ms, mode, label), flush=True)
    return 0


# ---------------------------------------------------------------- flops, MFU
def peak_tflops():
    """``UBPL_PEAK_TFLOPS`` (as ``tools/mfu.py:25``), by default 989.4: the
    H100 SXM's dense bf16 tensor-core peak from NVIDIA's H100 data sheet
    (1,979 TFLOP/s with sparsity)."""
    return float(os.environ.get("UBPL_PEAK_TFLOPS", "989.4"))


def step_flops(trainer, idxs, sched):
    """Flops of one real training step on batch ``idxs`` (the step is
    taken), by ``FlopCounterMode``: convolutions forward and backward and
    any matmul, every tap counted (see the module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        trainer.run_train_steps([idxs], *sched_args(sched))
    return counter.get_total_flops()


def mfu_report(batch_size=32, steps=20, device=None):
    """``tools/mfu.py:29-83``: the MT_UBPL step of ``bench_config`` with
    ``mfu.py``'s ``train_count``; its flops (``step_flops``, which is also
    the warm-up step), then ``steps`` steps on the same batch in one
    ``train_window``, whose mean step time (window / ``steps``, as in
    ``mfu.py``) gives TFLOP/s and MFU.  Returns the report as a dict."""
    from .train.mt_ubpl import MTUBPLTrainer
    cfg = bench_config(batch_size)
    cfg.train_count = max(4 * batch_size, 64)
    trainer = MTUBPLTrainer(cfg, device=device)
    sched = trainer.epoch_schedules(0)
    idxs = index_batches(trainer, 1)[0]
    flops = step_flops(trainer, idxs, sched)
    dt = train_window(trainer, [idxs] * steps, sched_args(sched)) / steps
    label, peak = device_label(trainer.device), peak_tflops()
    achieved = flops / dt / 1e12
    return {"device": label, "model": SHAPE["model"],
            "batch_size": batch_size, "steps": steps,
            "flops_per_step": flops, "step_ms": dt * 1e3,
            "images_per_s": batch_size / dt, "achieved_tflops": achieved,
            "peak_tflops": peak,
            # a share of the card's peak: not for a CPU run
            "mfu": None if label == "cpu" else achieved / peak}


def main_mfu(batch_size=32, steps=20, device=None):
    """``tools/mfu_torch.py``: print the report; returns 0."""
    r = mfu_report(batch_size, steps, device)
    print(f"device = {r['device']}   {r['model']} bs={r['batch_size']}")
    print(f"flops/step (FlopCounterMode, padded taps) = "
          f"{r['flops_per_step']:.4e}")
    print(f"step time (mean of {r['steps']}) = {r['step_ms']:.2f} ms   "
          f"images/s = {r['images_per_s']:.2f}")
    mfu = ("not measured (cpu)" if r["mfu"] is None
           else f"{100 * r['mfu']:.3f}%")
    print(f"achieved = {r['achieved_tflops']:.3f} TFLOP/s   MFU vs "
          f"{r['peak_tflops']} TF bf16 peak = {mfu}   ({r['device']})")
    return 0
