"""The port's measuring layer (``ubpl_torch/bench.py``) against the JAX
package's measuring scripts: ``bench.py``'s ``Config`` and result line,
``tools/bench_infer.py``'s lines, and flop counts against XLA's
``cost_analysis``; the measurements themselves on the CPU at a tiny shape
(HG1, 64 -> 16, bs 2, 1-2 steps), the paths they take, and their refusals.

The JAX side runs no step program: ``bench.measure_ours`` stops at a stub
trainer that carries its ``Config`` out, and the flop comparison compiles
one HG1 and one HG2 forward for their ``cost_analysis``.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench as JB
import ubpl_tpu.train.mt_ubpl as JMT
import ubpl_tpu.utils.xla_cache as JXC
from ubpl_torch import bench as PB
from ubpl_torch.infer import PoseEstimator
from ubpl_torch.models import create_pose_model
from ubpl_torch.train import common as PCOM
from ubpl_torch.train import mt_ubpl as PMT
from ubpl_torch.train.base_trainer import BaseTrainer
from ubpl_torch.train.streaming import BatchStreamer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model": "HG1", "inp_res": 64, "out_res": 16}
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """The measured shape cut to HG1, 64 -> 16."""
    monkeypatch.setattr(PB, "SHAPE", dict(TINY))
    for k in ("BS", "STEPS", "FOLD", "REMAT", "STREAM"):
        monkeypatch.delenv(f"UBPL_BENCH_{k}", raising=False)


class _Built(Exception):
    """Raised by a stub trainer: carries the ``Config`` it was given."""

    def __init__(self, cfg):
        super().__init__("trainer stub")
        self.cfg = cfg


def _stub_trainer(cfg, *args, **kwargs):
    raise _Built(cfg)


# ------------------------------------------------------------------- config
VARIANTS = {"plain": {}, "stream": {"stream": True}, "fold": {"fold": True},
            "remat": {"remat": True}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("bs", [4, 32])
def test_bench_config_equals_bench_py(monkeypatch, bs, variant):
    """``bench_config`` and the port's ``measure_ours`` build exactly the
    ``Config`` that ``bench.measure_ours`` builds, field for field (bar the
    package's program tag).  ``bench.py`` takes its default scan from
    ``UBPL_BENCH_BS`` when it is imported; it is passed here as
    ``UBPL_BENCH_BS=bs python bench.py`` would set it."""
    kw = VARIANTS[variant]
    for k in ("BS", "STEPS", "STREAM", "FOLD", "REMAT"):
        monkeypatch.delenv(f"UBPL_BENCH_{k}", raising=False)
    monkeypatch.setattr(JMT, "MTUBPLTrainer", _stub_trainer)
    monkeypatch.setattr(JXC, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(PMT, "MTUBPLTrainer", _stub_trainer)
    with pytest.raises(_Built) as theirs:
        JB.measure_ours(batch_size=bs, scan=8 if bs <= 8 else 1, fuse=False,
                        unroll=None, scanbr=False, **kw)
    with pytest.raises(_Built) as ours:
        PB.measure_ours(batch_size=bs, **kw)
    mine = PB.bench_config(bs, **kw)
    fields = [f.name for f in dataclasses.fields(theirs.value.cfg)]
    assert set(fields) == {f.name for f in dataclasses.fields(mine)}
    for name in fields:
        if name == "program":
            continue
        want = getattr(theirs.value.cfg, name)
        assert getattr(mine, name) == want, name
        assert getattr(ours.value.cfg, name) == want, name
    assert mine.scan_batches == (1 if kw.get("stream") or bs > 8 else 8)
    assert (mine.model, mine.inp_res, mine.out_res) == ("HG3", 256, 64)


# -------------------------------------------------------------------- lines
@pytest.mark.parametrize("label", ["cpu", CARD])
def test_result_line_has_bench_py_keys(label):
    """The line has ``bench._result_line``'s keys, value and rounding,
    plus ``device`` and ``baseline``; a CPU line says cpu, a card's names
    the card."""
    value, ref = 46.123456, PB.load_baseline()
    theirs = json.loads(JB._result_line(value, ref))
    ours = json.loads(PB.result_line(value, ref, label, 32))
    assert set(ours) == set(theirs) | {"device", "baseline"}
    for k in ("value", "unit", "vs_baseline"):
        assert ours[k] == theirs[k], k
    assert ours["vs_baseline"] == round(value / ref, 2)
    assert ours["device"] == label and label in ours["metric"]
    assert "bs=32" in ours["metric"] and "ubpl_torch" in ours["metric"]
    assert ("cpu" in ours["metric"]) == (label == "cpu")
    assert ours["baseline"] == ("reference PyTorch MT_UBPL loop, host CPU, "
                                "bs 4")


def test_device_label_names_the_card_by_uuid(monkeypatch):
    """nvidia-smi is asked for the card by its UUID, not torch's ordinal,
    which ``CUDA_VISIBLE_DEVICES`` or CUDA's order can make another
    card's index."""
    calls = []

    class Props:
        uuid = "23514acb-3bc7-fd86-314d-6a0b2d5d81fb"

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=CARD + "\n")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props if i == 1 else None)
    monkeypatch.setattr(PB.subprocess, "run", run)
    assert PB.device_label(torch.device("cuda")) == CARD
    assert calls[0][1] == f"--id=GPU-{Props.uuid}"
    assert PB.device_label("cpu") == "cpu" and len(calls) == 1


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("device_input", [False, True])
def test_serving_lines_have_bench_infer_keys(monkeypatch, device_input):
    """``tools/bench_infer.py``'s lines (its ``measure`` stubbed) and the
    port's: the same keys plus ``device``, one line per batch size."""
    tool = _load_tool("bench_infer")
    monkeypatch.setattr(tool, "measure", lambda bs: (1.0, 2.0))
    monkeypatch.setenv("UBPL_INFER_DEVICE_INPUT", "1" if device_input else "0")
    monkeypatch.setattr(sys, "argv", ["bench_infer.py", "1", "8"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tool.main()
    theirs = [json.loads(s) for s in out.getvalue().splitlines()]
    mode = PB.serving_mode(device_input, 1)
    ours = [json.loads(PB.serving_line(bs, 1.0, 2.0, mode, "cpu"))
            for bs in (1, 8)]
    assert len(theirs) == len(ours) == 2
    for t, o in zip(theirs, ours):
        assert set(o) == set(t) | {"device"}
        assert (o["value"], o["unit"], o["latency_ms"]) == (
            t["value"], t["unit"], t["latency_ms"])
        assert o["device"] == "cpu" and "cpu" in o["metric"]
    assert ("device-resident" in ours[0]["metric"]) == device_input


# ------------------------------------------------------------- measurements
def _spy(monkeypatch, owner, name):
    calls = []
    real = getattr(owner, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(owner, name, spy)
    return calls


@pytest.mark.parametrize("stream", [False, True])
def test_measure_ours_on_cpu(monkeypatch, tiny, stream):
    """Finite positive images/s from 1 + steps steps through
    ``run_train_steps``: one call per step, or (stream) the streamed path
    over pre-drawn batches, one call for the warm-up and one for the
    window, with scan forced to 1."""
    steps = 1
    runs = _spy(monkeypatch, BaseTrainer, "run_train_steps")
    puts = _spy(monkeypatch, BatchStreamer, "put")
    built = []
    real_init = PMT.MTUBPLTrainer.__init__

    def init(self, cfg, *a, **k):
        built.append(cfg)
        real_init(self, cfg, *a, **k)
    monkeypatch.setattr(PMT.MTUBPLTrainer, "__init__", init)
    value = PB.measure_ours(batch_size=2, steps=steps, stream=stream,
                            device="cpu")
    assert math.isfinite(value) and value > 0
    n_batches = [len(list(r[1])) if stream else len(r[1]) for r in runs]
    if stream:
        assert len(runs) == 2 and len(puts) == 1 + steps
        assert built[0].stream_data and built[0].scan_batches == 1
    else:
        assert len(runs) == 1 + steps and n_batches == [1] * (1 + steps)
        assert puts == [] and not built[0].stream_data
    assert (built[0].model, built[0].inp_res) == ("HG1", 64)


@pytest.mark.parametrize("device_input", [False, True])
def test_measure_serving_on_cpu(monkeypatch, device_input):
    """Finite positive images/s and latency from one warm and ``steps``
    timed calls; ``device_input`` drives ``predict_keypoints`` on the
    staged batch and never touches ``predict`` or its host buffers."""
    monkeypatch.setattr(PB, "SHAPE", dict(TINY))
    steps = 2
    predicts = _spy(monkeypatch, PoseEstimator, "predict")
    hosts = _spy(monkeypatch, PoseEstimator, "_host_buffer")
    forwards = _spy(monkeypatch, PCOM, "predict_keypoints")
    ips, ms = PB.measure_serving(2, model="HG1", steps=steps, device="cpu",
                                 device_input=device_input, chunks=2)
    assert math.isfinite(ips) and ips > 0 and math.isfinite(ms) and ms > 0
    if device_input:
        assert predicts == [] and hosts == []
        assert len(forwards) == 1 + steps
        assert {id(f[1]) for f in forwards} == {id(forwards[0][1])}
        assert forwards[0][1].shape == (2, 64, 64, 3)
    else:
        assert len(predicts) == 1 + steps
        assert predicts[0][1].shape == (4, 64, 64, 3)    # 2 chunks of 2


# ----------------------------------------------------------------- refusals
def test_failing_step_exits_nonzero_without_a_line(tmp_path):
    """``bench_torch.py`` whose trainer raises: non-zero exit, nothing on
    stdout, no file written in its working directory."""
    code = (
        "import runpy, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import ubpl_torch.train.mt_ubpl as M\n"
        "def boom(self, *a, **k):\n"
        "    raise RuntimeError('step failed')\n"
        "M.MTUBPLTrainer.__init__ = boom\n"
        f"sys.argv = [{os.path.join(REPO, 'bench_torch.py')!r}, "
        "'--device=cpu']\n"
        "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "step failed" in r.stderr
    assert os.listdir(tmp_path) == []


def test_failing_step_raises_in_process(monkeypatch, capsys):
    """In process the exception propagates from ``main`` and no line is
    printed (there is no stale replay)."""
    monkeypatch.setattr(PMT.MTUBPLTrainer, "__init__", _stub_trainer)
    with pytest.raises(_Built):
        PB.main("cpu")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("entry", ["main", "measure_serving", "mfu_report"])
def test_no_device_means_the_card(monkeypatch, entry):
    """Without ``device`` every measurement wants CUDA and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"main": lambda: PB.main(),
            "measure_serving": lambda: PB.measure_serving(1),
            "mfu_report": lambda: PB.mfu_report(2, 1)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_missing_baseline_raises(monkeypatch, tmp_path):
    """Without ``BENCH_BASELINE.json`` the bench raises before it
    measures; it never measures the reference."""
    monkeypatch.setattr(PB, "BASELINE", str(tmp_path / "missing.json"))
    monkeypatch.setattr(PMT, "MTUBPLTrainer", _stub_trainer)
    with pytest.raises(FileNotFoundError):
        PB.main("cpu")


@pytest.mark.parametrize("script", ["bench_torch.py",
                                    "tools/bench_infer_torch.py",
                                    "tools/mfu_torch.py"])
def test_entry_scripts_import_only_the_port(script):
    """The three scripts import ``ubpl_torch`` and the standard library,
    nothing of JAX or the JAX package."""
    with open(os.path.join(REPO, script)) as f:
        src = f.read()
    mods = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert "ubpl_torch" in {m.split(".")[0] for m in mods}
    assert {m.split(".")[0] for m in mods} <= {"os", "sys", "ubpl_torch"}


# -------------------------------------------------------------------- flops
def _conv_counts(model, x):
    """(every tap, in-image taps only) flops of the model's Conv2d calls
    on ``x``, from each conv's input shape, kernel, stride and padding."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, inp, out: seen.append((m, inp[0].shape)))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    padded = inside = 0
    for m, (B, _, H, W) in seen:
        per_tap = 2 * B * m.out_channels * (m.in_channels // m.groups)
        taps = []
        for size, k, s, p, d in zip((H, W), m.kernel_size, m.stride,
                                     m.padding, m.dilation):
            n_out = (size + 2 * p - d * (k - 1) - 1) // s + 1
            taps.append((n_out * k, sum(
                0 <= o * s - p + j * d < size
                for o in range(n_out) for j in range(k))))
        padded += per_tap * taps[0][0] * taps[1][0]
        inside += per_tap * taps[0][1] * taps[1][1]
    return padded, inside


@pytest.fixture(scope="module")
def forward_counts():
    """Per model at 64 px, bs 2: the torch counter's total and the
    analytic padded and in-image conv counts of the port's forward."""
    out = {}
    for name in ("HG1", "HG2"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = create_pose_model(name, 9).eval()
        x = torch.randn(2, 3, 64, 64)
        with FlopCounterMode(display=False) as counter:
            with torch.no_grad():
                model(x)
        out[name] = (counter.get_total_flops(), *_conv_counts(model, x))
    return out


@pytest.fixture(scope="module")
def xla_flops():
    """XLA's ``cost_analysis`` flops of the JAX package's eval forward at
    the same shapes (compiled from shapes only; nothing runs)."""
    from ubpl_tpu.models import create_pose_model as jax_pose_model
    x = jax.ShapeDtypeStruct((2, 64, 64, 3), jnp.float32)
    out = {}
    for name in ("HG1", "HG2"):
        net = jax_pose_model(name, 9, "AvgPool")
        variables = jax.eval_shape(
            lambda key, s: net.init(key, s, train=False),
            jax.random.PRNGKey(0), x)
        cost = jax.jit(lambda v, s: net.apply(v, s, train=False)).lower(
            variables, x).compile().cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        out[name] = float(cost["flops"])
    return out


@pytest.mark.parametrize("name", ["HG1", "HG2"])
def test_flop_counter_equals_padded_conv_count(forward_counts, name):
    """``FlopCounterMode`` on the port's forward is exactly 2 x every tap
    of every convolution, the padding's included."""
    counted, padded, inside = forward_counts[name]
    assert counted == padded
    assert inside < padded


@pytest.mark.parametrize("name", ["HG1", "HG2"])
def test_in_image_count_within_xla_cost_analysis(forward_counts, xla_flops,
                                                 name):
    """Counting only the in-image taps, the port's forward lies 0-1.5%
    below XLA's count of the JAX forward (XLA adds the elementwise ops;
    measured 0.96% at HG1 and 0.90% at HG2)."""
    _, _, inside = forward_counts[name]
    gap = xla_flops[name] / inside - 1
    assert 0 <= gap <= 0.015, gap


def test_mfu_report_counts_sixteen_forwards_per_image(forward_counts, tiny,
                                                     monkeypatch):
    """One MT_UBPL step is 16 forwards per image (2 students x 2 views x
    forward + backward, 2 teachers x 2 views), less the first conv's input
    gradient: 0.98-1.02x (measured 0.9925 at HG1).  The flop step is the
    warm-up; the time is one ``train_window`` over ``steps`` steps on the
    same batch, as ``tools/mfu.py`` times it.  On the CPU the report gives
    no MFU."""
    steps = 2
    windows = _spy(monkeypatch, PB, "train_window")
    r = PB.mfu_report(batch_size=2, steps=steps, device="cpu")
    assert len(windows) == 1 and len(windows[0][1]) == steps
    assert all(b is windows[0][1][0] for b in windows[0][1])
    per_image = forward_counts["HG1"][0] / 2
    ratio = r["flops_per_step"] / (16 * per_image * 2)
    assert 0.98 <= ratio <= 1.02, ratio
    assert r["device"] == "cpu" and r["mfu"] is None
    assert r["step_ms"] > 0 and r["achieved_tflops"] > 0


@pytest.mark.cuda
def test_serving_on_the_card_names_it(tiny):
    """On a card the serving bench runs there and its line names it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ips, ms = PB.measure_serving(2, model="HG1", steps=2)
    label = PB.device_label(torch.device("cuda"))
    assert ips > 0 and torch.cuda.get_device_name(0) in label
    line = json.loads(PB.serving_line(2, ips, ms, "x", label))
    assert line["device"] == label and "cpu" not in line["metric"]
