"""The port package's contract: it stands alone (no ``jax``, no
``ubpl_tpu``), runs on the card unless told otherwise, and configures like
the JAX package."""
import dataclasses
import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import ubpl_torch
from ubpl_torch import device as D
from ubpl_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|ubpl_tpu)\b",
                       re.M)


def _port_sources():
    root = os.path.join(REPO, "ubpl_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_import_pulls_in_no_jax():
    """Importing every module of the port (in a fresh interpreter) loads
    neither jax nor ubpl_tpu."""
    code = (
        "import pkgutil, importlib, sys, ubpl_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(ubpl_torch.__path__,"
        " 'ubpl_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ubpl_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 43 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


NEW_MODULES = ["__main__", "bench", "data.arrays", "data.base", "data.cifar",
               "data.native_io", "data.occluders", "data.preview",
               "data.sources", "models.classification",
               "models.classification.mobilenet",
               "models.classification.resnet", "models.classification.vgg",
               "models.init_strategies", "models.litepose",
               "ops.features", "ops.uncertainty", "train.classification",
               "train.dualpose_ubpl", "train.exec", "train.feature_pool",
               "train.mld_optim", "train.pseudo", "train.pseudo_loop",
               "train.streaming", "utils.comm", "utils.draw",
               "utils.preemption", "utils.profiling", "utils.report",
               "utils.xlsx"]


@pytest.fixture(scope="module")
def loaded_by():
    """In one fresh interpreter: the top-level packages that importing each
    entry-path module (in NEW_MODULES order) loaded."""
    code = (
        "import importlib, json, sys\n"
        f"names = {NEW_MODULES!r}\n"
        "out = {}\n"
        "for n in names:\n"
        "    before = set(sys.modules)\n"
        "    importlib.import_module('ubpl_torch.' + n)\n"
        "    out[n] = sorted({k.split('.')[0] for k in sys.modules"
        " if k not in before})\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", NEW_MODULES)
def test_entry_path_module_imports_no_jax(loaded_by, name):
    """Each module of the entry-point path loads neither jax nor ubpl_tpu,
    nor the image libraries the card machine lacks (cv2, PIL: imported
    only where a JPEG is read)."""
    bad = {"jax", "jaxlib", "flax", "optax", "ubpl_tpu", "cv2", "PIL"}
    assert not bad & set(loaded_by[name])


def test_sources_import_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax, optax or
    ubpl_tpu — not even lazily inside a function."""
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            if IMPORT_RE.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


def test_every_module_names_its_counterpart():
    """Each port module's docstring names its ubpl_tpu counterpart (or says
    it has none)."""
    missing = []
    for m in pkgutil.walk_packages(ubpl_torch.__path__, "ubpl_torch."):
        mod = sys.modules.get(m.name) or __import__(m.name, fromlist=["_"])
        doc = mod.__doc__ or ""
        if "ubpl_tpu" not in doc:
            missing.append(m.name)
    assert missing == []


def test_device_none_means_cuda(monkeypatch):
    """device=None resolves to CUDA and raises without it — no silent CPU
    fallback; an explicit "cpu" is honoured."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.resolve_device(None)
    assert D.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert D.resolve_device(None) == torch.device("cuda")


def test_entry_points_refuse_cpu_by_default(monkeypatch):
    """PoseEstimator and the trainer raise without CUDA unless
    device="cpu" is passed."""
    from ubpl_torch.infer import PoseEstimator
    from ubpl_torch.models import create_pose_model
    from ubpl_torch.train.supervised import SupervisedTrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = create_pose_model("HG2", 3)
    with pytest.raises(RuntimeError):
        PoseEstimator(net, net.state_dict(), (0, 0, 0), Config(kps_count=3))
    cfg = Config(model="HG2", synthetic_data=True, synthetic_kps=3,
                 inp_res=32, out_res=8, train_count=2, valid_count=2)
    with pytest.raises(RuntimeError):
        SupervisedTrainer(cfg)


@pytest.mark.parametrize("entry", ["MTUBPLTrainer", "MeanTeacherTrainer",
                                   "DualPoseUBPLTrainer", "from_checkpoint"])
def test_training_entry_points_refuse_cpu_by_default(monkeypatch, tmp_path,
                                                     entry):
    """The SSL trainers and PoseEstimator.from_checkpoint raise without
    CUDA when no device is given, and run with device="cpu"."""
    from ubpl_torch.infer import PoseEstimator
    from ubpl_torch.train.checkpointing import save_checkpoint
    from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
    from ubpl_torch.train.mean_teacher import MeanTeacherTrainer
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(model="HG1", synthetic_data=True, synthetic_kps=3,
                 inp_res=64, out_res=16, train_count=4, valid_count=2,
                 train_bs=2, train_bs_labeled=1)
    if entry == "from_checkpoint":
        from ubpl_torch.models import create_pose_model
        net = create_pose_model("HG1", 3)
        save_checkpoint(str(tmp_path), 0, {"model_state": net.state_dict()},
                        is_best=True)
        make = lambda **kw: PoseEstimator.from_checkpoint(  # noqa: E731
            str(tmp_path), model="HG1", kps_count=3, **kw)
    else:
        cls = {"MTUBPLTrainer": MTUBPLTrainer,
               "MeanTeacherTrainer": MeanTeacherTrainer,
               "DualPoseUBPLTrainer": DualPoseUBPLTrainer}[entry]
        make = lambda **kw: cls(cfg, **kw)  # noqa: E731
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_dtype_policy():
    """bf16 autocast and channels_last only on the card; fp32 and NCHW on
    the CPU."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert D.memory_format(cpu) == torch.contiguous_format
    assert D.memory_format(cuda) == torch.channels_last
    assert not isinstance(D.autocast(cpu, "bfloat16"), torch.autocast)
    assert not isinstance(D.autocast(cuda, "float32"), torch.autocast)


def test_config_matches_jax_package():
    """Same fields and defaults as ubpl_tpu.config.Config (bar the program
    tag), same reference aliases and override coercion."""
    from ubpl_tpu.config import Config as JConfig
    ours = {f.name: f for f in dataclasses.fields(Config)}
    theirs = {f.name: f for f in dataclasses.fields(JConfig)}
    assert set(ours) == set(theirs)
    a, b = dataclasses.asdict(Config()), dataclasses.asdict(JConfig())
    a.pop("program"), b.pop("program")
    assert a == b
    assert Config.REFERENCE_ALIASES == JConfig.REFERENCE_ALIASES
    params = {"trainBS": 8, "useFlip": "False", "mesh_shape": "2,4",
              "mesh_axes": "model,data", "nonexistent": 1}
    ca, cb = Config().override(params), JConfig().override(params)
    for k in ("train_bs", "use_flip", "mesh_shape", "mesh_axes"):
        assert getattr(ca, k) == getattr(cb, k)
    assert ca.use_flip is False and ca.n_stack == 3


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line on a host
    without CUDA, and in a directory holding only itself."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: chip_smoke.py would run for real")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, cwd=cwd, env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
