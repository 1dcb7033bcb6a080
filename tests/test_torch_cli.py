"""The port's entry points: ``python -m ubpl_torch`` (``ubpl_torch.__main__``)
against ``ubpl_tpu.__main__``, each of the five pose regimes trained on a
reference-layout Mouse tree on the CPU with its artifacts, the end-of-run
report against the JAX package's, the profiler trace, the preemption
guard and resume, the ``torch_init`` warm start and the debug drawings.
Tiny sizes: HG1, K=9, 64 -> 16, bs 4, 2 epochs, device="cpu"."""
import csv
import glob
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from ubpl_torch import __main__ as CLI
from ubpl_torch.config import Config
from ubpl_torch.data.native_io import write_png
from ubpl_torch.infer import PoseEstimator
from ubpl_torch.train.checkpointing import save_checkpoint
from ubpl_torch.utils.preemption import PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGIMES = ["supervised", "mt", "mt_ubpl", "dualpose", "dualpose_ubpl"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A Mouse tree in the reference layout: 12 non-square PNG crops."""
    root = str(tmp_path_factory.mktemp("data"))
    base = os.path.join(root, "pose", "mouse", "croppeds_bbox")
    rng = np.random.default_rng(0)
    anns = []
    for i in range(12):
        write_png(os.path.join(base, "images", f"m{i:03d}.png"),
                  rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
        anns.append({"imageID": f"m{i:03d}",
                     "kps": rng.uniform(2, 38, (9, 2)).tolist()})
    with open(os.path.join(base, "labels_normal.json"), "w") as f:
        json.dump(anns, f)
    return root


def _argv(data_root, tmp_path, *extra):
    return ["--device=cpu", "--data_source=Mouse", f"--data_root={data_root}",
            "--train_count=8", "--valid_count=4", "--label_ratio=0.5",
            "--train_bs=4", "--train_bs_labeled=2", "--infer_bs=4",
            "--model=HG1", "--epochs=2", "--force_inp_res=64",
            "--force_out_res=16", "--compute_dtype=float32",
            f"--experiment_root={tmp_path / 'exp'}",
            f"--cache_dir={tmp_path / 'cache'}", *extra]


def _experiment(tmp_path):
    (path,) = glob.glob(str(tmp_path / "exp" / "*"))
    return path


# ------------------------------------------------------- parsing, dispatch
@pytest.mark.parametrize("argv", [
    [], ["--epochs=3"], ["--lr=2.5e-4", "--model=HG2"],
    ["--useFlip=False", "--trainBS=8"], ["positional", "--x"],
    ["--mesh_shape=2,4", "--device=cpu"], ["--a=1e3", "--b=-2", "--c=0x1"],
    ["--data_root=/d/x=y", "--quick"]])
def test_parse_overrides_matches_jax(argv):
    from ubpl_tpu.__main__ import parse_overrides as jparse
    assert CLI.parse_overrides(argv) == jparse(argv)


def _dispatch(monkeypatch, argv):
    """(exp_mark, params) each package's main hands to its exec_regime for
    ``argv``, with the regimes replaced by recorders."""
    import importlib
    seen = {}
    mods = {"supervised": "supervised", "mean_teacher": "mean_teacher",
            "mt_ubpl": "mt_ubpl", "dualpose_ubpl": "dualpose_ubpl"}
    for pkg in ("ubpl_tpu", "ubpl_torch"):
        for mod in mods:
            m = importlib.import_module(f"{pkg}.train.{mod}")
            monkeypatch.setattr(
                m, "exec_regime",
                lambda mark, params, device=None, pkg=pkg: seen.setdefault(
                    pkg, (mark, params, device)))
    monkeypatch.setattr(sys, "argv", ["ubpl_tpu"] + argv)
    from ubpl_tpu.__main__ import main as jmain
    assert jmain() == 0
    assert CLI.main(argv + ["--device=cpu"]) == 0
    return seen


@pytest.mark.parametrize("regime", REGIMES)
def test_regimes_dispatch_as_jax(monkeypatch, regime):
    """Each regime reaches the same exec_regime with the same mark and
    parameters as in the JAX package (``dualpose``: FDL off, no EPC); the
    port's gets the device."""
    seen = _dispatch(monkeypatch, [regime, "--epochs=3", "--labelRatio=0.2"])
    mark, params, _ = seen["ubpl_tpu"]
    assert seen["ubpl_torch"] == (mark, params, "cpu")
    if regime == "dualpose":
        assert params["use_ensemble_pseudo"] is False
        assert params["fdl_weight_max"] == params["fdl_weight_min"] == 0.0


@pytest.mark.parametrize("quick", [False, True])
def test_exec_runs_every_regime_over_the_grid(monkeypatch, quick):
    """``exec`` runs the five regime configurations over GRID in the JAX
    package's order and parameters; ``--quick`` over QUICK_GRID with 2
    epochs of HG2, the other keys added."""
    import ubpl_torch.train.exec as PE
    import ubpl_tpu.train.exec as JE
    calls = {"jax": [], "port": []}
    for mod, side in ((JE, "jax"), (PE, "port")):
        for name in ("Supervised", "MT", "MT_UBPL", "DualPose_UBPL"):
            monkeypatch.setattr(
                mod, name, lambda mark, p, device=None, side=side:
                calls[side].append((mark, p, device)))
    import ubpl_tpu.utils.preemption as JP
    for guard in (PreemptionGuard, JP.PreemptionGuard):
        monkeypatch.setattr(guard, "get", classmethod(lambda c: None))
    argv = ["exec", "--data_root=/d"] + (["--quick"] if quick else [])
    assert CLI.main(argv + ["--device=cpu"]) == 0
    if quick:       # what ``python -m ubpl_tpu.train.exec --quick`` runs
        JE.exec_home(grid=[["Mouse", 24, 0.5]],
                     extra={"epochs": 2, "valid_count": 16, "model": "HG2",
                            "data_root": "/d"})
    else:
        JE.exec_home(extra={"data_root": "/d"})
    assert [(m, p) for m, p, _ in calls["port"]] == [
        (m, p) for m, p, _ in calls["jax"]]
    assert {d for _, _, d in calls["port"]} == {"cpu"}
    assert len(calls["port"]) == 5 * (1 if quick else 6)


@pytest.mark.parametrize("regime,says", [
    ("nope", "unknown regime 'nope'")])
def test_regimes_not_ported_exit_nonzero(regime, says, capsys):
    """An unknown regime prints the usage and exits non-zero (every regime
    of the JAX CLI is ported)."""
    assert CLI.main([regime]) != 0
    out = capsys.readouterr()
    assert says in out.out + out.err


def test_bench_regime_on_cpu(monkeypatch, capsys):
    """``bench --device=cpu`` (HG1, 64 -> 16, bs 2, 1 step) exits 0 and
    prints exactly one JSON line on stdout, labelled cpu."""
    from ubpl_torch import bench as PB
    monkeypatch.setattr(PB, "SHAPE",
                        {"model": "HG1", "inp_res": 64, "out_res": 16})
    monkeypatch.setenv("UBPL_BENCH_BS", "2")
    monkeypatch.setenv("UBPL_BENCH_STEPS", "1")
    for k in ("SCAN", "FUSE", "FOLD", "UNROLL", "REMAT", "STREAM", "SCANBR"):
        monkeypatch.delenv(f"UBPL_BENCH_{k}", raising=False)
    assert CLI.main(["bench", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline", "device",
            "baseline"} == set(line)
    assert line["device"] == "cpu" and "bs=2" in line["metric"]
    assert line["value"] > 0


def test_device_defaults_to_the_card(monkeypatch, data_root, tmp_path):
    """Without --device the regime runs on CUDA, and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(data_root, tmp_path) if a != "--device=cpu"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLI.main(["supervised"] + argv)


def test_module_without_regime_prints_usage():
    """``python -m ubpl_torch`` with no regime: usage text, exit 1."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "ubpl_torch"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=120)
    assert r.returncode == 1
    assert "python -m ubpl_torch <regime>" in r.stdout
    assert "--device=cuda|cpu" in r.stdout


# ------------------------------------------------------- training runs
@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    """Each pose regime once through main() on the CPU (dualpose_ubpl also
    with a profiler trace and debug drawings)."""
    out = {}
    for regime in REGIMES:
        tmp = tmp_path_factory.mktemp(regime)
        extra = ([f"--profile_dir={tmp / 'trace'}", "--debug=True"]
                 if regime == "dualpose_ubpl" else [])
        assert CLI.main([regime] + _argv(data_root, tmp, *extra)) == 0
        out[regime] = (_experiment(tmp), tmp)
    return out


@pytest.mark.parametrize("regime", REGIMES)
def test_run_writes_the_artifacts(runs, regime):
    """Checkpoints, args, per-epoch logs and the report; finite losses and
    PCK in the logs."""
    base, _ = runs[regime]
    for rel in ("ckpts/checkpoint.pth.tar", "ckpts/checkpoint_best.pth.tar",
                "logs/args.json", "logs/logData/logData_1.json",
                "logs/logData/logData_2.json", "logs/report.csv",
                "logs/report.md", "logs/report.xlsx", "logs/log_L1.log"):
        assert os.path.isfile(os.path.join(base, rel)), rel
    mark = {"supervised": "Supervised", "mt": "MT", "mt_ubpl": "MT_UBPL",
            "dualpose": "DualPose", "dualpose_ubpl": "DualPose_UBPL"}[regime]
    assert os.path.basename(base).startswith(f"Mouse(8_0.5)_{mark}_")
    with open(os.path.join(base, "logs", "args.json")) as f:
        args = json.load(f)
    assert (args["kps_count"], args["inp_res"], args["out_res"]) == (9, 64, 16)
    for e in (1, 2):
        with open(os.path.join(base, f"logs/logData/logData_{e}.json")) as f:
            log = json.load(f)
        flat = [v for k, v in log.items()]
        assert np.isfinite(np.concatenate(
            [np.ravel(np.asarray(v, np.float64)) for v in flat])).all()


def _history(base):
    hist = []
    for e in (1, 2):
        with open(os.path.join(base, f"logs/logData/logData_{e}.json")) as f:
            hist.append(json.load(f))
    return hist


@pytest.mark.parametrize("regime", REGIMES)
def test_report_matches_jax(runs, regime, tmp_path):
    """logs/report.{csv,md} are what the JAX package's _write_report makes
    of the same history (read back from the per-epoch logs)."""
    from ubpl_tpu.train.base_trainer import BaseTrainer as JBase
    base, _ = runs[regime]
    JBase._write_report(None, str(tmp_path), _history(base))
    for name in ("report.csv", "report.md"):
        with open(os.path.join(base, "logs", name)) as f:
            ours = f.read()
        with open(os.path.join(tmp_path, "logs", name)) as f:
            assert ours == f.read(), name
    with open(os.path.join(base, "logs", "report.csv")) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 3 and rows[0][0] == "epoch"


def test_profile_dir_writes_a_trace(runs):
    """profile_dir: one Chrome trace of the first epoch, with the training
    step's ops in it."""
    _, tmp = runs["dualpose_ubpl"]
    (path,) = glob.glob(str(tmp / "trace" / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("convolution" in n for n in names)


def test_debug_writes_its_pngs(runs):
    """debug: per epoch the augmented images with keypoints and their
    heatmaps, as PNGs cv2 reads."""
    base, _ = runs["dualpose_ubpl"]
    files = sorted(glob.glob(os.path.join(base, "draw", "dataset", "train",
                                          "*.png")))
    assert len(files) == 2 * 2 * 4      # epochs x (aug, heatmap) x samples
    assert any("epo2_heatmap" in f for f in files)
    img = cv2.imread(files[0])
    assert img.shape == (64, 64, 3)
    assert len({tuple(cv2.imread(f).reshape(-1)[:64]) for f in files}) > 1


def test_checkpoint_serves(runs):
    """from_checkpoint of a run serves images."""
    base, _ = runs["dualpose_ubpl"]
    est = PoseEstimator.from_checkpoint(base, model="HG1", kps_count=9,
                                        device="cpu", inp_res=64, out_res=16)
    kps, scores = est.predict(np.zeros((3, 64, 64, 3), np.uint8))
    assert kps.shape == (3, 9, 2) and np.isfinite(scores).all()


# --------------------------------------------------- preemption, resume
def test_preemption_stops_after_checkpoint_and_resume_continues(
        data_root, tmp_path, monkeypatch):
    """A preemption request stops the run at the first epoch boundary,
    after its checkpoint and logs; run(resume=True) carries on at epoch 2
    and finishes with its report."""
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    params = CLI.parse_overrides(_argv(data_root, tmp_path))
    params.pop("device")
    guard = PreemptionGuard()
    guard.requested = True
    monkeypatch.setattr(PreemptionGuard, "_installed", guard)
    base = str(tmp_path / "run")
    tr = MTUBPLTrainer(Config().override(params), device="cpu")
    hist = tr.run(base)
    assert len(hist) == 1
    assert os.path.isfile(os.path.join(base, "ckpts", "checkpoint.pth.tar"))
    assert not os.path.exists(os.path.join(base, "logs/logData/logData_2.json"))
    guard.requested = False
    tr2 = MTUBPLTrainer(Config().override(params), device="cpu")
    hist2 = tr2.run(base, resume=True)
    assert len(hist2) == 1 and tr2.epoch == 1
    assert os.path.isfile(os.path.join(base, "logs/logData/logData_2.json"))
    assert os.path.isfile(os.path.join(base, "logs", "report.csv"))


# ------------------------------------------------------------- torch_init
def _golden_state_dict():
    g = np.load(os.path.join(REPO, "tests", "goldens",
                             "torch_import_hg2.npz"))
    return {k[4:]: torch.from_numpy(g[k]) for k in g.files
            if k.startswith("sd::")}, int(g["k"])


@pytest.mark.parametrize("layout", ["supervised", "dual"])
def test_torch_init_loads_reference_weights(tmp_path, layout):
    """torch_init from a reference checkpoint synthesized from the HG2
    golden: every network equals what from_checkpoint serves for its key
    (dual: both students and both EMA teachers; supervised: branch 1,
    the EMA head falling back to the student); the optimiser starts
    fresh."""
    from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
    from ubpl_torch.train.supervised import SupervisedTrainer
    sd, k = _golden_state_dict()
    if layout == "supervised":
        state = {"model_state": sd}
    else:
        state = {f"model{i}{ema}_state": {n: v * (1 + 0.1 * i + 0.01 * len(ema))
                                          for n, v in sd.items()}
                 for i in (1, 2) for ema in ("", "_ema")}
    save_checkpoint(str(tmp_path), 4, state, is_best=True)
    path = os.path.join(str(tmp_path), "ckpts", "checkpoint_best.pth.tar")
    cfg = Config(model="HG2", synthetic_data=True, synthetic_kps=k,
                 inp_res=64, out_res=16, train_count=4, valid_count=2,
                 train_bs=2, train_bs_labeled=1, torch_init=path)
    cls = SupervisedTrainer if layout == "supervised" else MTUBPLTrainer
    tr = cls(cfg, device="cpu")
    for key, net in tr.networks.items():
        branch = int(key[5]) if key[5].isdigit() else 1
        head = "ema" if "_ema" in key else "student"
        want = PoseEstimator.from_checkpoint(
            str(tmp_path), model="HG2", kps_count=k, head=head,
            branch=branch - 1, device="cpu").model.state_dict()
        for name, v in net.state_dict().items():
            assert torch.equal(v, want[name]), (key, name)
    assert not tr.optimizer.state
    if layout == "dual":
        assert not torch.equal(tr.students[0].pre[0].conv.weight,
                               tr.teachers[1].pre[0].conv.weight)


def test_preview_writes_pngs(data_root, tmp_path):
    """``preview`` renders annotated samples of a datasource as PNGs."""
    out = tmp_path / "preview"
    assert CLI.main(["preview", f"--data_root={data_root}", "--count=3",
                     f"--out={out}", f"--cache_dir={tmp_path}"]) == 0
    files = sorted(out.glob("*.png"))
    assert len(files) == 3
    assert cv2.imread(str(files[0])).shape == (256, 256, 3)
