"""Checkpoints, resume and the epoch loop of the port's trainers
(``ubpl_torch/train/{checkpointing,base_trainer}.py``) and
``PoseEstimator.from_checkpoint``.

Tiny sizes on the CPU: HG1, K=5, 64 -> 16, 8 training images, 2 steps per
epoch.  One MT_UBPL run of 2 epochs is made once (module fixture); the
other tests read what it wrote.  Everything here is exact: a checkpoint
holds the very tensors, and serving a checkpoint runs the same eval forward
as the trainer's validation.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from ubpl_torch.config import Config
from ubpl_torch.infer import PoseEstimator
from ubpl_torch.models import create_pose_model
from ubpl_torch.models.weights import (export_reference_state,
                                       load_reference_checkpoint, load_state,
                                       port_state_from_reference)
from ubpl_torch.train import checkpointing as CK
from ubpl_torch.train.mean_teacher import MeanTeacherTrainer
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
from ubpl_torch.train.supervised import SupervisedTrainer

K = 5
KW = dict(model="HG1", synthetic_data=True, synthetic_kps=K, inp_res=64,
          out_res=16, train_count=8, valid_count=6, label_ratio=0.5,
          train_bs=4, train_bs_labeled=2, infer_bs=4,
          compute_dtype="float32", pseudo_score_thr=0.0, epochs=2, seed=5)
SERVE = dict(model="HG1", kps_count=K, means=(0.5, 0.5, 0.5), batch_size=4,
             device="cpu", inp_res=64, out_res=16, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on one host: torch's intra-op
    threads would oversubscribe the cores, so this module computes
    single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    """MTUBPLTrainer(device="cpu").run(base) for 2 epochs."""
    base = str(tmp_path_factory.mktemp("mt_ubpl"))
    tr = MTUBPLTrainer(Config(**KW), device="cpu")
    history = tr.run(base)
    return {"base": base, "trainer": tr, "history": history}


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------ save/restore
def test_run_writes_the_reference_artifacts(run2):
    """2 epochs leave ckpts/checkpoint.pth.tar (+ _best), logs/args.json,
    logData_{1,2}.json and pseudoData_{1,2}.json; nothing half-written."""
    base = run2["base"]
    assert sorted(os.listdir(f"{base}/ckpts")) == [
        "checkpoint.pth.tar", "checkpoint_best.pth.tar"]
    assert sorted(os.listdir(f"{base}/logs/logData")) == [
        "logData_1.json", "logData_2.json"]
    assert sorted(os.listdir(f"{base}/logs/pseudoData")) == [
        "pseudoData_1.json", "pseudoData_2.json"]
    with open(f"{base}/logs/args.json") as f:
        args = json.load(f)
    assert args["model"] == "HG1" and args["kps_count"] == K


def test_history_and_log_data(run2):
    """history and logData_e.json carry the regime's losses and the PCK of
    the three heads (teacher1, teacher2, mean), K + 1 entries each;
    pseudoData_e.json the heads' predictions on the validation set."""
    h = run2["history"]
    assert len(h) == 2
    with open(f"{run2['base']}/logs/logData/logData_2.json") as f:
        log = json.load(f)
    assert set(log) == {"pec_losses", "mtc_losses", "epc_losses", "fdc_loss",
                        "accs", "errs"}
    assert log["pec_losses"] == h[1]["pec_losses"]
    assert np.shape(log["accs"]) == np.shape(log["errs"]) == (3, K + 1)
    assert np.isfinite(np.array(log["accs"] + log["errs"])).all()
    vals = h[1]["pec_losses"] + h[1]["mtc_losses"] + h[1]["epc_losses"]
    assert np.isfinite(vals).all() and len(vals) == 6
    assert h[0]["mtc_losses"] == [0.0, 0.0]      # teachers == students
    assert min(h[1]["mtc_losses"]) > 0           # until the first update
    with open(f"{run2['base']}/logs/pseudoData/pseudoData_2.json") as f:
        preds = json.load(f)["predsArraies"]
    assert np.shape(preds) == (3, 6, K, 2)
    np.testing.assert_allclose(preds[2], np.mean(preds[:2], axis=0),
                               rtol=1e-6)


def test_checkpoint_layout(run2):
    """The latest checkpoint holds the reference layout: current_epoch,
    model{1,2}_state, model{1,2}_ema_state, optim_state, best_acc,
    best_epoch — tensors and plain values only (weights_only load)."""
    path = CK.checkpoint_paths(run2["base"])[0]
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"current_epoch", "model1_state", "model2_state",
                         "model1_ema_state", "model2_ema_state",
                         "optim_state", "best_acc", "best_epoch"}
    assert ckpt["current_epoch"] == 1
    assert ckpt["best_acc"] == run2["trainer"].best_acc
    assert len(ckpt["best_epoch"]) == 3


def test_restore_gives_back_the_state(run2):
    """save -> restore: every network's state_dict (in the reference layout
    the checkpoint holds) and the optimiser's moments come back
    identical."""
    tr = run2["trainer"]
    state, meta = CK.restore_checkpoint(run2["base"])
    assert meta["current_epoch"] == 1
    for key, net in tr.networks.items():
        _same_state(state[key], export_reference_state(net))
        _same_state(port_state_from_reference(state[key]), net.state_dict())
    want = tr.optimizer.state_dict()
    assert state["optim_state"]["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for name, v in s.items():
            assert torch.equal(state["optim_state"]["state"][i][name], v)


def test_restore_without_checkpoint(tmp_path):
    assert CK.restore_checkpoint(str(tmp_path)) == (None, None)
    assert CK.restore_checkpoint(str(tmp_path), best=True) == (None, None)
    tr = SupervisedTrainer(Config(**{**KW, "label_ratio": 1.0}),
                           device="cpu")
    assert tr.resume(str(tmp_path)) == 0


@pytest.mark.parametrize("is_best", [False, True])
def test_save_checkpoint_best_copy(tmp_path, is_best):
    """The best file is written only when asked; extra lands beside the
    state; no temporary file is left."""
    state = {"model_state": {"w": torch.arange(3.0)}}
    CK.save_checkpoint(str(tmp_path), 4, state, is_best,
                       extra={"best_acc": [0.5]})
    names = sorted(os.listdir(tmp_path / "ckpts"))
    assert names == ["checkpoint.pth.tar"] + (
        ["checkpoint_best.pth.tar"] if is_best else [])
    got, meta = CK.restore_checkpoint(str(tmp_path), best=is_best)
    if is_best:
        assert torch.equal(got["model_state"]["w"], torch.arange(3.0))
        assert meta == {"current_epoch": 4, "best_acc": [0.5]}
    else:
        assert (got, meta) == (None, None) or "model_state" in got


def test_failed_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    """A crash while writing leaves the last complete checkpoint in place:
    the file is written under another name and moved only when whole."""
    CK.save_checkpoint(str(tmp_path), 0, {"model_state": {"w": torch.ones(2)}})

    def dies(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError):
        CK.save_checkpoint(str(tmp_path), 1,
                           {"model_state": {"w": torch.zeros(2)}})
    monkeypatch.undo()
    state, meta = CK.restore_checkpoint(str(tmp_path))
    assert meta["current_epoch"] == 0
    assert torch.equal(state["model_state"]["w"], torch.ones(2))


@pytest.mark.parametrize("branch", [1, 2])
@pytest.mark.parametrize("head", ["ema", "student"])
def test_written_file_loads_as_reference_checkpoint(run2, branch, head):
    """load_reference_checkpoint (the reader of reference .pth.tar files)
    reads each of the four networks out of the port's checkpoint, ready
    for a fresh StackedHourglass."""
    path = CK.checkpoint_paths(run2["base"])[0]
    sd, meta = load_reference_checkpoint(path, branch=branch, head=head)
    key = f"model{branch}_ema_state" if head == "ema" else \
        f"model{branch}_state"
    assert meta["source_key"] == key and meta["current_epoch"] == 1
    _same_state(sd, run2["trainer"].networks[key].state_dict())
    load_state(create_pose_model("HG1", K), sd)


# ------------------------------------------------- the reference's layout
@pytest.fixture(scope="module")
def hg2_state():
    """checkpoint_state() of an MT_UBPL trainer at HG2, K=5."""
    tr = MTUBPLTrainer(Config(**{**KW, "model": "HG2"}), device="cpu")
    return tr, tr.checkpoint_state()


def test_checkpoint_has_the_reference_keys_at_hg2(goldens, hg2_state):
    """Each network of a port checkpoint at HG2, K=5 has exactly the keys,
    in the same order, shapes and dtypes of the reference state_dict in
    tests/goldens/torch_import_hg2.npz (742: the dead same-width skip
    convs and the num_batches_tracked counters filled in), so the
    reference's strict load_state_dict takes it."""
    g = goldens("torch_import_hg2")
    want = [(k[4:], g[k].shape, g[k].dtype) for k in g.files
            if k.startswith("sd::")]
    assert len(want) == 742
    tr, state = hg2_state
    assert set(state) == set(tr.networks) | {"optim_state"}
    for key in tr.networks:
        got = [(k, tuple(v.shape), v.numpy().dtype)
               for k, v in state[key].items()]
        assert got == want, key


def test_checkpoint_weights_equal_export_hourglass(hg2_state):
    """The exported weights equal ubpl_tpu's export_hourglass of the same
    weights carried across (import_hourglass): live tensors, zero dead skip
    convs and zero counters; port_state_from_reference gives back the
    network's state_dict exactly."""
    from ubpl_tpu.models.torch_import import (export_hourglass,
                                              import_hourglass)
    tr, state = hg2_state
    net = tr.networks["model2_ema_state"]
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    want = export_hourglass(*import_hourglass(sd, 2), 2)
    got = state["model2_ema_state"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert any(".skip_layer." in k and not got[k].any() for k in got)
    _same_state(port_state_from_reference(got), net.state_dict())


def test_export_keeps_the_convone_projection():
    """The port-only ConvOne projection (``project.*``) stays in the
    export, and the export reads back through the same filter."""
    net = create_pose_model("HG1", K, "ConvOne")
    sd = export_reference_state(net)
    assert {"project.0.conv.weight", "project.0.conv.bias"} <= set(sd)
    _same_state(port_state_from_reference(sd), net.state_dict())


# ------------------------------------------------------------------ resume
def test_resume_continues_at_the_next_epoch(run2, tmp_path):
    """run(resume=True) with epochs=3 on (a copy of) the 2-epoch run trains
    exactly one more epoch (epoch 3), from the restored students, teachers,
    optimiser moments and best-so-far counters."""
    base, old = str(tmp_path / "run"), run2["trainer"]
    shutil.copytree(run2["base"], base)
    saved = {k: {n: v.clone() for n, v in net.state_dict().items()}
             for k, net in old.networks.items()}
    tr = MTUBPLTrainer(Config(**{**KW, "epochs": 3}), device="cpu")
    assert tr.resume(base) == 2
    for key, net in tr.networks.items():
        _same_state(net.state_dict(), saved[key])
    assert tr.best_acc == old.best_acc and tr.best_epoch == old.best_epoch
    steps = {int(s["step"]) for s in tr.optimizer.state_dict()["state"]
             .values()}
    assert steps == {2 * 2}                     # 2 epochs x 2 steps
    assert not any(p.requires_grad for t in tr.teachers
                   for p in t.parameters())
    history = tr.run(base, resume=True)
    assert len(history) == 1 and tr.epoch == 2
    assert os.path.exists(f"{base}/logs/logData/logData_3.json")
    assert CK.restore_checkpoint(base)[1]["current_epoch"] == 2
    steps = {int(s["step"]) for s in tr.optimizer.state_dict()["state"]
             .values()}
    assert steps == {3 * 2}
    # nothing left to do: a further resume runs no epoch
    assert tr.run(base, resume=True) == []


@pytest.mark.parametrize("cls,keys,heads", [
    (SupervisedTrainer, {"model_state"}, 1),
    (MeanTeacherTrainer, {"model_state", "model_ema_state"}, 2)])
def test_other_regimes_share_the_loop(tmp_path, cls, keys, heads):
    """Supervised and MT run through the same run()/validate() contract:
    one entry per head, their own reference checkpoint keys, resume."""
    cfg = Config(**{**KW, "epochs": 1})
    tr = cls(cfg, device="cpu")
    (h,) = tr.run(str(tmp_path))
    assert len(h["accs"]) == len(h["errs"]) == heads == len(tr.valid_heads)
    assert np.isfinite(h["pec_loss"])
    state, meta = CK.restore_checkpoint(str(tmp_path))
    assert set(state) == keys | {"optim_state"}
    assert len(meta["best_acc"]) == heads
    again = cls(Config(**KW), device="cpu")
    assert again.resume(str(tmp_path)) == 1
    for key, net in again.networks.items():
        _same_state(net.state_dict(), tr.networks[key].state_dict())


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("branch", [0, 1])
def test_from_checkpoint_serves_the_teacher(run2, branch):
    """PoseEstimator.from_checkpoint(base) serves the EMA teacher of the
    chosen branch: on the validation images it gives the coordinates the
    trainer's validation gave for that head, exactly."""
    tr = run2["trainer"]
    preds, _, _ = tr.validate()
    est = PoseEstimator.from_checkpoint(run2["base"], branch=branch,
                                        best=False, **SERVE)
    kps, scores = est.predict(tr.valid_data.images.numpy())
    np.testing.assert_array_equal(kps, np.asarray(preds[branch], np.float32))
    assert scores.shape == (6, K) and np.isfinite(scores).all()


def test_from_checkpoint_heads_and_best(run2):
    """head="student" serves the student; best=True reads
    checkpoint_best.pth.tar (saved when the mean head improved); a path
    without checkpoints raises FileNotFoundError."""
    tr, base = run2["trainer"], run2["base"]
    est = PoseEstimator.from_checkpoint(base, head="student", best=False,
                                        **SERVE)
    _same_state(est.model.state_dict(), tr.students[0].state_dict())
    best = PoseEstimator.from_checkpoint(base, **SERVE)
    want, meta = load_reference_checkpoint(CK.checkpoint_paths(base)[1])
    _same_state(best.model.state_dict(), want)
    assert meta["current_epoch"] == tr.best_epoch[-1]
    with pytest.raises(FileNotFoundError):
        PoseEstimator.from_checkpoint(base + "/nowhere", **SERVE)


# ------------------------------------------------------- unsupported config
@pytest.mark.parametrize("field,value", [
    ("pseudo_rounds", 1), ("debug", True), ("profile_dir", "/tmp/trace"),
    ("optimizer", "mld"), ("stream_data", True),
    ("torch_init", "ref.pth.tar")])
def test_unported_config_raises(field, value):
    """Every Config switch of the JAX package's loop is taken now: MT_UBPL
    accepts pseudo_rounds, the MLD optimiser (which the single-loss
    supervised regime refuses with a ValueError, as the JAX package does),
    stream_data (the training set stays on the host), debug and
    profile_dir; torch_init reads its file (a missing one raises
    FileNotFoundError)."""
    cfg = Config(**{**KW, field: value})
    if field == "torch_init":
        with pytest.raises(FileNotFoundError, match=value):
            MTUBPLTrainer(cfg, device="cpu")
        return
    tr = MTUBPLTrainer(cfg, device="cpu")
    assert getattr(tr.cfg, field) == value
    if field == "optimizer":
        with pytest.raises(ValueError, match="mld"):
            SupervisedTrainer(Config(**{**KW, field: value}), device="cpu")
    elif field == "stream_data":
        assert tr.train_data is None and tr.train_host is not None


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        MeanTeacherTrainer(Config(**{**KW, "optimizer": "sgd"}),
                           device="cpu")
