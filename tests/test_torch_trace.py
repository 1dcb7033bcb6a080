"""The port's profiler spans and serving counters (``utils.profiling.span``):
none without a profiler, one ``train.step`` per training step with its
phases nested in order, one ``serve.request`` per ``predict`` call with
four spans per chunk, and the spans in the Chrome file that
``utils.profiling.trace`` writes."""
import glob
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ubpl_torch.config import Config
from ubpl_torch.data.cifar import CIFAR10Data
from ubpl_torch.infer import PoseEstimator
from ubpl_torch.models import create_pose_model
from ubpl_torch.train.classification import ClassificationTrainer
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
from ubpl_torch.utils import profiling

K, R = 5, 64
PHASES = ["train.views", "train.forward", "train.losses", "train.backward",
          "train.update"]
CHUNK = ["serve.stage", "serve.normalize", "serve.forward", "serve.collect"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof, prefix):
    """(name, start, end) of the recorded spans named ``prefix...``, in
    order of their start (from the raw events: ``prof.events()`` builds a
    tree that costs seconds)."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix)), key=lambda s: s[1])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _estimator(batch_size=2):
    cfg = Config(model="HG1", inp_res=R, out_res=16, compute_dtype="float32")
    cfg.kps_count = K
    net = create_pose_model("HG1", K, "AvgPool")
    return PoseEstimator(net, net.state_dict(), (0.4, 0.4, 0.4), cfg,
                         batch_size=batch_size, device="cpu")


def _frames(n):
    return np.random.default_rng(0).integers(0, 256, (n, R, R, 3),
                                             dtype=np.uint8)


def test_span_without_a_profiler_records_nothing(monkeypatch):
    """No profiler: every span is the one shared null context and never
    reaches ``record_function``; under a profiler it is a range."""
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    assert profiling.span("train.step") is profiling.span("serve.stage")
    with profiling.span("train.step"):
        pass
    assert calls == []
    monkeypatch.undo()

    def one():
        with profiling.span("train.step"):
            pass
    assert [s[0] for s in _spans(_profiled(one), "train.")] == [
        "train.step"]


def _mt_ubpl_step():
    cfg = Config(model="HG1", synthetic_data=True, synthetic_kps=K,
                 inp_res=R, out_res=16, train_count=8, valid_count=4,
                 label_ratio=0.5, train_bs=4, train_bs_labeled=2,
                 infer_bs=4, compute_dtype="float32", seed=3)
    tr = MTUBPLTrainer(cfg, device="cpu")
    return lambda: tr.run_train_steps([np.array([5, 6, 0, 1])], 3.0, 0.7,
                                      0.8, 0.5)


def _class_step(tmp_path):
    rng = np.random.default_rng(0)
    ds = CIFAR10Data.from_arrays(
        rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, (8,)),
        rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, (4,)), cache_dir=str(tmp_path), seed=7)
    cfg = Config(model="MobileNet", data_source="cifar10", train_count=8,
                 valid_count=4, label_ratio=0.5, train_bs=4,
                 train_bs_labeled=2, infer_bs=4, compute_dtype="float32",
                 seed=3, cache_dir=str(tmp_path))
    tr = ClassificationTrainer(cfg, "mt_ubpl", datasource=ds, device="cpu")
    idxs = tr.unlabeled_idxs[:2] + tr.labeled_idxs[:2]
    return lambda: tr.train_step(idxs, 3.0, 0.8, 0.5)


@pytest.mark.parametrize("regime", ["mt_ubpl", "classification"])
def test_train_step_spans_nest_in_order(regime, tmp_path):
    """One step of MT_UBPL through ``run_train_steps`` and of the
    classification branch's ``mt_ubpl`` mode: one ``train.step`` holding
    each phase once, in the step's order, none overlapping the next."""
    step = _mt_ubpl_step() if regime == "mt_ubpl" else _class_step(tmp_path)
    spans = _spans(_profiled(step), "train.")
    assert [s[0] for s in spans] == ["train.step"] + PHASES
    (_, t0, t1), phases = spans[0], spans[1:]
    for (_, s0, s1), nxt in zip(phases, phases[1:] + [(None, t1, t1)]):
        assert t0 <= s0 <= s1 <= nxt[1] <= t1


def test_predict_spans_and_counters():
    """A 3-frame clip at batch size 2: one request of two chunks, each
    staged, normalised, run and collected; 3 frames requested, 4
    computed (the second chunk padded)."""
    est = _estimator()
    assert (est.frames_requested, est.frames_computed) == (0, 0)
    prof = _profiled(lambda: est.predict(_frames(3)))
    spans = _spans(prof, "serve.")
    names = [s[0] for s in spans]
    assert names.count("serve.request") == 1
    assert all(names.count(n) == 2 for n in CHUNK)
    request = spans[0]
    assert request[0] == "serve.request"
    assert all(request[1] <= s <= e <= request[2] for _, s, e in spans)
    assert (est.frames_requested, est.frames_computed) == (3, 4)
    est.predict(_frames(2))
    assert (est.frames_requested, est.frames_computed) == (5, 6)


def test_chrome_trace_holds_the_spans(tmp_path):
    """The file ``profiling.trace`` writes (``Config.profile_dir``'s epoch
    trace) names every span of a training step and of a request."""
    step, est = _class_step(tmp_path / "data"), _estimator()
    with profiling.trace(str(tmp_path / "trace")):
        step()
        est.predict(_frames(3))
    (path,) = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.step", *PHASES, "serve.request", *CHUNK} <= names
