"""The MT / MT_UBPL step after the views as a CUDA graph replays it
(``ubpl_torch/train/step_graph.py``).

On the CPU the graph never engages, so these tests hold its pieces: the
step with its schedule as 0-dim tensors of the parameters' dtype (the body
that the card captures, run eagerly) equals the eager step with floats bit
for bit, in float32 and float64; each step's metrics are its own; the
engagement rule; a resumed AdamW keeps its own flags.  The tests marked ``cuda``
hold the graphed trainer against an eager one on the card; run them there
with ``python -m pytest --noconftest -m cuda tests/test_torch_graph_step.py``
(this file imports no JAX).
"""
import numpy as np
import pytest
import torch

import ubpl_torch.train.common as C
import ubpl_torch.train.mt_ubpl as MT

from ubpl_torch.config import Config
from ubpl_torch.train import step_graph as SG
from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
from ubpl_torch.train.mean_teacher import MeanTeacherTrainer
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
from ubpl_torch.train.supervised import SupervisedTrainer

K = 5
KW = dict(synthetic_data=True, synthetic_kps=K, inp_res=64, out_res=16,
          train_count=12, valid_count=4, label_ratio=0.5, train_bs=4,
          train_bs_labeled=2, infer_bs=4, compute_dtype="float32",
          pseudo_score_thr=0.0, seed=5)
#: per step: (cons_weight, fdl_weight, pseudo_weight), ema_alpha; the
#: rates include ones whose 1 - rate rounds differently in float32
SCHEDULES = [((3.0, 0.7, 0.8), 0.0), ((0.1, 1.3, 0.25), 0.7),
             ((2.5, 0.05, 1.0), 0.999)]
REGIMES = {"mt_ubpl": MTUBPLTrainer, "mt": MeanTeacherTrainer}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(regime, device="cpu", **kw):
    cfg = Config(**{**KW, "model": "HG1" if device == "cpu" else "HG2",
                    **kw})
    return REGIMES[regime](cfg, device=device)


def _weights(regime, weights):
    return weights if regime == "mt_ubpl" else weights[:1]


def _state(tr):
    """Every student's and teacher's parameters and buffers."""
    return {f"{tag}{m}.{k}": v.detach().clone()
            for tag, nets in (("s", tr.students), ("t", tr.teachers))
            for m, net in enumerate(nets)
            for k, v in net.state_dict().items()}


def _batches(tr, n):
    """``n`` batches of the trainer's sampler, over as many epochs as
    that takes."""
    out = []
    while len(out) < n:
        out += [np.asarray(b) for b in tr.make_sampler()]
    return out[:n]


# ------------------------------------------------------------------ CPU
def _forward_float64(model, images, train, compute_dtype, remat=False):
    """``common.forward_heatmaps`` for float64 networks (no float32 cast
    of the outputs)."""
    model.train(train)
    out = model(images.double())
    return out if isinstance(out, tuple) else (out, None)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_tensor_schedule_step_equals_float_step(regime, dtype, monkeypatch):
    """Three steps with a new schedule each: the body as the graph runs it
    (``with_schedule``: 0-dim tensors of the parameters' dtype, the EMA as
    (rate, 1 - rate)) equals the eager step with floats bit for bit —
    losses, counts, students, teachers, BatchNorm stats, AdamW.  In
    float64 (networks and losses) the schedule is float64: a float32 one
    would weigh the losses by rounded values."""
    eager, tensor = _trainer(regime), _trainer(regime)
    if dtype == "float64":
        monkeypatch.setattr(C, "forward_heatmaps", _forward_float64)
        monkeypatch.setattr(MT, "forward_heatmaps", _forward_float64)
        for tr in (eager, tensor):
            for net in tr.networks.values():
                net.double()
    assert tensor.param_dtype == getattr(torch, dtype)
    for batch, (weights, alpha) in zip(_batches(eager, 3), SCHEDULES):
        weights = _weights(regime, weights)
        (want,) = eager.run_train_steps([batch], *weights, alpha)
        views, islabeled = tensor.make_views(batch, tensor.n_views)
        schedule = torch.tensor(SG.schedule_values(weights, alpha),
                                dtype=tensor.param_dtype)
        got = SG.with_schedule(tensor.step_after_views, views, islabeled,
                               schedule)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
        a, b = _state(eager), _state(tensor)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(v.abs().sum() > 0 for k, v in got.items()
               if k.startswith(("mtc", "pec")))
    for p, q in zip(eager.optimizer.param_groups[0]["params"],
                    tensor.optimizer.param_groups[0]["params"]):
        for k, v in eager.optimizer.state[p].items():
            assert torch.equal(v, tensor.optimizer.state[q][k]), k
    assert eager.eager_steps == 3 and eager.graph_captures == 0


def test_each_step_returns_its_own_metrics():
    """Every step's metrics are their own tensors with their own values."""
    tr = _trainer("mt_ubpl")
    metrics = tr.run_train_steps(_batches(tr, 3), 3.0, 0.7, 0.8, 0.5)
    ids = [id(v) for m in metrics for v in m.values()]
    assert len(set(ids)) == len(ids)
    assert not torch.equal(metrics[0]["pec"], metrics[2]["pec"])


def test_resume_keeps_own_adamw_flags(tmp_path):
    """A checkpoint carries its writer's AdamW flags (a graphed trainer
    writes ``capturable`` and ``fused``); ``resume`` keeps the reader's
    own, with each ``step`` on the host as an eager AdamW keeps it, and
    a step on the same views equals the writer's."""
    writer = _trainer("mt_ubpl")
    batches = _batches(writer, 3)
    weights, alpha = SCHEDULES[1]
    writer.run_train_steps(batches[:2], *weights, alpha)
    groups = writer.optimizer.param_groups
    for g in groups:
        g.update(capturable=True, fused=True)
    writer.save(str(tmp_path), 0, False)
    for g in groups:
        g.update(capturable=False, fused=None)
    reader = _trainer("mt_ubpl")
    assert reader.resume(str(tmp_path)) == 1
    for g in reader.optimizer.param_groups:
        assert (g["capturable"], g["fused"]) == (False, None)
    steps = [st["step"] for st in reader.optimizer.state.values()]
    assert steps and all(t.device.type == "cpu" for t in steps)
    views, islabeled = writer.make_views(batches[2], writer.n_views)
    want, got = (tr.step_after_views(views, islabeled, *weights,
                                     ema_alpha=alpha)
                 for tr in (writer, reader))
    assert all(torch.equal(got[k], want[k]) for k in want)
    a, b = _state(writer), _state(reader)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["cpu", "remat", "mld", "batch_group",
                                  "branch_group"])
def test_engagement_rule(case):
    """The graph engages on a CUDA card, in one process, with AdamW and
    without remat; each of those missing keeps the step eager."""
    cfg = Config(**KW, **{"remat": {"remat": True},
                          "mld": {"optimizer": "mld"}}.get(case, {}))
    device = torch.device("cpu" if case == "cpu" else "cuda")
    group = object() if case == "batch_group" else None
    branches = object() if case == "branch_group" else None
    assert SG.engages(torch.device("cuda"), None, None, Config(**KW))
    assert not SG.engages(device, group, branches, cfg)


@pytest.mark.parametrize("regime,kw", [
    ("mt_ubpl", {}), ("mt_ubpl", {"remat": True}),
    ("mt_ubpl", {"optimizer": "mld"}), ("mt", {}), ("mt", {"remat": True})],
    ids=["mt_ubpl-cpu", "mt_ubpl-remat", "mt_ubpl-mld", "mt-cpu", "mt-remat"])
def test_eager_trainers_count_eager_steps(regime, kw):
    """On the CPU (with remat, with MLD) every step is eager: the counters
    say so and AdamW is the plain one."""
    tr = _trainer(regime, **kw)
    sched = tr.epoch_schedules(0).values()
    tr.run_train_steps(_batches(tr, 2), *sched)
    assert (tr.eager_steps, tr.graph_captures, tr.graph_replays) == (2, 0, 0)
    assert not tr.step_graph.enabled
    assert not tr.optimizer.defaults["capturable"]
    assert not tr.optimizer.defaults["fused"]


@pytest.mark.parametrize("cls", [DualPoseUBPLTrainer, SupervisedTrainer])
def test_other_regimes_take_no_graph(cls):
    """DualPose_UBPL (its own step) and Supervised never take the graph;
    their AdamW stays the plain one."""
    assert not cls.graphs_step
    tr = cls(Config(**KW, model="HG1"), device="cpu")
    assert not tr.step_graph.enabled
    assert not tr.optimizer.defaults["capturable"]


# ----------------------------------------------------------------- card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(regime, **kw):
    """A graphed trainer and an eager one from the same state; the eager
    one's graph is switched off after construction, so both run the same
    AdamW (fused and capturable)."""
    dev = _card()
    graphed, eager = (_trainer(regime, dev, **kw) for _ in range(2))
    assert graphed.step_graph.enabled
    eager.step_graph.enabled = False
    return graphed, eager


def _assert_same_run(graphed, eager, got, want):
    """Metrics (read after every step was issued), counts, students,
    teachers, BatchNorm stats and AdamW's state of two runs, bit for bit:
    the graph replays the eager step's kernels on the same values (on the
    H100, in fp32 and in bf16, two eager runs are bitwise equal too)."""
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            assert torch.equal(g[k], w[k]), k
    a, b = _state(graphed), _state(eager)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for p, q in zip(graphed.optimizer.param_groups[0]["params"],
                    eager.optimizer.param_groups[0]["params"]):
        sa, sb = graphed.optimizer.state[p], eager.optimizer.state[q]
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def _run(regime, tr, batches, schedules):
    return [tr.run_train_steps([b], *_weights(regime, w), a)[0]
            for b, (w, a) in zip(batches, schedules)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_graph_matches_eager_on_card(regime, dtype):
    """HG2, K=5, 64 -> 16, bs 4 over 4 steps: step 1 eager, step 2
    captures and replays, steps 3 and 4 replay; the schedule changes at
    step 3 without a second capture.  Equal to the eager trainer."""
    graphed, eager = _pair(regime, compute_dtype=dtype)
    batches = _batches(graphed, 4)
    schedules = [SCHEDULES[0], SCHEDULES[0], SCHEDULES[1], SCHEDULES[1]]
    got = _run(regime, graphed, batches, schedules)
    want = _run(regime, eager, batches, schedules)
    assert (graphed.eager_steps, graphed.graph_captures,
            graphed.graph_replays) == (1, 1, 3)
    first = next(iter(got[0]))
    assert len({id(m[first]) for m in got}) == 4
    _assert_same_run(graphed, eager, got, want)


@pytest.mark.cuda
def test_warm_start_and_resume_capture_again(tmp_path):
    """``warm_start`` and ``resume`` between steps drop the graph: the
    next step runs eagerly and the one after captures once more; the run
    still equals the eager one."""
    graphed, eager = _pair("mt_ubpl")
    batches = _batches(graphed, 8)
    sched = [SCHEDULES[1]] * 2
    base = str(tmp_path)        # both runs load the graphed run's state
    got, want = [], []
    for tr, out in ((graphed, got), (eager, want)):
        out += _run("mt_ubpl", tr, batches[:2], sched)
        if tr is graphed:
            tr.save(base, 0, False)
        out += _run("mt_ubpl", tr, batches[2:4], sched)
        tr.warm_start(f"{base}/ckpts/checkpoint.pth.tar")
        out += _run("mt_ubpl", tr, batches[4:6], sched)
        tr.resume(base)
        out += _run("mt_ubpl", tr, batches[6:8], sched)
    assert (graphed.eager_steps, graphed.graph_captures,
            graphed.graph_replays) == (3, 3, 5)
    _assert_same_run(graphed, eager, got, want)


@pytest.mark.cuda
def test_replayed_steps_issue_no_synchronize():
    """Five profiled steps of the graphed trainer, every one a replay:
    the host never waits for the card (no stream or device synchronise:
    the batch's indices go up through pinned memory)."""
    from torch.profiler import ProfilerActivity, profile
    tr, _ = _pair("mt_ubpl", compute_dtype="bfloat16")
    batches = _batches(tr, 7)
    tr.run_train_steps(batches[:2], *SCHEDULES[1][0], SCHEDULES[1][1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run_train_steps(batches[2:], *SCHEDULES[1][0], SCHEDULES[1][1])
    torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU]
    steps = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
             if e.name() == "train.step"]
    replays = [e for e in events if e.name() == "train.replay"]
    waits = [e.name() for e in events if "Synchronize" in e.name()
             and any(a <= e.start_ns() <= b for a, b in steps)]
    assert len(steps) == len(replays) == 5
    assert not waits, waits
    assert tr.graph_replays == 6 and tr.eager_steps == 1


@pytest.mark.cuda
def test_graph_switched_off_for_a_while_runs_eagerly():
    """Engagement is decided at set-up; ``step_graph.enabled`` switched
    off for a step (as ``chip_smoke.py`` does for its ``remat`` steps)
    runs that step eagerly, with recomputed forwards, and switched on
    again the graph captured before replays."""
    tr, _ = _pair("mt_ubpl")
    batches = _batches(tr, 5)
    weights, alpha = SCHEDULES[1]
    tr.run_train_steps(batches[:3], *weights, alpha)
    tr.cfg.remat, tr.step_graph.enabled = True, False
    tr.run_train_steps(batches[3:4], *weights, alpha)
    assert (tr.eager_steps, tr.graph_captures, tr.graph_replays) == (2, 1, 2)
    tr.cfg.remat, tr.step_graph.enabled = False, True
    tr.run_train_steps(batches[4:], *weights, alpha)
    assert (tr.eager_steps, tr.graph_captures, tr.graph_replays) == (2, 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("writer", ["eager", "graphed"])
def test_resume_across_graphed_and_eager(writer, tmp_path):
    """A checkpoint written by an eager trainer (plain AdamW, ``step`` on
    the host) resumes into a graphed one, which keeps its fused,
    capturable AdamW with ``step`` on the card, captures again and equals
    its twin with the graph off; one written by a graphed trainer resumes
    into an eager one, which keeps its plain AdamW with ``step`` on the
    host."""
    dev = _card()
    plain = type("EagerMTUBPL", (MTUBPLTrainer,), {"graphs_step": False})
    weights, alpha = SCHEDULES[1]
    base = str(tmp_path)
    if writer == "eager":
        first = plain(Config(**{**KW, "model": "HG2"}), device=dev)
        readers = _pair("mt_ubpl")
    else:
        first, _ = _pair("mt_ubpl")
        readers = [plain(Config(**{**KW, "model": "HG2"}), device=dev)
                   for _ in range(2)]
    batches = _batches(first, 6)
    first.run_train_steps(batches[:3], *weights, alpha)
    first.save(base, 0, False)
    outs = []
    for tr in readers:
        assert tr.resume(base) == 1
        graphed = writer == "eager"
        for g in tr.optimizer.param_groups:
            assert g["capturable"] is graphed, g["capturable"]
            assert g["fused"] is (True if graphed else None), g["fused"]
        for st in tr.optimizer.state.values():
            assert st["step"].device.type == ("cuda" if graphed else "cpu")
        outs.append(_run("mt_ubpl", tr, batches[3:], [SCHEDULES[1]] * 3))
    if writer == "eager":
        assert (readers[0].eager_steps, readers[0].graph_captures,
                readers[0].graph_replays) == (1, 1, 2)
    assert all(bool(torch.isfinite(v).all()) for m in outs[0]
               for v in m.values())
    _assert_same_run(*readers, *outs)
