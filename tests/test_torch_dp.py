"""Data-parallel training of the port (``ubpl_torch.parallel``) in gloo
worlds of two processes on the CPU, against the port's single-process
path and, for one supervised step, against the JAX package's step on a
``("data",)`` mesh of two virtual devices.

The worlds are spawned once per mesh (module fixtures, each with a
deadline: a hang fails the fixture instead of eating the suite's time).
Every scenario runs inside the ranks (``tests/torch_dp_worlds.py``, which
says how: HG1, 64 -> 16, K=5, a global batch of 4 = 2 unlabeled + 2
labeled, float64 networks, the sampler's unlabeled-first batch); the tests
here hold what they return to the tolerances.

The single-process steps are held to the JAX package's by
``tests/test_torch_mt_ubpl.py`` (and the DualPose, MT and MLD files), and
the JAX package holds its mesh step to its single-device step
(``tests/test_sharding.py``); with the world against the single process
here the three close the square.

Tolerances of one step: losses, counts and metrics rtol 1e-9; the summed
gradients within 1e-9 of the network's largest gradient; BatchNorm running
stats within 1e-9 of the tensor's largest.  Parameters within rtol 1e-9
plus an absolute 2.5e-8: AdamW's first step moves a weight by
``lr * g / (|g| + eps)``, and where the exact gradient is 0 (a conv bias in
front of a train-mode BatchNorm) ``g`` is rounding noise, different in
every summation order; a noise up to 1e-12 moves the weight by up to
``lr * 1e-12 / eps`` = 2.5e-8.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worlds as W
from ubpl_torch.models import create_pose_model
from ubpl_torch.models.weights import state_dict_from_jax
from ubpl_torch.parallel import make_mesh
from ubpl_torch.parallel.launch import launch

#: seconds for each world, spawn included: a few times its time in one
#: process on an 8-core CPU host (world ~55 s, dcn ~14 s)
DEADLINE = {"data": 300, "dcn": 90}
RTOL = 1e-9
PARAM_ATOL = 2.5e-8     # lr * 1e-12 / eps (module docstring)
STEPS = {"mt_ubpl": {"regime": "mt_ubpl"},
         "mld": {"regime": "mt_ubpl", "optimizer": "mld", "mld_alpha": 0.5},
         "remat": {"regime": "mt_ubpl", "remat": True},
         "mt": {"regime": "mt"},
         "dualpose_ubpl": {"regime": "dualpose_ubpl", "fold_views": True}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_forward_float64(model, params, batch_stats, images, train,
                         compute_dtype, remat=False):
    """``ubpl_tpu.train.common.forward_heatmaps`` in train mode without the
    cast of its outputs to float32: JAX's loss in float64, as the port's in
    the worlds (``torch_dp_worlds.forward_float64``)."""
    out, mut = model.apply({"params": params, "batch_stats": batch_stats},
                           images.astype(jnp.float64), train=True,
                           mutable=["batch_stats"])
    preds, feats = out if isinstance(out, tuple) else (out, None)
    return (preds, feats), mut["batch_stats"]


@pytest.fixture(scope="module")
def jax_mesh_step():
    """JAX's SupervisedTrainer on a ("data",) mesh of 2 virtual devices:
    one step in float64 (its forward without the float32 cast of its
    outputs) from the port's initialisation of seed 3 (carried by
    ``import_hourglass``, no flax init program), on the view its step
    builds, handed to the step as built (``tests/test_torch_mt_ubpl.py``
    says why)."""
    import ubpl_tpu.train.base_trainer as JB
    import ubpl_tpu.train.supervised as JS
    from jax.sharding import Mesh
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.models.torch_import import import_hourglass
    from ubpl_tpu.train.common import make_view

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(W.KW["seed"])
        init = create_pose_model("HG1", W.K).state_dict()
    real = JB.init_model
    JB.init_model = lambda *a, **k: import_hourglass(
        {k: v.numpy() for k, v in init.items()}, 1)
    try:
        trainer = JS.SupervisedTrainer(
            JConfig(**W.KW, donate_state=False),
            mesh=Mesh(np.asarray(jax.devices()[:2]), ("data",)))
    finally:
        JB.init_model = real
    cfg = trainer.cfg
    idxs = jnp.asarray(W.supervised_batches(trainer.labeled_idxs,
                                            cfg.train_bs, cfg.seed)[0])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jnp.asarray(x, jnp.float64), np_tree(t))
        params = f64(trainer.state.params)
        state = JS.TrainState(params, f64(trainer.state.batch_stats),
                              trainer.tx.init(params))
        imgs = trainer.train_data.images[idxs]
        kps = trainer.train_data.kps[idxs]
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 1)
        view = jax.jit(lambda k: make_view(k, imgs, kps, trainer.means, cfg,
                                           augment=True))(key)
        real = JS.make_view, JS.forward_heatmaps
        JS.make_view = lambda *a, **k: view
        JS.forward_heatmaps = _jax_forward_float64
        try:
            new_state, m = trainer.train_step(state, idxs, 1)
        finally:
            JS.make_view, JS.forward_heatmaps = real
        new_state, m = np_tree(new_state), np_tree(m)
    return {"init": init, "lr": cfg.lr, "loss": float(m["pec_loss"]),
            "count": float(m["pec_count"]),
            "params": state_dict_from_jax(new_state.params,
                                          new_state.batch_stats, 1),
            "views": {"images": np.asarray(view.images, np.float64)
                      .transpose(0, 3, 1, 2).copy(),
                      "heatmaps": np.asarray(view.heatmaps)
                      .transpose(0, 3, 1, 2).copy()}}


@pytest.fixture(scope="module")
def world(jax_mesh_step, tmp_path_factory):
    """Every scenario in one world of 2 ranks on a ("data",) mesh; each
    rank's results."""
    scenarios = [(name, "step", kw) for name, kw in STEPS.items()] + [
        ("supervised", "step", {"regime": "supervised"}),
        ("batchnorm", "batchnorm", {}), ("dataset", "dataset", {}),
        ("validation", "validation", {}), ("pseudo", "pseudo_round", {}),
        ("stream", "stream", {}),
        ("jax", "supervised_on_views", {
            "state": jax_mesh_step["init"],
            "views": jax_mesh_step["views"], "lr": jax_mesh_step["lr"]}),
        ("preemption", "preemption",
         {"base_dir": str(tmp_path_factory.mktemp("dp_stop") / "run")}),
        ("checkpoint", "checkpoint",
         {"base_dir": str(tmp_path_factory.mktemp("dp_run") / "run")})]
    return launch(W.world, make_mesh((2,), ("data",)), "cpu",
                  args=(scenarios,), timeout=DEADLINE["data"])


@pytest.fixture(scope="module")
def dcn_world():
    """The MT_UBPL step on a (dcn=2, data=1) mesh."""
    return launch(W.world, make_mesh((2, 1), ("dcn", "data")), "cpu",
                  args=([("mt_ubpl", "step", {"regime": "mt_ubpl"})],),
                  timeout=DEADLINE["dcn"])


def _metric_cases():
    keys = {"mt_ubpl": ["pec", "mtc", "epc", "fdc", "pec_count", "mtc_count",
                        "epc_count", "fdc_count", "n_pseudo", "n_sel"],
            "mt": ["pec_loss", "pec_count", "mtc_loss", "mtc_count"],
            "supervised": ["pec_loss", "pec_count"]}
    keys["mld"] = keys["remat"] = keys["dualpose_ubpl"] = keys["mt_ubpl"]
    return [(r, k) for r in [*STEPS, "supervised"] for k in keys[r]]


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("regime,key", _metric_cases())
def test_step_metric_matches_one_process(world, regime, key):
    for rank in world:
        r = rank[regime]
        np.testing.assert_allclose(r["dp"][0][key], r["one"][0][key],
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("regime", [*STEPS, "supervised"])
def test_step_gradients_match_one_process(world, regime):
    """The gradients summed over the ranks are the single-process
    gradients (the MLD step: its combined gradient)."""
    for rank in world:
        assert rank[regime]["grad_rel"] <= RTOL


@pytest.mark.parametrize("regime", [*STEPS, "supervised"])
def test_step_parameters_match_one_process(world, regime):
    for rank in world:
        assert rank[regime]["param_excess"] <= PARAM_ATOL


@pytest.mark.parametrize("regime", [*STEPS, "supervised"])
def test_step_bn_stats_match_one_process(world, regime):
    """Students' and teachers' running stats moved from the global batch's
    statistics."""
    for rank in world:
        assert rank[regime]["stat_rel"] <= RTOL


@pytest.mark.parametrize("regime", [*STEPS, "supervised"])
def test_ranks_hold_the_same_networks(world, regime):
    for rank in world:
        assert rank[regime]["ranks_equal"] is True


@pytest.mark.parametrize("regime", list(STEPS))
def test_batch_is_unlabeled_first_and_split_by_rank(world, regime):
    """Rank 0 holds only unlabeled rows and rank 1 only labeled ones: a
    count or a BatchNorm statistic left local would be wrong on both."""
    assert world[0][regime]["batch"] == world[1][regime]["batch"]
    assert world[0][regime]["islabeled_rows"] == [0, 0]
    assert world[1][regime]["islabeled_rows"] == [1, 1]


def test_case_is_nontrivial(world):
    """PEC, EPC and FDC are non-zero in the compared MT_UBPL step and EPC
    selects some entries but not all (views x branches x B x S x K); MTC is
    0 there (its teachers start as copies of the students) and non-zero in
    the DualPose step (a weak teacher view)."""
    m = world[0]["mt_ubpl"]["dp"][0]
    assert (m["pec"] > 0).all() and (m["epc"] > 0).all() and m["fdc"] > 0
    assert 0 < m["n_sel"] < 2 * 2 * 4 * 1 * W.K
    d = world[0]["dualpose_ubpl"]["dp"][0]
    assert (d["mtc"] > 0).all()


# ------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("mode", ["train", "recompute"])
@pytest.mark.parametrize("what", ["y", "x_grad", "param_grad", "stats"])
def test_batchnorm_global_statistics(world, mode, what):
    """BatchNorm alone, two ranks against one process on the whole batch
    (float64, mean 3 and std 2: Chan's combination, not a sum of
    squares): forward, input and parameter gradients, running stats."""
    for rank in world:
        r = rank["batchnorm"][mode]
        assert r[what] <= 1e-12 * max(r["scale"], 1.0), (what, r[what])


@pytest.mark.parametrize("mode,moved", [("train", True),
                                        ("recompute", False)])
def test_batchnorm_recompute_leaves_the_stats(world, mode, moved):
    for rank in world:
        assert rank["batchnorm"][mode]["stats_moved"] is moved


# ---------------------------------------------------------------- dataset
def test_dataset_is_split_over_the_ranks(world):
    """31 training images padded to 32: 16 rows per rank, 1/2 of the
    padded whole's bytes each; the validation set (7, padded to 8) too."""
    a, b = world[0]["dataset"], world[1]["dataset"]
    assert (a["rows"], a["offset"], b["offset"]) == (16, 0, 16)
    assert a["total"] == b["total"] == 32
    whole = 32 * (W.R * W.R * 3 + 2 * W.K * 3 * 4 + 4)
    assert a["bytes"] == b["bytes"] == whole // 2
    assert a["valid_rows"] == b["valid_rows"] == 4


def test_gathered_rows_equal_a_host_gather(world):
    for rank in world:
        assert rank["dataset"]["gather_equal"] is True


# ------------------------------------------------------------- validation
@pytest.mark.parametrize("part", ["preds", "accs", "errs"])
def test_validation_matches_one_process(world, part):
    """Three heads over 7 images in batches of 4 (the last padded to 4 by
    one row that never counts): predictions and the counters' averages."""
    i = ["preds", "accs", "errs"].index(part)
    for rank in world:
        one, dp = rank["validation"]["one"][i], rank["validation"]["dp"][i]
        np.testing.assert_allclose(np.asarray(dp, np.float64),
                                   np.asarray(one, np.float64), rtol=RTOL)
    assert np.shape(world[0]["validation"]["dp"][0]) == (3, 7, W.K, 2)


# ------------------------------------------------------------ pseudo round
@pytest.mark.parametrize("part", ["ori", "augs", "enable", "kps",
                                  "islabeled"])
def test_pseudo_round_matches_one_process(world, part):
    for rank in world:
        one, dp = rank["pseudo"]["one"], rank["pseudo"]["dp"]
        # the world's gathered arrays hold one padding row more
        np.testing.assert_allclose(dp[part][:len(one[part])], one[part],
                                   rtol=RTOL)
        assert dp["rounds"] == one["rounds"] == 1
        assert dp["selected"] == one["selected"]


def test_pseudo_injection_is_split_over_the_ranks(world):
    """13 images padded to 14, 7 rows per rank: each rank wrote the
    injected rows it holds, and the gathered arrays hold every injection
    (every unlabeled sample has an enabled keypoint, so all 13 are
    labeled; the padding row is not)."""
    for rank in world:
        dp = rank["pseudo"]["dp"]
        assert dp["rows"] == 7 and len(dp["kps"]) == 14
        assert dp["islabeled"][:13].sum() == 13
        assert dp["islabeled"][13] == 0


# -------------------------------------------------------------- streaming
@pytest.mark.parametrize("key", ["pec", "mtc", "epc", "fdc"])
def test_stream_data_equals_resident(world, key):
    """Two steps with stream_data (each rank streams its rows) equal two
    resident steps, exactly."""
    for rank in world:
        r = rank["stream"]
        assert r["streamed_data"]
        for res, st in zip(r["resident"], r["streamed"]):
            np.testing.assert_array_equal(st[key], res[key])
        assert r["param_excess"] <= 0 and r["stat_rel"] == 0


# ------------------------------------------------------------ checkpoints
def test_checkpoint_written_once_and_equal(world):
    """Rank 0 wrote the two files (no staged ``.new`` left) and they hold
    the single-process run's keys in its order, its values (one step) and
    its metadata, the gathered pseudo-round state included."""
    for rank in world:
        assert rank["checkpoint"]["files"] == ["checkpoint.pth.tar",
                                               "checkpoint_best.pth.tar"]
    r = world[0]["checkpoint"]
    assert r["keys"][0] == r["keys"][1] and r["net_keys"]
    assert r["worst"] <= PARAM_ATOL
    one, dp = r["meta"]
    assert one["pseudo_rounds_done"] == dp["pseudo_rounds_done"] == 1
    assert one["pseudo_kps"].shape == (5, W.K, 3)
    assert dp["pseudo_kps"].shape == (6, W.K, 3)       # padded for 2 ranks
    np.testing.assert_array_equal(dp["pseudo_kps"][:5], one["pseudo_kps"])
    for key in ("current_epoch", "best_epoch"):
        np.testing.assert_array_equal(dp[key], one[key])


def test_resume_on_another_world_size_raises(world):
    """The world's checkpoint (6 padded rows) resumed on one process
    (5 rows): the JAX package's message."""
    err = world[0]["checkpoint"]["resume_error"]
    assert err.startswith("pseudo-state resume: checkpointed kps (6, 5, 3) "
                          "vs dataset (5, 5, 3)")
    assert "different mesh/device count" in err


def test_preemption_on_one_rank_stops_every_rank(world):
    """The stop flag is summed over the ranks at the epoch boundary: a
    SIGTERM seen by rank 1 alone stops both after epoch 1 of 2."""
    assert [rank["preemption"] for rank in world] == [1, 1]


# ------------------------------------------------------------ against JAX
def test_supervised_step_matches_jax_mesh_step(world, jax_mesh_step):
    """The port's two-rank supervised step on JAX's view against JAX's
    step on a 2-device ("data",) mesh, float64: loss rtol 1e-6, count
    exact, parameters atol 1e-8 (plus the rounding-noise bound of a zero
    gradient, PARAM_ATOL), and rtol 2^-24: ``state_dict_from_jax`` hands
    JAX's parameters over rounded to float32."""
    ref = jax_mesh_step
    for rank in world:
        np.testing.assert_allclose(rank["jax"]["loss"], ref["loss"],
                                   rtol=1e-6)
        assert rank["jax"]["count"] == ref["count"]
    got = world[0]["jax"]["params"]
    for name, want in ref["params"].items():
        if name.endswith(("running_mean", "running_var")):
            continue
        np.testing.assert_allclose(got[name], want.numpy(), rtol=2.0**-24,
                                   atol=1e-8 + PARAM_ATOL, err_msg=name)


# -------------------------------------------------------------- dcn axis
@pytest.mark.parametrize("key", ["pec", "mtc", "epc", "fdc", "n_sel"])
def test_dcn_world_equals_data_world(world, dcn_world, key):
    """(dcn=2, data=1) splits the batch as data=2 does: the same step."""
    for a, b in zip(dcn_world, world):
        np.testing.assert_array_equal(a["mt_ubpl"]["dp"][0][key],
                                      b["mt_ubpl"]["dp"][0][key])
        assert a["mt_ubpl"]["param_excess"] <= PARAM_ATOL
        assert a["mt_ubpl"]["ranks_equal"] is True


# ------------------------------------------------------------------ launch
def _fail_on_rank_1(ctx):
    import torch.distributed as dist
    if ctx.rank == 1:
        raise ValueError("rank 1 stops here")
    dist.barrier()          # rank 0 waits for a rank that never comes
    return "unreachable"


def test_launch_reports_a_failing_rank():
    """A rank that raises takes the launch down with its traceback; the
    rank left waiting in a collective is killed."""
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\\n)*rank 1 "
                                           "stops here"):
        launch(_fail_on_rank_1, make_mesh((2,)), "cpu", timeout=120)


def test_cli_runs_a_cpu_world(tmp_path):
    """``python -m ubpl_torch mt_ubpl --device=cpu --mesh_shape=2``: two
    gloo processes, one run directory written by rank 0, and the run's
    log of its one epoch."""
    from ubpl_torch.__main__ import main
    argv = ["mt_ubpl", "--device=cpu", "--mesh_shape=2",
            f"--experiment_root={tmp_path}", "--synthetic_data=True",
            "--model=HG1", "--synthetic_kps=5", "--inp_res=64",
            "--out_res=16", "--train_count=8", "--valid_count=4",
            "--label_ratio=0.5", "--train_bs=4", "--train_bs_labeled=2",
            "--infer_bs=4", "--epochs=1", "--compute_dtype=float32"]
    assert main(argv) == 0
    (run,) = os.listdir(tmp_path)
    logs = os.path.join(tmp_path, run, "logs")
    assert os.path.exists(os.path.join(logs, "logData", "logData_1.json"))
    assert sorted(os.listdir(os.path.join(tmp_path, run, "ckpts"))) == [
        "checkpoint.pth.tar", "checkpoint_best.pth.tar"]
    with open(os.path.join(logs, "log_L1.log")) as f:
        lines = f.read().splitlines()
    assert sum("[  1/  1]" in line for line in lines) == 1
    assert any("=> mesh {'data': 2}" in line for line in lines)
    shutil.rmtree(tmp_path / run)       # two 80 MB checkpoints
