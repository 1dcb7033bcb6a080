"""Branch parallelism of the port (the mesh's ``model`` axis) in gloo worlds
of processes on the CPU, against the port's single-process path and, for
one MT_UBPL step, against the JAX package's step on a ``("model",)`` mesh of
two virtual devices.

Two worlds, spawned once each by one module fixture while this process
compiles and runs the JAX step (each with a deadline a few times its
measured time):

  * ``("model",)`` = 2: each rank holds one (student, EMA teacher) branch.
    The MT_UBPL step (AdamW), the MLD step, an FDC-only step (PEC, MTC and
    EPC weighted 0: the one whose gradients show a double-counted FDC), the
    DualPose_UBPL step, the MT step (no branch axis: replicated on both
    ranks), validation, a pseudo round, checkpoints both ways, and the step
    on the JAX package's views and state;
  * ``("model", "data")`` = 2 x 2: the MT_UBPL step, each branch's batch
    split over two ranks.

Every scenario runs inside the ranks (``tests/torch_dp_worlds.py``: HG1,
64 -> 16, K=5, a global batch of 4 = 2 unlabeled + 2 labeled, float64
networks, torch single-threaded).  Tolerances are ``tests/test_torch_dp.py``'s
for its reasons: losses, counts and metrics rtol 1e-9; summed gradients
within 1e-9 of the network's largest; parameters rtol 1e-9 plus 2.5e-8;
BatchNorm running stats 1e-9.
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
from ubpl_torch.models.weights import branch_state_dicts_from_jax
from ubpl_torch.parallel import make_mesh
from ubpl_torch.parallel.launch import launch

#: seconds for each world, spawn included: a few times its time in one
#: process on an 8-core CPU host (model ~40 s, model_data ~15 s)
DEADLINE = {"model": 240, "model_data": 120}
RTOL = 1e-9
PARAM_ATOL = 2.5e-8     # lr * 1e-12 / eps (tests/test_torch_dp.py)
SSL = ("pec", "mtc", "epc", "fdc", "pec_count", "mtc_count", "epc_count",
       "fdc_count", "n_pseudo", "n_sel")
STEPS = {"mt_ubpl": {"regime": "mt_ubpl"},
         "mld": {"regime": "mt_ubpl", "optimizer": "mld", "mld_alpha": 0.5},
         "fdc_only": {"regime": "mt_ubpl", "pose_weight": 0.0,
                      "ensemble_pseudo_weight": 0.0,
                      "sched": (0.0,) + W.SSL_SCHED[1:]},
         "dualpose_ubpl": {"regime": "dualpose_ubpl"},
         "mt": {"regime": "mt"}}
KEYS = {"mt": ["pec_loss", "pec_count", "mtc_loss", "mtc_count"]}
#: the MT_UBPL step compared with JAX: the teachers are perturbed copies
#: of the students (else MTC is 0), as in tests/test_torch_mt_ubpl.py
IDXS = np.array([5, 6, 0, 1])       # unlabeled first, then labeled
STEP_NUM = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_init_stacked(model, rngs, sample_input, train=True):
    """Stand-in for ``init_model_stacked``: the port's branch i
    (``torch.manual_seed(seed + i)``) as flax trees with a branch axis."""
    from ubpl_tpu.models.torch_import import import_hourglass
    trees = []
    for i in range(len(rngs)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(W.KW["seed"] + i)
            net = create_pose_model("HG1", W.K)
        trees.append(import_hourglass(
            {k: v.numpy() for k, v in net.state_dict().items()}, 1))
    return jax.tree_util.tree_map(lambda *x: np.stack(x), *trees)


def _jax_forward_float64(model, params, batch_stats, images, train,
                         compute_dtype, remat=False):
    """``ubpl_tpu.train.common.forward_heatmaps`` in train mode without the
    cast of its outputs to float32 (the worlds' forward is float64 too)."""
    out, mut = model.apply({"params": params, "batch_stats": batch_stats},
                           images.astype(jnp.float64), train=True,
                           mutable=["batch_stats"])
    preds, feats = out if isinstance(out, tuple) else (out, None)
    return (preds, feats), mut["batch_stats"]


def _jax_trainer_state_and_views():
    """JAX's MTUBPLTrainer on a ("model",) mesh of 2 virtual devices, from
    the port's initialisation: its float64 state (teachers perturbed) and
    the views its step builds, as numpy."""
    import ubpl_tpu.train.base_trainer as JB
    import ubpl_tpu.train.mt_ubpl as JM
    from jax.sharding import Mesh
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.train.common import make_view

    real = JB.init_model_stacked
    JB.init_model_stacked = _port_init_stacked
    try:
        trainer = JM.MTUBPLTrainer(
            JConfig(**W.KW, donate_state=False),
            mesh=Mesh(np.asarray(jax.devices()[:2]), ("model",)))
    finally:
        JB.init_model_stacked = real
    cfg = trainer.cfg
    rng = np.random.default_rng(5)

    def perturbed(tree):
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x) * (1 + 0.05 * rng.standard_normal(
                np.shape(x))).astype(np.float32), tree)

    st = trainer.state
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    before = JM.DualState(np_tree(st.params), np_tree(st.batch_stats),
                          perturbed(st.ema_params),
                          perturbed(st.ema_batch_stats), None)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), STEP_NUM)
    imgs, kps, islabeled = trainer.fetch_batch(trainer.train_data,
                                               jnp.asarray(IDXS))
    build = jax.jit(lambda k: make_view(
        k, imgs, kps, trainer.means, cfg, augment=True, occluder_bank=None))
    views = [np_tree(build(jax.random.fold_in(key, a)))
             for a in range(trainer.n_views)]
    return trainer, before, views, np.asarray(islabeled)


def _jax_step(trainer, before, views):
    """One ``train_step`` of ``trainer`` in float64 from ``before``, handed
    ``views`` (bit-identical inputs: ``tests/test_torch_mt_ubpl.py`` says
    why) and run with a forward that keeps float64; its metrics."""
    import ubpl_tpu.train.base_trainer as JB
    import ubpl_tpu.train.mt_ubpl as JM
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jnp.asarray(x, jnp.float64), t)
        params = f64(before.params)
        state = JM.DualState(params, f64(before.batch_stats),
                             f64(before.ema_params),
                             f64(before.ema_batch_stats),
                             trainer.tx.init(params))
        handed = iter(views)
        real = JM.make_view, JB.forward_heatmaps
        JM.make_view = lambda *a, **k: next(handed)
        JB.forward_heatmaps = _jax_forward_float64
        try:
            _, aux = trainer.train_step(
                state, jnp.asarray(IDXS), STEP_NUM, *W.SSL_SCHED)
        finally:
            JM.make_view, JB.forward_heatmaps = real
        assert next(handed, None) is None
        return {k: np.asarray(v) for k, v in aux.items() if k in SSL}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds and the JAX step.  The worlds run in their processes
    while this one compiles and runs the JAX step: the model world gets
    JAX's state and views (NCHW) for its ``mt_ubpl_on_views`` scenario."""
    from concurrent.futures import ThreadPoolExecutor
    trainer, before, views, islabeled = _jax_trainer_state_and_views()
    students, teachers = branch_state_dicts_from_jax(before, 1, n_branch=2)
    as_np = lambda sd: {k: t.numpy() for k, t in sd.items()}  # noqa: E731

    def nchw(v):
        v = {k: np.asarray(x) for k, x in v._asdict().items()}
        v["images"] = v["images"].astype(np.float64).transpose(0, 3, 1, 2)
        v["heatmaps"] = np.ascontiguousarray(
            v["heatmaps"].transpose(0, 3, 1, 2))
        return v
    scenarios = [(name, "step", kw) for name, kw in STEPS.items()] + [
        ("validation", "validation", {}), ("pseudo", "pseudo_round", {}),
        ("checkpoint", "branch_checkpoint",
         {"base_dir": str(tmp_path_factory.mktemp("branch_run"))}),
        ("jax", "mt_ubpl_on_views", {
            "students": [as_np(sd) for sd in students],
            "teachers": [as_np(sd) for sd in teachers],
            "views": [nchw(v) for v in views], "islabeled": islabeled,
            "sched": W.SSL_SCHED})]
    with ThreadPoolExecutor(2) as pool:
        model = pool.submit(launch, W.world, make_mesh((2,), ("model",)),
                            "cpu", args=(scenarios,),
                            timeout=DEADLINE["model"])
        model_data = pool.submit(
            launch, W.world, make_mesh((2, 2), ("model", "data")), "cpu",
            args=([("mt_ubpl", "step", {"regime": "mt_ubpl"})],),
            timeout=DEADLINE["model_data"])
        aux = _jax_step(trainer, before, views)
        return {"model": model.result(), "model_data": model_data.result(),
                "jax": aux}


@pytest.fixture(scope="module")
def world(runs):
    """The ranks' results of the ("model",) = 2 world."""
    return runs["model"]


CASES = [("model", r) for r in STEPS] + [("model_data", "mt_ubpl")]


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("mesh,regime,key", [
    (m, r, k) for m, r in CASES for k in KEYS.get(r, SSL)])
def test_step_metric_matches_one_process(runs, mesh, regime, key):
    for rank in runs[mesh]:
        r = rank[regime]
        np.testing.assert_allclose(r["dp"][0][key], r["one"][0][key],
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("mesh,regime", CASES)
def test_step_gradients_match_one_process(runs, mesh, regime):
    """Each rank's students' gradients (summed over its batch group) are
    one process's gradients of the same branch; the FDC-only step's are
    FDC's alone, counted twice as in one process."""
    for rank in runs[mesh]:
        assert rank[regime]["grad_rel"] <= RTOL


@pytest.mark.parametrize("mesh,regime", CASES)
def test_step_parameters_match_one_process(runs, mesh, regime):
    for rank in runs[mesh]:
        assert rank[regime]["param_excess"] <= PARAM_ATOL


@pytest.mark.parametrize("mesh,regime", CASES)
def test_step_bn_stats_match_one_process(runs, mesh, regime):
    for rank in runs[mesh]:
        assert rank[regime]["stat_rel"] <= RTOL


@pytest.mark.parametrize("mesh,regime", CASES)
def test_ranks_of_a_branch_hold_the_same_networks(runs, mesh, regime):
    """The ranks of a branch's batch group (or, for MT, the whole world)
    hold equal networks after the step."""
    for rank in runs[mesh]:
        assert rank[regime]["ranks_equal"] is True


@pytest.mark.parametrize("mesh,ranks", [
    ("model", [["model1_state", "model1_ema_state"],
               ["model2_state", "model2_ema_state"]]),
    ("model_data", [["model1_state", "model1_ema_state"]] * 2
     + [["model2_state", "model2_ema_state"]] * 2)])
def test_each_rank_holds_its_branch(runs, mesh, ranks):
    """Branch i lives on model index i (rank-major over ``model``); MT has
    no branch axis and runs whole on every rank."""
    got = runs[mesh]
    assert [r["mt_ubpl"]["networks"] for r in got] == ranks
    if mesh == "model":
        assert [r["mt"]["networks"] for r in got] == [
            ["model_state", "model_ema_state"]] * 2


def test_model_data_world_splits_the_batch(runs):
    """On (model=2, data=2) each rank holds 2 rows of the batch: unlabeled
    on data index 0, labeled on data index 1."""
    assert [r["mt_ubpl"]["islabeled_rows"] for r in runs["model_data"]] == [
        [0, 0], [1, 1], [0, 0], [1, 1]]


def test_steps_are_nontrivial(world):
    """PEC, EPC and FDC are non-zero in the compared MT_UBPL step and EPC
    selects some entries but not all; the FDC-only step has FDC alone; MTC
    is non-zero in the DualPose step (a weak teacher view)."""
    m = world[0]["mt_ubpl"]["dp"][0]
    assert (m["pec"] > 0).all() and (m["epc"] > 0).all() and m["fdc"] > 0
    assert 0 < m["n_sel"] < 2 * 2 * 4 * 1 * W.K
    f = world[0]["fdc_only"]["dp"][0]
    assert f["fdc"] > 0 and not f["pec"].any() and not f["mtc"].any()
    assert not f["epc"].any()
    assert (world[0]["dualpose_ubpl"]["dp"][0]["mtc"] > 0).all()


# ------------------------------------------------------------- validation
@pytest.mark.parametrize("part", ["preds", "accs", "errs"])
def test_validation_matches_one_process(world, part):
    """Three heads (teacher1, teacher2 and the mean of their coordinates)
    over 7 images in batches of 4, each rank predicting with its teacher."""
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
    """Both teachers' predictions gathered over the ranks, the selection,
    and the injection (each rank holds the whole training set)."""
    for rank in world:
        one, dp = rank["pseudo"]["one"], rank["pseudo"]["dp"]
        np.testing.assert_allclose(dp[part], one[part], rtol=RTOL)
        assert dp["rounds"] == one["rounds"] == 1
        assert dp["selected"] == one["selected"]
        assert dp["rows"] == 13


# ------------------------------------------------------------ checkpoints
def test_world_checkpoint_equals_one_process(world):
    """Rank 0 wrote the two files; they hold one process's keys in its
    order (both branches' networks, then one AdamW over both students) and
    its values, the AdamW state's layout included."""
    for rank in world:
        r = rank["checkpoint"]
        assert r["files"] == ["checkpoint.pth.tar", "checkpoint_best.pth.tar"]
        assert r["keys"][0] == r["keys"][1] == [
            "model1_state", "model1_ema_state", "model2_state",
            "model2_ema_state", "optim_state"]
        assert r["net_keys"] and r["optim_layout"]
        assert r["net_worst"] <= PARAM_ATOL and r["optim_worst"] <= RTOL
        assert r["meta_rounds"] == 1


@pytest.mark.parametrize("way", ["file_on_one", "one_file_in_world"])
@pytest.mark.parametrize("key", ["pec", "mtc", "epc", "fdc", "n_sel"])
def test_resumed_step_matches_one_process(world, way, key):
    """The world's checkpoint resumed on one process, and one process's
    checkpoint resumed in the world: the next step of each equals that of
    one process resumed from its own checkpoint (same batch and draws)."""
    for rank in world:
        steps = rank["checkpoint"]["steps"]
        np.testing.assert_allclose(steps[way][key], steps["one"][key],
                                   rtol=RTOL, atol=0)
        assert rank["checkpoint"]["resume_epochs"] == [1, 1, 1]


@pytest.mark.parametrize("way", ["file_on_one", "one_file_in_world"])
def test_resumed_networks_match_one_process(world, way):
    for rank in world:
        r = rank["checkpoint"][way]
        assert r["grad_rel"] <= RTOL and r["stat_rel"] <= RTOL
        assert r["param_excess"] <= PARAM_ATOL


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("key", SSL)
def test_step_matches_jax_model_mesh_step(world, runs, key):
    """The world's MT_UBPL step on JAX's views and state against JAX's
    ``MTUBPLTrainer.train_step`` on a 2-device ("model",) mesh, float64 on
    both sides: rtol 1e-6."""
    want = runs["jax"][key]
    for rank in world:
        np.testing.assert_allclose(rank["jax"]["metrics"][key], want,
                                   rtol=1e-6)


def test_jax_step_is_nontrivial(runs):
    aux = runs["jax"]
    for key in ("pec", "mtc", "epc"):
        assert (aux[key] > 0).all(), key
    assert aux["fdc"] > 0 and 0 < aux["n_sel"] < aux["n_pseudo"] * 2


# ------------------------------------------------------------------ CLI
def test_cli_refuses_a_model_axis_that_splits_no_branch(tmp_path):
    """A two-branch regime on model=4: the JAX package's message, before
    any process is started."""
    from ubpl_torch.__main__ import main
    with pytest.raises(ValueError, match=r"^branch axis 2 not divisible by "
                                         r"'model' mesh axis \(4\)$"):
        main(["mt_ubpl", "--device=cpu", "--mesh_shape=4",
              "--mesh_axes=model", f"--experiment_root={tmp_path}",
              "--synthetic_data=True"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("shape,axes,mesh", [
    ("2", "model", "{'model': 2}"),
    ("2,2", "model,data", "{'model': 2, 'data': 2}")])
def test_cli_trains_on_a_model_mesh(tmp_path, shape, axes, mesh):
    """``python -m ubpl_torch mt_ubpl --device=cpu --mesh_shape=...
    --mesh_axes=model[,data]``: gloo processes on the CPU, one run
    directory written by rank 0 with both branches in its checkpoint, and
    the log of its one epoch."""
    from ubpl_torch.__main__ import main
    from ubpl_torch.train.checkpointing import restore_checkpoint
    argv = ["mt_ubpl", "--device=cpu", f"--mesh_shape={shape}",
            f"--mesh_axes={axes}", f"--experiment_root={tmp_path}",
            "--synthetic_data=True", "--model=HG1", "--synthetic_kps=5",
            "--inp_res=64", "--out_res=16", "--train_count=8",
            "--valid_count=4", "--label_ratio=0.5", "--train_bs=4",
            "--train_bs_labeled=2", "--infer_bs=4", "--epochs=1",
            "--compute_dtype=float32"]
    assert main(argv) == 0
    (run,) = os.listdir(tmp_path)
    state, _ = restore_checkpoint(tmp_path / run)
    assert list(state) == ["model1_state", "model1_ema_state",
                           "model2_state", "model2_ema_state", "optim_state"]
    with open(os.path.join(tmp_path, run, "logs", "log_L1.log")) as f:
        lines = f.read().splitlines()
    assert sum("[  1/  1]" in line for line in lines) == 1
    assert any(f"=> mesh {mesh}" in line for line in lines)
    shutil.rmtree(tmp_path / run)       # two 80 MB checkpoints
