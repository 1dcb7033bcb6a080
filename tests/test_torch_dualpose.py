"""One DualPose_UBPL step of the port against the JAX package's real
``DualPoseUBPLTrainer.train_step`` on the same state and the same views,
the ``dualpose`` switches, the weak teacher view and ``exec_regime``'s
defaults.

All JAX work runs once, in the module-scoped ``ref`` fixture: HG2, K=5,
64 -> 16, ``train_bs=4`` (2 unlabeled + 2 labeled), synthetic data, the
networks in float64 on both sides (ROADMAP C.3).  Both sides start from
the port's initialisation of branch i from ``seed + i``, carried into the
JAX trainer through ``ubpl_tpu.models.torch_import.import_hourglass`` in
place of its flax init (which would only add an XLA compile of the init
program to this file).  The JAX step is handed the very views the port
gets (the student view from ``fold_in(key, 0)``, the weak teacher view from
``fold_in(key, 1)``, built beforehand with JAX's keys), as
``tests/test_torch_mt_ubpl.py`` explains.

The case is non-trivial: the teachers are perturbed copies of the
students, ``cons_weight`` 3.0, ``fdl_weight`` 0.7, ``pseudo_weight`` 0.8,
``ema_alpha`` 0.5, ``pseudo_score_thr`` 0.02 so that MTC's confidence mask
and EPC select some joints but not all.
"""
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubpl_torch.config import Config
from ubpl_torch.models import create_pose_model
from ubpl_torch.models.weights import branch_state_dicts_from_jax, load_state
from ubpl_torch.train import common as C
from ubpl_torch.train import dualpose_ubpl as DP

K, R, OUT, BS = 5, 64, 16, 4
KW = dict(model="HG2", synthetic_data=True, synthetic_kps=K, inp_res=R,
          out_res=OUT, train_count=8, valid_count=4, label_ratio=0.5,
          train_bs=BS, train_bs_labeled=2, infer_bs=4,
          compute_dtype="float32", pseudo_score_thr=0.02, seed=3,
          scale_range_ema=0.05, rot_range_ema=5.0)
SCHED = dict(cons_weight=3.0, fdl_weight=0.7, pseudo_weight=0.8,
             ema_alpha=0.5)
IDXS = np.array([5, 6, 0, 1])       # unlabeled first, then labeled
STEP_NUM = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_init_stacked(model, rngs, sample_input, train=True):
    """Stand-in for ``ubpl_tpu.models.factory.init_model_stacked``: the
    port's branch i (``torch.manual_seed(seed + i)``) as flax trees with a
    leading branch axis."""
    from ubpl_tpu.models.torch_import import import_hourglass
    trees = []
    for i in range(len(rngs)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(KW["seed"] + i)
            net = create_pose_model(KW["model"], K)
        sd = {k: v.numpy() for k, v in net.state_dict().items()}
        trees.append(import_hourglass(sd, 2))
    return jax.tree_util.tree_map(lambda *x: np.stack(x), *trees)


@pytest.fixture(scope="module")
def ref():
    """JAX package: the real DualPoseUBPLTrainer, its two views, one
    train_step in float64; everything returned as numpy."""
    import ubpl_tpu.train.base_trainer as JB
    import ubpl_tpu.train.dualpose_ubpl as JD
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.train.common import make_view

    real_init = JB.init_model_stacked
    JB.init_model_stacked = _port_init_stacked
    try:
        trainer = JD.DualPoseUBPLTrainer(JConfig(**KW))
    finally:
        JB.init_model_stacked = real_init
    cfg = trainer.cfg
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    rng = np.random.default_rng(5)

    def perturbed(tree):
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x) * (1 + 0.05 * rng.standard_normal(
                np.shape(x))).astype(np.float32), tree)

    st = trainer.state
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jnp.asarray(x, jnp.float64), t)
        params = f64(np_tree(st.params))
        state = JD.DualState(params, f64(np_tree(st.batch_stats)),
                             f64(perturbed(st.ema_params)),
                             f64(perturbed(st.ema_batch_stats)),
                             trainer.tx.init(params))
        before = np_tree(state._replace(opt_state=None))
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), STEP_NUM)
        imgs, kps, islabeled = trainer.fetch_batch(trainer.train_data,
                                                   jnp.asarray(IDXS))
        stu = jax.jit(lambda k: make_view(
            k, imgs, kps, trainer.means, cfg, augment=True,
            occluder_bank=None))(jax.random.fold_in(key, 0))
        ema = jax.jit(lambda k: make_view(
            k, imgs, kps, trainer.means, cfg, augment=True,
            scale_range=cfg.scale_range_ema, rot_range=cfg.rot_range_ema,
            occluder_bank=None, use_occlusion=False))(
                jax.random.fold_in(key, 1))
        handed = iter([stu, ema])
        real_make_view = JD.make_view
        JD.make_view = lambda *a, **k: next(handed)
        try:
            new_state, aux = trainer.train_step(
                state, jnp.asarray(IDXS), STEP_NUM, SCHED["cons_weight"],
                SCHED["fdl_weight"], SCHED["pseudo_weight"],
                SCHED["ema_alpha"])
        finally:
            JD.make_view = real_make_view
        assert next(handed, None) is None       # the step built both views
        return {"before": before,
                "after": np_tree(new_state._replace(opt_state=None)),
                "aux": np_tree(aux),
                "views": [np_tree(v._asdict()) for v in (stu, ema)],
                "islabeled": np.array(islabeled)}


def _cfg(**kw):
    cfg = Config(**{**KW, **kw})
    cfg.kps_count = K
    return cfg


def _views(ref):
    """The JAX-built (student, teacher) views as the port's ViewBatch:
    NHWC -> NCHW, images in float64 for the float64 networks."""
    out = []
    for v in ref["views"]:
        t = {k: torch.as_tensor(np.array(x)) for k, x in v.items()}
        t["images"] = t["images"].permute(0, 3, 1, 2).double()
        t["heatmaps"] = t["heatmaps"].permute(0, 3, 1, 2).contiguous()
        out.append(C.ViewBatch(**t))
    return out


def _branches(ref, n=2):
    """Students, teachers (float64) and the AdamW over the students, from
    the JAX state before the step."""
    cfg = _cfg()
    s_sd, t_sd = branch_state_dicts_from_jax(
        SimpleNamespace(**ref["before"]._asdict()), 2, n_branch=2)
    make = lambda sd: load_state(create_pose_model("HG2", K),  # noqa: E731
                                 sd).double()
    students = [make(sd) for sd in s_sd[:n]]
    teachers = [make(sd).requires_grad_(False) for sd in t_sd[:n]]
    opt = torch.optim.AdamW(
        itertools.chain(*(s.parameters() for s in students)), lr=cfg.lr,
        weight_decay=cfg.wd)
    return students, teachers, opt


def _step(ref, cfg, n=2, **sched):
    students, teachers, opt = _branches(ref, n)
    stu, ema = _views(ref)
    metrics = DP.dualpose_step(students, teachers, opt, stu, ema,
                               torch.as_tensor(ref["islabeled"]), cfg=cfg,
                               **{**SCHED, **sched})
    return students, teachers, metrics


@pytest.fixture(scope="module")
def port(ref):
    students, teachers, metrics = _step(ref, _cfg())
    want_s, want_t = branch_state_dicts_from_jax(
        SimpleNamespace(**ref["after"]._asdict()), 2, n_branch=2)
    return {"students": students, "teachers": teachers, "metrics": metrics,
            "want": {"student": want_s, "teacher": want_t}}


def _is_stat(key):
    return key.endswith(("running_mean", "running_var"))


# ------------------------------------------------------ against ubpl_tpu
def test_case_is_nontrivial(ref):
    """Labeled and unlabeled samples, EPC selecting some joints but not
    all, every loss > 0, and a weak teacher view that differs from the
    student view."""
    aux = ref["aux"]
    assert ref["islabeled"].tolist() == [0, 0, 1, 1]
    n_entries = 2 * BS * 2 * K           # branches x B x S x K
    assert 0 < aux["n_sel"] < n_entries
    assert aux["n_pseudo"] == n_entries / 2      # the unlabeled half
    for key in ("pec", "mtc", "epc"):
        assert (aux[key] > 0).all(), key
    assert aux["fdc"] > 0 and aux["fdc_count"] > 0
    stu, ema = ref["views"]
    assert not np.array_equal(stu["images"], ema["images"])
    assert np.abs(ema["angle"]).max() <= 5.0 < np.abs(stu["angle"]).max()


@pytest.mark.parametrize("key", ["pec", "mtc", "epc", "fdc"])
def test_step_loss_matches_jax(ref, port, key):
    """The four weighted losses (per branch): rtol 1e-5."""
    np.testing.assert_allclose(port["metrics"][key].numpy(), ref["aux"][key],
                               rtol=1e-5)


@pytest.mark.parametrize("key", ["pec_count", "mtc_count", "epc_count",
                                 "fdc_count", "n_pseudo", "n_sel"])
def test_step_count_matches_jax(ref, port, key):
    """Every count is exactly the JAX step's."""
    np.testing.assert_array_equal(port["metrics"][key].numpy(),
                                  ref["aux"][key])


def _assert_params_close(got, want, tol):
    """AdamW's first step moves each weight by about lr * sign(g): a
    gradient that is rounding noise around 0 (a conv bias in front of a
    train-mode BatchNorm) may flip it, so: all within 3e-4 (about one lr),
    and >= 99.9% of elements within ``tol``."""
    n_tot = n_close = 0
    for name, p in got.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 3e-4, (name, d.max())
        n_tot += d.size
        n_close += int((d <= tol).sum())
    assert n_close / n_tot >= 0.999, n_close / n_tot


@pytest.mark.parametrize("branch", [0, 1])
def test_step_student_params_match_jax(port, branch):
    """Post-step student parameters: >= 99.9% within 1e-6 (see
    _assert_params_close)."""
    _assert_params_close(port["students"][branch],
                         port["want"]["student"][branch], 1e-6)


@pytest.mark.parametrize("branch", [0, 1])
def test_step_ema_params_match_jax(port, branch):
    """EMA parameters, 0.5 * teacher + 0.5 * NEW student: >= 99.9% within
    1e-6."""
    _assert_params_close(port["teachers"][branch],
                         port["want"]["teacher"][branch], 1e-6)


@pytest.mark.parametrize("net", ["student", "teacher"])
@pytest.mark.parametrize("branch", [0, 1])
def test_step_bn_stats_match_jax(port, net, branch):
    """BatchNorm running stats of all four networks after one train-mode
    forward each (students on the student view, teachers on the teacher
    view): rtol 1e-6."""
    want = port["want"][net][branch]
    got = port[net + "s"][branch].state_dict()
    keys = [k for k in want if _is_stat(k)]
    assert len(keys) > 100
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-6, err_msg=key)


def test_teachers_see_the_teacher_view(ref):
    """The teachers run on the weak view: swapping the two views changes
    MTC (the teachers' targets), not the students' PEC inputs' count."""
    students, teachers, opt = _branches(ref)
    stu, ema = _views(ref)
    swapped = DP.dualpose_step(students, teachers, opt, ema, stu,
                               torch.as_tensor(ref["islabeled"]),
                               cfg=_cfg(), **SCHED)
    assert not np.allclose(swapped["mtc"].numpy(), ref["aux"]["mtc"],
                           rtol=1e-3)


# ------------------------------------------------- the dualpose switches
@pytest.fixture(scope="module")
def dualpose(ref):
    """The ``dualpose`` regime's step: FDL off, no EPC."""
    return _step(ref, _cfg(fdl_weight_max=0.0, fdl_weight_min=0.0,
                           use_ensemble_pseudo=False), fdl_weight=0.0)


@pytest.mark.parametrize("key", ["pec", "mtc"])
def test_dualpose_keeps_pec_and_mtc(ref, dualpose, key):
    """Without FDL and EPC the forward terms PEC and MTC are unchanged
    (they read the pre-step networks): the JAX DualPose_UBPL step's values,
    rtol 1e-5, and their counts exactly."""
    m = dualpose[2]
    np.testing.assert_allclose(m[key].numpy(), ref["aux"][key], rtol=1e-5)
    np.testing.assert_array_equal(m[key + "_count"].numpy(),
                                  ref["aux"][key + "_count"])


@pytest.mark.parametrize("key", ["epc", "epc_count", "fdc", "fdc_count",
                                 "n_pseudo", "n_sel"])
def test_dualpose_drops_epc_and_fdc(dualpose, key):
    """EPC and FDC and their counts are 0 in the ``dualpose`` step."""
    assert float(dualpose[2][key].abs().sum()) == 0.0


def test_dualpose_branches_are_independent(ref, dualpose):
    """With FDL and EPC off the branches do not interact: branch 0 of the
    step is the step of branch 0 alone (float64, to rounding)."""
    cfg = _cfg(fdl_weight_max=0.0, fdl_weight_min=0.0,
               use_ensemble_pseudo=False)
    (s0,), (t0,), m = _step(ref, cfg, n=1, fdl_weight=0.0)
    np.testing.assert_allclose(m["pec"].numpy(), dualpose[2]["pec"][:1],
                               rtol=1e-9)
    for a, b in ((s0, dualpose[0][0]), (t0, dualpose[1][0])):
        for (name, x), y in zip(a.state_dict().items(),
                                b.state_dict().values()):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=name)


def test_dualpose_update_differs_from_dualpose_ubpl(port, dualpose):
    """Dropping FDL and EPC changes the students' update."""
    a = port["students"][0].pre[0].conv.weight
    b = dualpose[0][0].pre[0].conv.weight
    assert not torch.allclose(a, b, rtol=0, atol=1e-9)


# --------------------------------------------------------------- trainer
def _tiny(**kw):
    return Config(**{**KW, "model": "HG1", "train_count": 12, **kw})


def test_train_step_builds_a_strong_and_a_weak_view(monkeypatch):
    """One trainer step builds two views from one gathered batch: the
    student view with the full ranges, the teacher view with the ema
    ranges (two heatmap-kernel wrapper calls); metrics are finite."""
    from ubpl_torch.train.base_trainer import BaseTrainer
    calls = []
    real = BaseTrainer.augmented_view

    def spy(self, imgs, kps, **kw):
        calls.append(kw)
        return real(self, imgs, kps, **kw)

    monkeypatch.setattr(BaseTrainer, "augmented_view", spy)
    tr = DP.DualPoseUBPLTrainer(_tiny(), device="cpu")
    sched = tr.epoch_schedules(1)
    (m,) = tr.run_train_steps([next(iter(tr.make_sampler()))],
                              *sched.values())
    assert calls == [{}, {"scale_range": 0.05, "rot_range": 5.0,
                          "occlude": False}]
    assert all(torch.isfinite(v).all() for v in m.values())
    assert tr.valid_heads == ("teacher1", "teacher2", "mean")


def _captured(monkeypatch, params):
    """The (trainer class, params) that each package's exec_regime hands to
    its run_regime."""
    import ubpl_tpu.train.base_trainer as JB
    from ubpl_tpu.train.dualpose_ubpl import exec_regime as jexec
    seen = {}
    monkeypatch.setattr(JB, "run_regime",
                        lambda cls, mark, p: seen.setdefault("jax", p))
    monkeypatch.setattr(DP, "run_regime",
                        lambda cls, mark, p, device: seen.setdefault(
                            "port", (cls, p, device)))
    jexec("DualPose_UBPL", dict(params))
    DP.exec_regime("DualPose_UBPL", dict(params), "cpu")
    return seen


@pytest.mark.parametrize("params", [
    {}, {"scale_range_ema": 0.2}, {"rotRange_ema": 12.0},
    {"scaleRange_ema": 0.1, "rot_range_ema": 3.0}])
def test_exec_regime_weak_view_defaults(monkeypatch, params):
    """exec_regime weakens the teacher view to scale 0.05 / rotation 5.0
    only where the parameters do not set them (either alias), as the JAX
    package's does."""
    seen = _captured(monkeypatch, params)
    cls, p, device = seen["port"]
    assert cls is DP.DualPoseUBPLTrainer and device == "cpu"
    assert p == seen["jax"]
    cfg = Config().override(p)
    given = Config(scale_range_ema=0.05, rot_range_ema=5.0).override(params)
    assert (cfg.scale_range_ema, cfg.rot_range_ema) == (
        given.scale_range_ema, given.rot_range_ema)
