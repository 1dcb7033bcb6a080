"""One MT_UBPL step of the port against the JAX package's real
``MTUBPLTrainer.train_step`` on the same state and the same views, and the
port-only properties of the step (remat, fold_views, the MT subset).

All JAX work runs once, in the module-scoped ``ref`` fixture (the jitted
step's compile dominates this file): HG2, K=5, 64 -> 16, ``train_bs=4``
(2 unlabeled + 2 labeled), synthetic data, the networks in float64 on both
sides (heatmaps and losses are float32 on both, as ``forward_heatmaps``
casts them): at this size the train-mode network is ill-conditioned in
float32 (ROADMAP C.3).

Both sides start from the port's initialisation of branch i from
``seed + i``, carried into the JAX trainer through
``ubpl_tpu.models.torch_import.import_hourglass`` in place of its flax init
(which would only add an XLA compile of the init program, ~20 s, to this
file).

The views are built on the JAX side with the keys the trainer's step uses
(``fold_in(fold_in(PRNGKey(seed), step_num), a)``), because ``jax.random``
is not a ``torch.Generator``.  The step is then handed exactly those arrays
(``make_view`` as seen by ``ubpl_tpu.train.mt_ubpl`` returns them): XLA's
warp inside the jitted step differs from the same warp outside it by 1e-5
in the images, which this network amplifies to 2e-3 in the losses, so only
bit-identical views make tolerances of 1e-5 meaningful.

The case is non-trivial: the teachers are perturbed copies of the students
(otherwise MTC is 0), ``cons_weight`` 3.0, ``fdl_weight`` 0.7,
``pseudo_weight`` 0.8, ``ema_alpha`` 0.5, and ``pseudo_score_thr`` 0.02 so
that EPC selects joints (``n_sel > 0`` is asserted).
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
from ubpl_torch.models.layers import BatchNorm
from ubpl_torch.models.weights import branch_state_dicts_from_jax, load_state
from ubpl_torch.train import common as C
from ubpl_torch.train.mean_teacher import (MeanTeacherTrainer,
                                           mean_teacher_step)
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer, mt_ubpl_step

K, R, OUT, BS = 5, 64, 16, 4
KW = dict(model="HG2", synthetic_data=True, synthetic_kps=K, inp_res=R,
          out_res=OUT, train_count=8, valid_count=4, label_ratio=0.5,
          train_bs=BS, train_bs_labeled=2, infer_bs=4,
          compute_dtype="float32", pseudo_score_thr=0.02, seed=3)
SCHED = dict(cons_weight=3.0, fdl_weight=0.7, pseudo_weight=0.8,
             ema_alpha=0.5)
IDXS = np.array([5, 6, 0, 1])       # unlabeled first, then labeled
STEP_NUM = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on one host: torch's intra-op
    threads would oversubscribe the cores, so this module computes
    single-threaded."""
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
    """JAX package: the real MTUBPLTrainer, its views, one train_step in
    float64; everything returned as numpy."""
    import ubpl_tpu.train.base_trainer as JB
    import ubpl_tpu.train.mt_ubpl as JM
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.train.common import ViewBatch, make_view

    real_init = JB.init_model_stacked
    JB.init_model_stacked = _port_init_stacked
    try:
        trainer = JM.MTUBPLTrainer(JConfig(**KW))
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
        state = JM.DualState(params, f64(np_tree(st.batch_stats)),
                             f64(perturbed(st.ema_params)),
                             f64(perturbed(st.ema_batch_stats)),
                             trainer.tx.init(params))
        before = np_tree(state._replace(opt_state=None))
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), STEP_NUM)
        imgs, kps, islabeled = trainer.fetch_batch(trainer.train_data,
                                                   jnp.asarray(IDXS))
        build = jax.jit(lambda k: make_view(
            k, imgs, kps, trainer.means, cfg, augment=True,
            occluder_bank=None))
        views = [build(jax.random.fold_in(key, a))
                 for a in range(trainer.n_views)]
        # the step gets these very arrays (see the module docstring)
        handed = iter(views)
        real_make_view = JM.make_view
        JM.make_view = lambda *a, **k: next(handed)
        try:
            new_state, aux = trainer.train_step(
                state, jnp.asarray(IDXS), STEP_NUM, SCHED["cons_weight"],
                SCHED["fdl_weight"], SCHED["pseudo_weight"],
                SCHED["ema_alpha"])
        finally:
            JM.make_view = real_make_view
        assert next(handed, None) is None       # the step built both views
        assert isinstance(views[0], ViewBatch)
        return {"before": before,
                "after": np_tree(new_state._replace(opt_state=None)),
                "aux": np_tree(aux),
                "views": [np_tree(v._asdict()) for v in views],
                "islabeled": np.array(islabeled)}


def _cfg(**kw):
    cfg = Config(**{**KW, **kw})
    cfg.kps_count = K
    return cfg


def _views(ref):
    """The JAX-built views as the port's ViewBatch: NHWC -> NCHW, images in
    float64 for the float64 networks."""
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


def _step(ref, cfg, views=None, **sched):
    students, teachers, opt = _branches(ref)
    metrics = mt_ubpl_step(students, teachers, opt, views or _views(ref),
                           torch.as_tensor(ref["islabeled"]),
                           cfg=cfg, **{**SCHED, **sched})
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
    """The compared step exercises every term: labeled and unlabeled
    samples, joints gated off by the re-gate, EPC selecting some joints but
    not all, every loss > 0."""
    aux = ref["aux"]
    assert ref["islabeled"].tolist() == [0, 0, 1, 1]
    n_entries = 2 * 2 * BS * 2 * K       # views x branches x B x S x K
    assert 0 < aux["n_sel"] < n_entries
    assert aux["n_pseudo"] == n_entries / 2      # the unlabeled half
    for key in ("pec", "mtc", "epc"):
        assert (aux[key] > 0).all(), key
    assert aux["fdc"] > 0 and aux["fdc_count"] > 0
    gates = np.stack([v["gate"] for v in ref["views"]])
    assert 0 < gates.sum() < gates.size
    assert not np.array_equal(ref["views"][0]["images"],
                              ref["views"][1]["images"])


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


@pytest.mark.parametrize("branch", [0, 1])
def test_step_student_params_match_jax(port, branch):
    """Post-step student parameters: AdamW's first step moves each weight
    by about lr * sign(g), so a gradient near 0 may flip by up to 2 lr: all
    within 3e-4 (about one lr), and >= 99.9% of elements within 1e-6."""
    want = port["want"]["student"][branch]
    n_tot = n_close = 0
    for name, p in port["students"][branch].named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 3e-4, (name, d.max())
        n_tot += d.size
        n_close += int((d <= 1e-6).sum())
    assert n_close / n_tot >= 0.999, n_close / n_tot


@pytest.mark.parametrize("branch", [0, 1])
def test_step_ema_params_match_jax(ref, port, branch):
    """EMA parameters after the step, 0.5 * teacher + 0.5 * NEW student:
    half the students' tolerance (all within 1.5e-4, >= 99.9% within 1e-6);
    they moved away from the pre-step teacher."""
    want = port["want"]["teacher"][branch]
    before = branch_state_dicts_from_jax(
        SimpleNamespace(**ref["before"]._asdict()), 2, n_branch=2)[1][branch]
    n_tot = n_close = 0
    moved = 0.0
    for name, p in port["teachers"][branch].named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 1.5e-4, (name, d.max())
        n_tot += d.size
        n_close += int((d <= 1e-6).sum())
        moved = max(moved, float((p.detach() - before[name]).abs().max()))
    assert n_close / n_tot >= 0.999, n_close / n_tot
    assert moved > 1e-3


@pytest.mark.parametrize("net", ["student", "teacher"])
@pytest.mark.parametrize("branch", [0, 1])
def test_step_bn_stats_match_jax(port, net, branch):
    """BatchNorm running stats of all four networks after two train-mode
    views (the teachers' too: they run in train mode under no_grad, and
    the EMA leaves their stats alone): rtol 1e-6."""
    want = port["want"][net][branch]
    got = port[net + "s"][branch].state_dict()
    keys = [k for k in want if _is_stat(k)]
    assert len(keys) > 100
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-6, err_msg=key)


def test_teacher_bn_stats_move_and_ema_skips_them(ref, port):
    """The teachers' running stats changed in the step (train-mode
    forward), and are not the EMA of anything: they differ from the mean of
    the old teacher's and the new student's stats."""
    before = branch_state_dicts_from_jax(
        SimpleNamespace(**ref["before"]._asdict()), 2, n_branch=2)[1][0]
    teacher = port["teachers"][0].state_dict()
    student = port["students"][0].state_dict()
    key = "pre.0.bn.running_mean"
    assert not torch.allclose(teacher[key].float(), before[key], rtol=1e-3)
    ema_like = 0.5 * before[key] + 0.5 * student[key].float()
    assert not torch.allclose(teacher[key].float(), ema_like, rtol=1e-3)


def test_carrier_slices_branches(ref):
    """branch_state_dicts_from_jax: one state_dict per branch and role,
    branch i taken from index i of the stacked trees, conv kernels OIHW."""
    before = ref["before"]
    students, teachers = branch_state_dicts_from_jax(
        SimpleNamespace(**before._asdict()), 2, n_branch=2)
    assert len(students) == len(teachers) == 2
    kern = before.params["ConvBlock_0"]["Conv_0"]["kernel"]     # [M,H,W,I,O]
    for i in range(2):
        np.testing.assert_array_equal(
            students[i]["pre.0.conv.weight"].numpy(),
            np.transpose(kern[i], (3, 2, 0, 1)).astype(np.float32))
        np.testing.assert_array_equal(
            teachers[i]["pre.0.bn.running_var"].numpy(),
            before.ema_batch_stats["ConvBlock_0"]["BatchNorm_0"]["var"][i]
            .astype(np.float32))
    assert not torch.equal(students[0]["pre.0.conv.weight"],
                           students[1]["pre.0.conv.weight"])
    assert not torch.equal(students[0]["pre.0.conv.weight"],
                           teachers[0]["pre.0.conv.weight"])
    single = SimpleNamespace(**{
        f: jax.tree_util.tree_map(lambda x: x[1], getattr(before, f))
        for f in ("params", "batch_stats", "ema_params", "ema_batch_stats")})
    s1, t1 = branch_state_dicts_from_jax(single, 2)     # an MTState
    assert len(s1) == len(t1) == 1
    assert torch.equal(s1[0]["pre.0.conv.weight"],
                       students[1]["pre.0.conv.weight"])


# ------------------------------------------------------------- port only
def _assert_same_step(a, b, exact=True):
    """Two (students, teachers, metrics) results are the same step.
    exact: everything at rtol 1e-9 (the same float64 operations).  Else the
    two ran the same mathematics through different operations: the metrics
    at rtol 1e-6, the parameters as after AdamW's first step (a gradient
    that is exactly 0, like a conv bias in front of a train-mode BatchNorm,
    is rounding noise that Adam normalises to +-lr): all within 3e-4 and
    >= 99.9% within 1e-7; the BN stats are not compared."""
    for key in a[2]:
        np.testing.assert_allclose(a[2][key].numpy(), b[2][key].numpy(),
                                   rtol=1e-6, atol=1e-12, err_msg=key)
    n_tot = n_close = 0
    for nets_a, nets_b in zip(a[:2], b[:2]):
        for na, nb in zip(nets_a, nets_b):
            sa, sb = na.state_dict(), nb.state_dict()
            for key in sa:
                if exact:
                    np.testing.assert_allclose(
                        sa[key].numpy(), sb[key].numpy(), rtol=1e-9,
                        atol=1e-12, err_msg=key)
                elif not _is_stat(key):
                    d = (sa[key] - sb[key]).abs()
                    assert d.max() <= 3e-4, key
                    n_tot += d.numel()
                    n_close += int((d <= 1e-7).sum())
    assert exact or n_close / n_tot >= 0.999, n_close / n_tot


def test_remat_is_the_same_step(ref, port):
    """cfg.remat=True (torch.utils.checkpoint over each student forward;
    view 0 is recomputed after view 1 ran) gives the same losses, student
    and EMA parameters and BN stats in float64: rtol 1e-9."""
    got = _step(ref, _cfg(remat=True))
    _assert_same_step(got, (port["students"], port["teachers"],
                            port["metrics"]))


def _mt_step(ref, cfg, views=None, **sched):
    """mean_teacher_step on branch 0 alone (half the cost of a full step;
    view handling and the EMA are code shared with MT_UBPL)."""
    (student,), (teacher,), opt = _branches(ref, 1)
    sched = {**SCHED, **sched}
    m = mean_teacher_step(student, teacher, opt, views or _views(ref),
                          torch.as_tensor(ref["islabeled"]),
                          sched["cons_weight"], sched["ema_alpha"], cfg)
    return [student], [teacher], m


def test_fold_views_pools_bn_statistics(ref):
    """cfg.fold_views runs both views as one batch per network.  On two
    copies of one view the pooled batch statistics are those of the view,
    so losses and parameters equal the unfolded step's (float64; see
    _assert_same_step), while the running stats got ONE update, not two."""
    twice = [_views(ref)[0]] * 2
    folded = _mt_step(ref, _cfg(fold_views=True), views=twice)
    plain = _mt_step(ref, _cfg(), views=twice)
    _assert_same_step(folded, plain, exact=False)
    before = _branches(ref, 1)[0][0].state_dict()
    for nets in (0, 1):                 # student, teacher
        key = "pre.0.bn.running_mean"
        old = before[key] if nets == 0 else _branches(ref, 1)[1][0] \
            .state_dict()[key]
        step1 = folded[nets][0].state_dict()[key] - old
        step2 = plain[nets][0].state_dict()[key] - old
        # momentum 0.1 towards the same batch mean: d, then d + 0.9 d
        np.testing.assert_allclose(step2.numpy(), 1.9 * step1.numpy(),
                                   rtol=1e-6)


def test_ema_alpha_zero_copies_the_student(ref):
    """At epoch 0 the EMA weight is 0: after the step the teacher's
    parameters ARE its student's new parameters; its BN stats are not."""
    (s,), (t,), _ = _mt_step(ref, _cfg(), ema_alpha=0.0)
    for (name, ps), pt in zip(s.named_parameters(), t.parameters()):
        assert torch.equal(ps, pt), name
    assert not torch.equal(s.state_dict()["pre.0.bn.running_mean"],
                           t.state_dict()["pre.0.bn.running_mean"])


def test_mean_teacher_step_is_one_independent_branch(ref):
    """The MT step against the MT_UBPL step: with EPC off and the FDC
    weight 0 the two branches do not interact, so branch 0 of that step is
    ``mean_teacher_step`` on branch 0 alone — PEC, MTC, counts, student,
    teacher and BN stats (float64, rtol 1e-9)."""
    cfg = _cfg(use_ensemble_pseudo=False)
    dual = _step(ref, cfg, fdl_weight=0.0)
    (student,), (teacher,), m = _mt_step(ref, cfg)
    assert set(m) == {"pec_loss", "pec_count", "mtc_loss", "mtc_count"}
    for key in ("pec", "mtc"):
        np.testing.assert_allclose(m[key + "_loss"].numpy(),
                                   dual[2][key][0].numpy(), rtol=1e-6)
        assert m[key + "_count"] == dual[2][key + "_count"][0]
    assert float(dual[2]["epc"].abs().sum()) == 0 == float(dual[2]["fdc"])
    _assert_same_step(([student], [teacher], {}),
                      (dual[0][:1], dual[1][:1], {}))


# --------------------------------------------------------------- trainers
def _tiny(**kw):
    """Trainer-level tests: one stack is enough and halves their cost."""
    return Config(**{**KW, "model": "HG1", "train_count": 12,
                     "pseudo_score_thr": 0.0, **kw})


@pytest.mark.parametrize("cls,n_nets", [(MTUBPLTrainer, 2),
                                        (MeanTeacherTrainer, 1)])
def test_branches_start_from_their_seeds(cls, n_nets):
    """Branch i is initialised from cfg.seed + i (so branches differ); each
    teacher starts equal to its student, parameters and BN stats, shares no
    storage with it, and is frozen."""
    tr = cls(_tiny(), device="cpu")
    assert len(tr.students) == len(tr.teachers) == n_nets
    for i, (s, t) in enumerate(zip(tr.students, tr.teachers)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(tr.cfg.seed + i)
            fresh = create_pose_model("HG1", K, "AvgPool").state_dict()
        for (k, a), b in zip(s.state_dict().items(), t.state_dict().values()):
            assert torch.equal(a, b) and torch.equal(a, fresh[k]), k
            assert a.data_ptr() != b.data_ptr()
        assert all(p.requires_grad for p in s.parameters())
        assert not any(p.requires_grad for p in t.parameters())
    if n_nets == 2:
        assert not torch.equal(tr.students[0].pre[0].conv.weight,
                               tr.students[1].pre[0].conv.weight)
    assert len(tr.optimizer.param_groups[0]["params"]) == sum(
        len(list(s.parameters())) for s in tr.students)


@pytest.mark.parametrize("cls", [MTUBPLTrainer, MeanTeacherTrainer])
def test_train_step_builds_two_views(cls, monkeypatch):
    """One step of either regime draws two augmentations and calls the
    heatmap kernel's wrapper exactly twice (one launch per view on the
    card); the views differ; every metric is a finite tensor; validation
    sets the teachers to eval and the next step runs them in train mode
    again."""
    calls = []
    real_synth = C.heatmap_synth.synthesize_heatmaps

    def synth(kps, **kw):
        calls.append(kps.clone())
        return real_synth(kps, **kw)

    monkeypatch.setattr(C.heatmap_synth, "synthesize_heatmaps", synth)
    tr = cls(_tiny(), device="cpu")
    sched = tr.epoch_schedules(1)
    batch = next(iter(tr.make_sampler()))
    tr.validate()
    assert not any(n.training for n in tr.teachers)
    (m,) = tr.run_train_steps([batch], *sched.values())
    assert len(calls) == 2 and not torch.equal(calls[0], calls[1])
    assert all(n.training for n in tr.students + tr.teachers)
    assert all(torch.isfinite(v).all() for v in m.values())
    assert tr._step_num == 1


def test_unlabeled_split_and_sample_weights():
    """The synthetic split: labeled first, the rest unlabeled; pos / nega /
    cons weights as the JAX package's ``sample_weights``."""
    from ubpl_tpu.train.base_trainer import BaseTrainer as JBase
    tr = MeanTeacherTrainer(_tiny(), device="cpu")
    assert tr.labeled_idxs == list(range(6))
    assert tr.unlabeled_idxs == list(range(6, 12))
    isl = np.array([0, 1, 0, 2], np.int32)
    ours = tr.sample_weights(torch.as_tensor(isl), 0.3)
    theirs = JBase.sample_weights(None, jnp.asarray(isl), 0.3)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_batchnorm_updates_stats_under_no_grad():
    """The teachers' train-mode forward runs under no_grad: the port's
    BatchNorm must move its running stats there exactly as with grad."""
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    a, b = BatchNorm(3), BatchNorm(3)
    a(x)
    with torch.no_grad():
        b(x)
    assert not torch.equal(b.running_mean, torch.zeros(3))
    assert torch.equal(a.running_mean, b.running_mean)
    assert torch.equal(a.running_var, b.running_var)
