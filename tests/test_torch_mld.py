"""The MLD gradient surgery of the port (``optimizer="mld"``) against the JAX
package's ``mld_combine`` and the reference golden, and the MLD training
step against the AdamW step.

The JAX MLD step is not compiled here: at ``mld_alpha=0`` the surgery is
the identity on the summed gradient, so the port's MLD step is held to the
port's AdamW step (itself held to the JAX step in test_torch_mt_ubpl.py),
and the port's own (g_pri, g_sec) of one step go through both
``mld_combine``s.  Sizes: HG1, K=5, 64 -> 16, bs 2 (1 unlabeled + 1
labeled), float32, torch single-threaded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubpl_torch.config import Config
from ubpl_torch.train import mt_ubpl as M
from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
from ubpl_torch.train.mean_teacher import MeanTeacherTrainer
from ubpl_torch.train.mld_optim import mld_combine, mld_gradients
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer
from ubpl_torch.train.supervised import SupervisedTrainer

K = 5
KW = dict(model="HG1", synthetic_data=True, synthetic_kps=K, inp_res=64,
          out_res=16, train_count=8, valid_count=4, label_ratio=0.5,
          train_bs=2, train_bs_labeled=1, infer_bs=4,
          compute_dtype="float32", pseudo_score_thr=0.02, seed=3)
SCHED = (3.0, 0.7, 0.8, 0.5)    # cons, fdl, pseudo weight, ema alpha


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_combine(pri, sec, alpha):
    """ubpl_tpu's mld_combine on numpy gradient lists."""
    from ubpl_tpu.train.mld_optim import mld_combine as jax_mld_combine
    out = jax_mld_combine({str(i): jnp.asarray(np.asarray(g))
                           for i, g in enumerate(pri)},
                          {str(i): jnp.asarray(np.asarray(g))
                           for i, g in enumerate(sec)}, alpha)
    return [np.asarray(out[str(i)]) for i in range(len(pri))]


# ----------------------------------------------------------------- combine
@pytest.mark.parametrize("case", ["aligned", "opposed", "alpha1"])
def test_mld_combine_matches_jax(case):
    """Seeded gradient lists of several shapes: rtol 1e-6 against JAX's
    mld_combine; 'opposed' closes the ip > 0 gate (plain sum)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    pri = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    sec = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    alpha = 1.0 if case == "alpha1" else 0.5
    if case == "opposed":
        pri = [-3.0 * s for s in sec]
    got = mld_combine([torch.as_tensor(g) for g in pri],
                      [torch.as_tensor(g) for g in sec], alpha)
    want = _jax_combine(pri, sec, alpha)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    if case == "opposed":
        for g, p, s in zip(got, pri, sec):
            np.testing.assert_allclose(g.numpy(), p + s, rtol=1e-6)


def test_mld_combine_worked_example():
    """The executed semantics by hand: gp=[1,0], gs=[1,1], alpha=1 ->
    g_tot=[2,1], ip=3, vertical=[-0.2,0.4], final=[2.2,0.6]."""
    (out,) = mld_combine([torch.tensor([1.0, 0.0])],
                         [torch.tensor([1.0, 1.0])], 1.0)
    np.testing.assert_allclose(out.numpy(), [2.2, 0.6], atol=1e-6)


def test_mld_combine_matches_golden(goldens):
    """The reference MLDOptim executed under torch (``mld.npz``): rtol
    1e-5, atol 1e-6, every case and parameter."""
    z = goldens("mld")
    n = int(z["n_params"])
    for i in range(int(z["n_cases"])):
        out = mld_combine(
            [torch.as_tensor(z[f"case{i}_pri_{j}"]) for j in range(n)],
            [torch.as_tensor(z[f"case{i}_sec_{j}"]) for j in range(n)],
            float(z[f"alpha_{i}"]))
        for j in range(n):
            np.testing.assert_allclose(out[j].numpy(), z[f"case{i}_final_{j}"],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"case{i} param{j}")


def test_mld_gradients_zero_for_unreached_parameters():
    """A parameter one loss does not reach gets a zero gradient from it."""
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    b = torch.tensor([3.0], requires_grad=True)
    x = (a * a).sum()
    g_pri, g_sec = mld_gradients(x, x + b.sum(), [a, b])
    assert torch.equal(g_pri[1], torch.zeros(1))
    assert torch.equal(g_sec[1], torch.ones(1))
    assert torch.equal(g_pri[0], g_sec[0])


# -------------------------------------------------------------------- step
def _trainer(cls=MTUBPLTrainer, **kw):
    return cls(Config(**{**KW, **kw}), device="cpu")


@pytest.fixture(scope="module")
def steps():
    """One step of the AdamW trainer, of the MLD trainer at alpha 0 and at
    alpha 0.5 (its gradient pair captured), on the same weights, batch and
    draws."""
    out = {}
    seen = []
    real = M.mld_combine

    def spy(pri, sec, alpha):
        seen.append(([p.clone() for p in pri], [s.clone() for s in sec], alpha))
        return real(pri, sec, alpha)

    M.mld_combine = spy
    try:
        for name, kw in (("adamw", {}),
                         ("mld0", dict(optimizer="mld", mld_alpha=0.0)),
                         ("mld5", dict(optimizer="mld", mld_alpha=0.5))):
            tr = _trainer(**kw)
            batch = next(iter(tr.make_sampler()))    # the same for all three
            before = [p.detach().clone() for p in tr.optimizer.param_groups[0]
                      ["params"]]
            (m,) = tr.run_train_steps([batch], *SCHED)
            out[name] = {"trainer": tr, "metrics": m, "before": before,
                         "batch": list(batch)}
    finally:
        M.mld_combine = real
    out["pairs"] = seen
    return out


def _params(tr):
    return [p.detach() for p in tr.optimizer.param_groups[0]["params"]]


@pytest.mark.parametrize("key", ["pec", "mtc", "epc", "fdc", "pec_count",
                                 "n_sel"])
def test_mld_alpha0_losses_equal_adamw(steps, key):
    """At mld_alpha 0 the step's losses and counts are the AdamW step's
    (rtol 1e-5): the same forward on the same views."""
    np.testing.assert_allclose(steps["mld0"]["metrics"][key].numpy(),
                               steps["adamw"]["metrics"][key].numpy(),
                               rtol=1e-5)


def test_mld_alpha0_params_equal_adamw(steps):
    """At mld_alpha 0 the surgery is the identity on g_pri + g_sec, so the
    students after the step are the AdamW step's within 2.1 lr (AdamW's
    first step moves a weight by about lr * sign(g); a gradient that is
    rounding noise may flip), and the EMA teachers follow."""
    lr = steps["adamw"]["trainer"].cfg.lr
    n_tot = n_close = 0
    for a, b in zip(_params(steps["mld0"]["trainer"]),
                    _params(steps["adamw"]["trainer"])):
        d = (a - b).abs()
        assert float(d.max()) <= 2.1 * lr
        n_tot += d.numel()
        n_close += int((d <= 1e-6).sum())
    assert n_close / n_tot >= 0.99, n_close / n_tot
    for ta, tb in zip(steps["mld0"]["trainer"].teachers,
                      steps["adamw"]["trainer"].teachers):
        for a, b in zip(ta.parameters(), tb.parameters()):
            assert float((a - b).abs().max()) <= 2.1 * lr


def test_mld_step_moved_the_students(steps):
    """Every step moved the students away from their initial weights."""
    for name in ("adamw", "mld0", "mld5"):
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(_params(steps[name]["trainer"]),
                        steps[name]["before"]))
        assert moved > 0.5 * steps[name]["trainer"].cfg.lr, name


def test_mld_alpha_half_is_finite_and_differs(steps):
    """At mld_alpha 0.5 the step is finite and lands elsewhere than the
    AdamW step."""
    tr = steps["mld5"]["trainer"]
    assert all(torch.isfinite(v).all() for v in steps["mld5"]["metrics"]
               .values())
    assert all(torch.isfinite(p).all() for p in _params(tr))
    diff = max(float((a - b).abs().max()) for a, b in
               zip(_params(tr), _params(steps["adamw"]["trainer"])))
    assert diff > 0.1 * tr.cfg.lr


def test_mld_gradient_pair_covers_both_students(steps):
    """The surgery gets one gradient per parameter of BOTH students (its
    norms and inner product are global over the two, as the JAX package's
    stacked branch axis), and both groups are non-zero."""
    assert steps["mld5"]["batch"] == steps["adamw"]["batch"]
    pri, sec, alpha = steps["pairs"][1]
    tr = steps["mld5"]["trainer"]
    assert alpha == 0.5
    assert len(pri) == len(sec) == sum(len(list(s.parameters()))
                                       for s in tr.students)
    assert float(sum(g.abs().sum() for g in pri)) > 0
    assert float(sum(g.abs().sum() for g in sec)) > 0


@pytest.mark.parametrize("which", [0, 1], ids=["alpha0", "alpha0.5"])
def test_step_gradient_pair_through_both_combines(steps, which):
    """The port's own (g_pri, g_sec) of a training step through the port's
    and JAX's mld_combine: rtol 1e-6, and an absolute slack of 1e-6 times
    the parameter's largest summed gradient for entries where
    g_tot - alpha * vertical cancels (float32 rounding of the operands)."""
    pri, sec, alpha = steps["pairs"][which]
    got = mld_combine(pri, sec, alpha)
    # JAX gets the gradients as one flat leaf: its norms and inner product
    # are global over the leaves, so the result is the same function, and
    # one leaf spares hundreds of op-by-op dispatches
    flat = _jax_combine([torch.cat([g.flatten() for g in pri])],
                        [torch.cat([g.flatten() for g in sec])], alpha)[0]
    want = np.split(flat, np.cumsum([g.numel() for g in pri])[:-1])
    for g, w, p, s in zip(got, want, pri, sec):
        w = w.reshape(g.shape)
        scale = float((p + s).abs().max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * scale + 1e-12)


def test_dualpose_mld_step_runs():
    """DualPose_UBPL with optimizer='mld': one finite step."""
    tr = _trainer(DualPoseUBPLTrainer, optimizer="mld", mld_alpha=0.5)
    (m,) = tr.run_train_steps([next(iter(tr.make_sampler()))], *SCHED)
    assert all(torch.isfinite(v).all() for v in m.values())


@pytest.mark.parametrize("cls", [SupervisedTrainer, MeanTeacherTrainer])
def test_mld_needs_a_loss_split(cls):
    """Regimes with one loss group refuse optimizer='mld', as the JAX
    package does (the same message)."""
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.train import mean_teacher as JMT
    from ubpl_tpu.train import supervised as JS
    jcls = {SupervisedTrainer: JS.SupervisedTrainer,
            MeanTeacherTrainer: JMT.MeanTeacherTrainer}[cls]
    with pytest.raises(ValueError, match="mld") as ours:
        cls(Config(**{**KW, "optimizer": "mld"}), device="cpu")
    with pytest.raises(ValueError, match="mld") as theirs:
        jcls(JConfig(**{**KW, "optimizer": "mld"}))
    assert str(ours.value) == str(theirs.value)
