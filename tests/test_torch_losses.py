"""The port's SSL losses (``ubpl_torch/train/losses.py``, NCHW) against the
reference goldens (``tests/goldens/losses.npz``, NCHW as the reference wrote
them) and against the JAX package's functions (NHWC: the test moves the
channel axis) on inputs made from a numpy seed.

Tolerances: sums rtol 1e-5 against JAX (float32 reductions in a different
order) and the goldens' own rtol (1e-5 / 1e-4, as ``test_losses_parity.py``
holds the JAX package to); every count exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubpl_torch.train import losses as L
from ubpl_tpu.train import losses as JL

T = torch.as_tensor


def _hwk(x):
    """[..., C, H, W] -> [..., H, W, C] for the JAX package."""
    return jnp.asarray(np.moveaxis(np.asarray(x), -3, -1))


def _flat(out):
    """A loss's outputs (nested tuples, 0-dim tensors, python ints) as a
    flat list of float64 arrays."""
    if isinstance(out, tuple):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out, np.float64)]


# --------------------------------------------------------------- goldens
def _golden_cases(g):
    sw17 = T(np.array([1., 1., 7., 7.], np.float32))
    preds, preds2, teachers = T(g["preds"]), T(g["preds2"]), T(g["teachers"])
    f1, f2 = T(g["feat1"]), T(g["feat2"])
    ones = torch.ones(4)
    return {
        "mse": (lambda: L.joint_mse(preds, T(g["gts"]), T(g["gate"]),
                                    T(g["sw_pos"]), use_gate=True,
                                    use_sample_weight=True),
                ["mse_sum", "mse_n"], 1e-5),
        "mse_plain": (lambda: L.joint_mse(preds, T(g["gts"])),
                      ["mse_plain_sum", "mse_plain_n"], 1e-5),
        "dist": (lambda: L.joint_dist(preds[:, -1], preds2[:, -1]),
                 ["dist_sum", "dist_n"], 1e-5),
        "pseudo3": (lambda: L.joint_pseudo3(preds, teachers, T(g["sw_nega"]),
                                            0.95),
                    ["p3_sum", "p3_n", "p3_nsel", "p3_jsm"], 1e-4),
        "pseudo1": (lambda: L.joint_pseudo(preds, teachers, T(g["sw_nega"]),
                                           0.0008),
                    ["p1_sum", "p1_n", "p1_nsel", "p1_jsm"], 1e-4),
        "pseudo2": (lambda: L.joint_pseudo2(preds, teachers, T(g["sw_nega"]),
                                            0.4),
                    ["p2_sum", "p2_n", "p2_nsel", "p2_jsm", "p2_thr1",
                     "p2_thr2"], 1e-4),
        "dist_mt1": (lambda: L.joint_dist_mt(
            preds[:, -1], preds2[:, -1], sample_weight=sw17,
            use_sample_weight=True, sel_rate=0.4), ["mt1_sum", "mt1_n"],
            1e-4),
        "dist_mt2": (lambda: L.joint_dist_mt2(
            preds[:, -1], preds2[:, -1], sample_weight=sw17,
            use_sample_weight=True, score_thr=0.95),
            ["mt2_sum", "mt2_n", "mt2_np", "mt2_nsel", "mt2_jsm"], 1e-4),
        "feature_dist": (lambda: L.joint_feature_dist(f1, f2),
                         ["fdist_sum", "fdist_n"], 1e-4),
        "feature_dist_all": (lambda: L.joint_feature_dist_masked(f1, f2,
                                                                  ones),
                             ["fdist_sum", "fdist_n"], 1e-4),
        "features_cov": (lambda: L.features_cov_masked(f1, f2, ones),
                         ["cov", "cov_n"], 1e-4),
    }


GOLDEN_NAMES = ["mse", "mse_plain", "dist", "pseudo3", "pseudo1", "pseudo2",
                "dist_mt1", "dist_mt2", "feature_dist", "feature_dist_all",
                "features_cov"]


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_loss_matches_golden(goldens, name):
    """Each loss on the reference's inputs gives the reference's outputs:
    sums, thresholds and score means at the golden's rtol, counts exact."""
    g = goldens("losses")
    fn, keys, rtol = _golden_cases(g)[name]
    got = _flat(fn())
    assert len(got) == len(keys)
    for val, key in zip(got, keys):
        if key.endswith(("_n", "_np", "_nsel")):
            assert int(val) == int(g[key]), key
        else:
            np.testing.assert_allclose(val, g[key], rtol=rtol, err_msg=key)


# -------------------------------------------------------- against ubpl_tpu
B, S, K, H, M, N, C, HF = 4, 2, 5, 16, 2, 2, 8, 8

CASES = {
    # islabeled pattern, confidence threshold
    "mixed": ([0, 0, 1, 1], 0.5),
    "all_unlabeled": ([0, 0, 0, 0], 0.5),
    "all_labeled": ([1, 1, 1, 1], 0.5),
    "nothing_above_threshold": ([0, 1, 0, 1], 2.0),
}


def _inputs(case):
    """Heatmap stacks whose per-map maxima spread over 0.3 .. 1.1, so a
    threshold of 0.5 selects some joints and not others."""
    islabeled, thr = CASES[case]
    rng = np.random.default_rng(11)

    def maps(*lead):
        amp = rng.uniform(0.3, 1.1, lead + (K, 1, 1))
        return (rng.uniform(0, 1, lead + (K, H, H)) * amp).astype(np.float32)

    lab = np.asarray(islabeled, np.float32)
    gate = (rng.uniform(0, 1, (B, K)) > 0.3).astype(np.float32)
    return dict(
        preds=maps(B, S), preds2=maps(B, S), teachers=maps(M, B, S),
        gts=maps(B), gate=gate, sw_pos=lab, sw_nega=(1 - lab) * 0.8,
        f1=rng.standard_normal((B, N, C, HF, HF)).astype(np.float32),
        f2=rng.standard_normal((B, N, C, HF, HF)).astype(np.float32),
        thr=thr)


def _feat(x):
    return jnp.asarray(np.moveaxis(x, 2, -1))


LOSSES = {
    "joint_mse": lambda m, d, p, f: m.joint_mse(
        p(d["preds"]), p(d["gts"]), f(d["gate"]), f(d["sw_pos"]),
        use_gate=True, use_sample_weight=True),
    "joint_dist": lambda m, d, p, f: m.joint_dist(
        p(d["preds"][:, -1]), p(d["preds2"][:, -1])),
    "joint_dist_gated": lambda m, d, p, f: m.joint_dist(
        p(d["preds"]), p(d["preds2"]), f(d["gate"]), f(d["sw_nega"]),
        use_gate=True, use_sample_weight=True),
    "joint_pseudo3": lambda m, d, p, f: m.joint_pseudo3(
        p(d["preds"]), p(d["teachers"]), f(d["sw_nega"]), d["thr"]),
    "joint_pseudo": lambda m, d, p, f: m.joint_pseudo(
        p(d["preds"]), p(d["teachers"]), f(d["sw_nega"]), d["thr"] * 0.3),
    "joint_pseudo2": lambda m, d, p, f: m.joint_pseudo2(
        p(d["preds"]), p(d["teachers"]), f(d["sw_nega"]), 0.4),
    "joint_dist_mt": lambda m, d, p, f: m.joint_dist_mt(
        p(d["preds"]), p(d["preds2"]), f(d["gate"]), f(d["sw_nega"]),
        use_gate=True, use_sample_weight=True, sel_rate=0.4),
    "joint_dist_mt2": lambda m, d, p, f: m.joint_dist_mt2(
        p(d["preds"]), p(d["preds2"]), f(d["gate"]), f(d["sw_nega"]),
        use_gate=True, use_sample_weight=True, score_thr=d["thr"]),
}
FEATURE_LOSSES = {
    "joint_feature_dist": lambda m, d, f1, f2, f: m.joint_feature_dist(
        f1, f2),
    "joint_feature_dist_masked": lambda m, d, f1, f2, f:
        m.joint_feature_dist_masked(f1, f2, f(d["sw_pos"])),
    "features_cov_masked": lambda m, d, f1, f2, f: m.features_cov_masked(
        f1, f2, f(d["sw_pos"])),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(LOSSES) + list(FEATURE_LOSSES))
def test_loss_matches_jax(name, case):
    """Port (NCHW) == JAX package (NHWC) on the same numbers: every output
    (sum, count, PseudoStats fields, thresholds) at rtol 1e-5, atol 1e-7;
    counts come out exactly equal."""
    d = _inputs(case)
    if name in LOSSES:
        ours = LOSSES[name](L, d, T, T)
        theirs = LOSSES[name](JL, d, _hwk, jnp.asarray)
    else:
        ours = FEATURE_LOSSES[name](L, d, T(d["f1"]), T(d["f2"]), T)
        theirs = FEATURE_LOSSES[name](JL, d, _feat(d["f1"]), _feat(d["f2"]),
                                      jnp.asarray)
    ours, theirs = _flat(tuple(ours)), _flat(tuple(theirs))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_pseudo3_cases_are_what_they_say():
    """The cases exercise the masks: 'mixed' selects some but not all
    joints and counts only unlabeled samples; 'all_labeled' has no pseudo
    loss; 'nothing_above_threshold' selects nothing but still counts."""
    out = {}
    for case in CASES:
        d = _inputs(case)
        s, st = L.joint_pseudo3(T(d["preds"]), T(d["teachers"]),
                                T(d["sw_nega"]), d["thr"])
        out[case] = (float(s), int(st.num_pseudo), int(st.num_selected))
    assert 0 < out["mixed"][2] < B * S * K
    assert out["mixed"][1] == 2 * S * K and out["mixed"][0] > 0
    assert out["all_unlabeled"][1] == B * S * K
    assert out["all_labeled"][:2] == (0.0, 0)
    assert out["nothing_above_threshold"] == (0.0, 2 * S * K, 0)


def test_losses_return_device_scalars():
    """(sum, count) come back as 0-dim tensors (no host sync in a loss),
    and the sum carries the gradient."""
    d = _inputs("mixed")
    preds = T(d["preds"]).requires_grad_()
    s, n = L.joint_dist(preds, T(d["preds2"]))
    assert s.dim() == 0 and n.dim() == 0 and s.requires_grad
    s, st = L.joint_pseudo3(preds, T(d["teachers"]), T(d["sw_nega"]), 0.5)
    assert s.dim() == 0 and st.num_pseudo.dim() == 0
    c, n = L.features_cov_masked(T(d["f1"]), T(d["f2"]), T(d["sw_pos"]))
    assert c.dim() == 0 and n.dim() == 0
