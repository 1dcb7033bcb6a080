"""The port's UBPL pseudo-label machinery against the JAX package: the own
copy of ``train/pseudo.py`` (exact), the dormant utilities
(``ops/features.py``, ``ops/uncertainty.py``, ``train/feature_pool.py``),
``affine_back`` and ``acc_pck_pseudo``, one ``PseudoLabelingLoop`` round
stage by stage against JAX's, and the rounds inside ``run()`` with their
checkpointed state.

Sizes: HG1, K=5, 64 -> 16, 4 unlabeled samples in 2 batches of
``infer_bs`` 2 (one batch shape: one compile per view kind on the JAX
side), float32, torch single-threaded.
The round's JAX side runs in the module fixture ``jax_round``: a real
``ubpl_tpu`` ``MTUBPLTrainer`` started from the port's initial weights
through ``import_hourglass`` (no flax init, no train-step compile; only the
loop's own inference program is compiled) and its ``_predict_all``.  What
JAX computes inside that program — the views' images and the back-warped
heatmaps — is read out with ``jax.debug.callback``.  The port's loop gets
JAX's augmentation draws, and its teachers run on JAX's view images, so
every stage is compared on identical inputs: XLA's training warp and the
port's differ by float rounding, which the network would carry into the
heatmaps.
"""
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubpl_torch.config import Config
from ubpl_torch.models import create_pose_model
from ubpl_torch.ops import augment as A
from ubpl_torch.ops import features as F
from ubpl_torch.ops import pck as PCK
from ubpl_torch.ops import transforms as T
from ubpl_torch.ops import uncertainty as U
from ubpl_torch.train import pseudo as P
from ubpl_torch.train import pseudo_loop as PL
from ubpl_torch.train.checkpointing import checkpoint_paths
from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
from ubpl_torch.train.feature_pool import FeaturePool, get_feature_pools
from ubpl_torch.train.mean_teacher import MeanTeacherTrainer
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer

K, R, OUT = 5, 64, 16
KW = dict(model="HG1", synthetic_data=True, synthetic_kps=K, inp_res=R,
          out_res=OUT, train_count=8, valid_count=4, label_ratio=0.5,
          train_bs=4, train_bs_labeled=2, infer_bs=2,
          compute_dtype="float32", seed=3)
AUG_VIEWS = 2
RNG = jax.random.PRNGKey(21)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t32(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


# ------------------------------------------------------- train/pseudo.py
def _bank(seed=0, n=12):
    """Seeded per-keypoint inputs: truth, two teachers' predictions on the
    original view and on 3 augmented views, some illegal (negative)
    points, and one sample whose teachers agree exactly across views (the
    0/0 weighting fallback)."""
    rng = np.random.default_rng(seed)
    gts = rng.uniform(5, 60, (n, K, 3))
    gts[..., 2] = 1
    p1, p2 = (gts[..., :2] + rng.normal(0, 3, (n, K, 2)) for _ in range(2))
    a1, a2 = (gts[None, ..., :2] + rng.normal(0, 4, (3, n, K, 2))
              for _ in range(2))
    p1[0, 1, 0] = -2.0
    a2[1, 2, 3, 1] = -1.0
    a1[:, 4] = p1[4]
    a2[:, 4] = p2[4]
    return gts, p1, p2, a1, a2


def _same(a, b):
    """Exact equality of two results: arrays (NaN == NaN), floats, tuples."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _pseudo_cases():
    gts, p1, p2, a1, a2 = _bank()
    rng = np.random.default_rng(1)
    rel = rng.uniform(0, 1, (12, K))
    err = rng.uniform(0, 9, (12, K))
    acc = (rng.uniform(0, 1, (12, K)) > 0.5).astype(np.int32)
    dists = rng.uniform(0, 30, (12, K))
    legal = (rng.uniform(0, 1, (12, K)) > 0.2).astype(np.float64)
    return {
        "pck_norms": (gts, (1, 2)),
        "assess_pseudo": (p1, gts, (1, 2), 0.2),
        "reliability_from_dist": (dists, legal, 1.0),
        "reliability_threshold": (rel, 0.5, 0.2),
        "select_pseudo": (rel, err, acc, 0.3, 0.2),
        "pairwise_avg_distance": (a1,),
        "assess_ensemble": (p1, p2, a1, a2, gts, (1, 2), 0.2),
        "mixed_uncertainty": (dists, np.where(legal > 0, dists / 2, -1.0),
                              dists / 3, 20.0),
    }


@pytest.mark.parametrize("name", sorted(_pseudo_cases()))
def test_pseudo_function_matches_jax_package(name):
    """Each scoring/selection function of the port's copy gives exactly the
    ubpl_tpu function's result on the same float64 inputs."""
    import ubpl_tpu.train.pseudo as JP
    args = _pseudo_cases()[name]
    _same(getattr(P, name)(*args), getattr(JP, name)(*args))


def test_assess_ensemble_weights_and_fallback():
    """The larger-spread teacher gets the larger weight (the reference's
    convention), a sample whose teachers do not move across views falls
    back to an even split, and illegal points are flagged 999."""
    gts, p1, p2, a1, a2 = _bank()
    ens = P.assess_ensemble(p1, p2, a1, a2, gts, (1, 2), 0.2)
    np.testing.assert_array_equal(ens.w1[4], 0.5)
    big = ens.int_dist1 > ens.int_dist2
    assert ((ens.w1 > 0.5) == big)[ens.legal > 0].all()
    assert ens.legal[0, 1] == 0 and ens.ext_dist[0, 1] == P.ILLEGAL
    assert ens.legal[2, 3] == 0


def test_lma_cache_matches_jax_package():
    """LMA histories and smoothed values after 1, 2, 3 and 4 pushes."""
    import ubpl_tpu.train.pseudo as JP
    rng = np.random.default_rng(2)
    ours, theirs = P.LMACache((4, K)), JP.LMACache((4, K))
    for _ in range(4):
        v = rng.uniform(0, 9, (4, K))
        _same(ours.update(v), theirs.update(v))
        _same(ours.history, theirs.history)


def test_apply_pseudo_labels_matches_jax_package():
    """In-place injection into PoseArrays: the same kps as the JAX copy."""
    import ubpl_tpu.train.pseudo as JP
    from ubpl_torch.data.arrays import PoseArrays
    out = []
    for mod in (P, JP):
        arrays = PoseArrays(np.zeros((6, 4, 4, 3), np.uint8),
                            np.zeros((6, K, 3), np.float32),
                            np.zeros((6, K, 3), np.float32),
                            np.zeros((6,), np.int32), list("abcdef"))
        rng = np.random.default_rng(3)
        mod.apply_pseudo_labels(arrays, [1, 4, 5], rng.uniform(0, 60, (3, K, 2)),
                                rng.uniform(0, 1, (3, K)) > 0.5)
        out.append(arrays.kps)
    _same(out[0], out[1])
    assert 0 < (out[0][..., 2] == 1).sum() < 3 * K


# ------------------------------------------------- ops and dormant utilities
def _warps(n, seed=4):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-30, 30, n)
    scales = rng.uniform(0.75, 1.25, n)
    return (T.affine_warpmat(t32(angles), t32(scales)),
            torch.as_tensor(rng.uniform(0, 1, n) > 0.5))


def test_affine_back_matches_jax():
    """Random heatmaps, rotated and scaled warps, flips: atol 1e-5 against
    ubpl_tpu's affine_back."""
    from ubpl_tpu.ops import transforms as JT
    hm = np.random.default_rng(5).uniform(0, 1, (6, K, 16, 16))
    wm, flip = _warps(6)
    got = T.affine_back(t32(hm), wm, flip)
    want = jax.jit(JT.affine_back)(jnp.asarray(np.transpose(hm, (0, 2, 3, 1)),
                                      jnp.float32),
                          jnp.asarray(wm.numpy()), jnp.asarray(flip.numpy()))
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=1e-5)
    assert not np.allclose(got.numpy(), hm, atol=1e-2)


def test_affine_back_matches_golden(goldens):
    """The reference's affine_back2 golden (``warpmat.npz``): atol 2e-5, as
    the JAX package's test."""
    g = goldens("warpmat")
    back = T.affine_back(t32(g["hm"]), t32(g["warpmats"]),
                         torch.as_tensor(g["isflip"]))
    np.testing.assert_allclose(back.numpy(), g["back"], atol=2e-5)


def test_acc_pck_pseudo_exact():
    """1 where error / norm < thr, int32, exactly as the JAX package."""
    from ubpl_tpu.ops import pck as JPCK
    rng = np.random.default_rng(6)
    err = rng.uniform(0, 20, (8, K)).astype(np.float32)
    norm = rng.uniform(5, 50, (8, 1)).astype(np.float32)
    err[0, 0] = 0.2 * norm[0, 0]                # exactly at the threshold
    got = PCK.acc_pck_pseudo(torch.as_tensor(err), torch.as_tensor(norm), 0.2)
    want = JPCK.acc_pck_pseudo(jnp.asarray(err), jnp.asarray(norm), 0.2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0] == 0 and 0 < int(got.sum()) < got.numel()


def test_features_cov_matches_jax():
    """features_cov on [B, N, C, H, W] against the JAX package's NCHW form:
    rtol 1e-6, the same count."""
    from ubpl_tpu.ops import features as JF
    rng = np.random.default_rng(7)
    f1, f2 = rng.normal(0, 1, (2, 3, 2, 4, 8, 8)).astype(np.float32)
    c, n = F.features_cov(torch.as_tensor(f1), torch.as_tensor(f2))
    jc, jn = JF.features_cov_nchw(jnp.asarray(f1), jnp.asarray(f2))
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-6)
    assert n == jn == 3 * 2 * 4


def test_feature_mixture_matches_jax():
    """The recency weight over epochs around its knee and the mixture of
    up to max_count snapshots: rtol 1e-6."""
    from ubpl_tpu.ops import features as JF
    epochs = np.arange(0, 25, dtype=np.float32)
    np.testing.assert_allclose(
        F.feature_mixture_weight(torch.as_tensor(epochs)).numpy(),
        np.asarray(jax.jit(JF.feature_mixture_weight)(jnp.asarray(epochs))),
        rtol=1e-6)
    snaps = np.random.default_rng(8).uniform(0, 1, (5, 3, 4)).astype(np.float32)
    for max_count in (3, 9):
        np.testing.assert_allclose(
            F.feature_mixture_across_epochs(torch.as_tensor(snaps),
                                            max_count).numpy(),
            np.asarray(jax.jit(JF.feature_mixture_across_epochs,
                               static_argnums=1)(jnp.asarray(snaps),
                                                 max_count)),
            rtol=1e-6)


def test_uncertainty_matches_jax():
    """Parameter similarity (the corrected cosine, not the reference's
    bug), parameter distance, prediction distance and spread uncertainty:
    rtol 1e-6 against ubpl_tpu.ops.uncertainty."""
    from ubpl_tpu.ops import uncertainty as JU
    rng = np.random.default_rng(9)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    a = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    b = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    ta, tb = ([torch.as_tensor(x) for x in v] for v in (a, b))
    ja, jb = ({str(i): jnp.asarray(x) for i, x in enumerate(v)}
              for v in (a, b))
    for ours, theirs in ((U.model_similarity_cosine,
                          JU.model_similarity_cosine),
                         (U.model_similarity_distance,
                          JU.model_similarity_distance)):
        np.testing.assert_allclose(float(ours(ta, tb)), float(theirs(ja, jb)),
                                   rtol=1e-6)
    # the reference's bug would give 2.0 for any pair whose first layers
    # match; the corrected quantity does not
    assert abs(float(U.model_similarity_cosine(ta, ta)) - 2.0) < 1e-6
    assert abs(float(U.model_similarity_cosine(ta, tb)) - 2.0) > 1e-3
    mul = rng.uniform(0, 60, (4, 3, K, 2)).astype(np.float32)
    gts = rng.uniform(0, 60, (3, K, 2)).astype(np.float32)
    mean = mul.mean(0)
    pairs = [(U.preds_similarity_distance(t32(mul[0]), t32(mul[1])),
              JU.preds_similarity_distance(mul[0], mul[1])),
             (U.err_kps(t32(mul[0]), t32(gts)), JU.err_kps(mul[0], gts)),
             (U.err_kps_mul(t32(mul), t32(gts)),
              JU.err_kps_mul(jnp.asarray(mul), jnp.asarray(gts)))]
    unc, w = U.uncertainty_from_distance(t32(mul), t32(mean))
    junc, jw = JU.uncertainty_from_distance(jnp.asarray(mul),
                                            jnp.asarray(mean))
    pairs += [(unc, junc), (w, jw)]
    for ours, theirs in pairs:
        np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                                   rtol=1e-6)


def test_feature_pool_matches_jax(monkeypatch):
    """Two snapshots pushed through identity warps (one sample flipped) and
    their recency-weighted mixture, against ubpl_tpu's FeaturePool on the
    same features in its channel-last layout: rtol 1e-6."""
    from ubpl_tpu.ops import transforms as JT
    from ubpl_tpu.train import feature_pool as JFP
    # the same function, compiled once instead of dispatched op by op
    monkeypatch.setattr(JFP, "affine_back", jax.jit(JT.affine_back))
    rng = np.random.default_rng(10)
    feats = [rng.uniform(1, 2, (2, 3, 4, 4)).astype(np.float32)
             for _ in range(2)]
    wm = np.tile(np.eye(2, 3, dtype=np.float32), (2, 1, 1))
    flip = np.array([False, True])
    ours = FeaturePool(3, (3, 4, 4), 3)
    theirs = JFP.FeaturePool(3, (4, 4, 3), 3)
    for f in feats:
        ours.save_features([0, 2], torch.as_tensor(f), torch.as_tensor(wm),
                           torch.as_tensor(flip))
        theirs.save_features([0, 2], jnp.asarray(np.transpose(f, (0, 2, 3, 1))),
                             jnp.asarray(wm), jnp.asarray(flip))
    np.testing.assert_array_equal(ours.count, theirs.count)
    for epo in (1, 12):
        np.testing.assert_allclose(
            ours.get_features_mixture([0, 2], epo),
            nchw(theirs.get_features_mixture([0, 2], epo)), rtol=1e-6)
    grid = get_feature_pools(3, (3, 4, 4), 3, model_num=2, aug_num=2,
                             n_stack=3)
    assert len(grid) == 2 and len(grid[0]) == 2 and len(grid[0][0]) == 3


# ------------------------------------------------------ one round vs JAX
def _port_init_stacked(model, rngs, sample_input, train=True):
    """Stand-in for ``ubpl_tpu.models.factory.init_model_stacked``: the
    port's branch i (``torch.manual_seed(seed + i)``) as flax trees with a
    leading branch axis (tests/test_torch_mt_ubpl.py does the same)."""
    from ubpl_tpu.models.torch_import import import_hourglass
    trees = []
    for i in range(len(rngs)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(KW["seed"] + i)
            net = create_pose_model(KW["model"], K)
        sd = {k: v.numpy() for k, v in net.state_dict().items()}
        trees.append(import_hourglass(sd, 1))
    return jax.tree_util.tree_map(lambda *x: np.stack(x), *trees)


def _jax_draws(key, B, flip_prob=0.5, noise_prob=0.5):
    """The draws ubpl_tpu's make_view(key, augment=True) consumes: its
    augment_batch key is the first half of split(key), then that
    function's key-split order (ubpl_tpu/ops/augment.py:101, 52-55,
    68-71)."""
    rng = jax.random.split(key)[0]
    r_flip, r_noise, r_aff = jax.random.split(rng, 3)
    r_apply, r_con, r_bri = jax.random.split(r_noise, 3)
    r_s, r_a = jax.random.split(r_aff)
    return A.AugmentDraws(
        flip=torch.as_tensor(np.array(
            jax.random.uniform(r_flip, (B,)) <= flip_prob)),
        noise_apply=torch.as_tensor(np.array(
            jax.random.uniform(r_apply, (B,)) <= noise_prob)),
        contrast=t32(jax.random.uniform(r_con, (B,), minval=0.8, maxval=1.2)),
        brightness=t32(jax.random.uniform(r_bri, (B,), minval=-0.2,
                                          maxval=0.2)),
        scale_normal=t32(jax.random.normal(r_s, (B,))),
        angle_normal=t32(jax.random.normal(r_a, (B,))))


def _near_truth(trainer_gts, idxs, seed):
    """Legal teacher predictions a few pixels from the retained truth:
    (ori [2, N, K, 2], augs [A, 2, N, K, 2]) float64."""
    rng = np.random.default_rng(seed)
    gts = np.asarray(trainer_gts, np.float64)[np.asarray(idxs), :, :2]
    ori = gts[None] + rng.normal(0, 1.5, (2,) + gts.shape)
    augs = gts[None, None] + rng.normal(0, 2.0, (AUG_VIEWS, 2) + gts.shape)
    return np.abs(ori), np.abs(augs)


@pytest.fixture(scope="module")
def jax_round():
    """ubpl_tpu: the trainer from the port's weights, its loop's
    predictions over the 4 unlabeled samples with the views' images and
    the back-warped heatmaps read
    out of the compiled program, then two selection rounds on given
    predictions."""
    import ubpl_tpu.train.base_trainer as JB
    import ubpl_tpu.train.mt_ubpl as JM
    import ubpl_tpu.train.pseudo_loop as JPL
    from ubpl_tpu.config import Config as JConfig

    real_init = JB.init_model_stacked
    JB.init_model_stacked = _port_init_stacked
    try:
        trainer = JM.MTUBPLTrainer(JConfig(**KW))
    finally:
        JB.init_model_stacked = real_init
    loop = JPL.PseudoLabelingLoop(trainer, aug_views=AUG_VIEWS, batch_size=2)
    seen = {"views": [], "back": []}

    def make_view(*args, **kw):
        v = real_make_view(*args, **kw)
        jax.debug.callback(lambda *a: seen["views"].append(
            tuple(np.array(x) for x in a)), v.images, v.warpmat, v.isflip)
        return v

    def decode_heatmaps_mul(back, *args, **kw):
        jax.debug.callback(lambda b: seen["back"].append(np.array(b)), back)
        return real_hm.decode_heatmaps_mul(back, *args, **kw)

    real_make_view, real_hm = JPL.make_view, JPL.HM
    JPL.make_view = make_view
    JPL.HM = SimpleNamespace(decode_heatmaps_mul=decode_heatmaps_mul)
    try:
        ori, augs = loop._predict_all(RNG)
        jax.effects_barrier()
    finally:
        JPL.make_view, JPL.HM = real_make_view, real_hm

    unl = trainer.unlabeled_idxs
    gts = np.asarray(trainer.train_data.kps_test)
    rounds = []
    for seed in (0, 1):
        given = _near_truth(gts, unl, seed)
        loop._predict_all = lambda rng, given=given: given
        sel, _ = loop.round(RNG, apply=True)
        rounds.append({
            "given": given, "enable": sel.enable,
            "sel_counts": sel.sel_counts, "threshold": sel.threshold,
            "lma": [loop.lma_int[0].history.copy(),
                    loop.lma_int[1].history.copy(),
                    loop.lma_ext.history.copy()],
            "kps": np.array(trainer.train_data.kps),
            "islabeled": np.array(trainer.train_data.islabeled)})
    return {"ori": ori, "augs": augs, "views": seen["views"],
            "back": seen["back"], "rounds": rounds}


@pytest.fixture(scope="module")
def port_round(jax_round):
    """The port's loop on the same weights and data with JAX's draws; its
    teachers see JAX's view images.  Records the port-built views and the
    back-warped heatmaps, then runs the same two selection rounds."""
    tr = MTUBPLTrainer(Config(**KW), device="cpu")
    loop = PL.PseudoLabelingLoop(tr, aug_views=AUG_VIEWS, batch_size=2)
    jax_views = iter(jax_round["views"])
    built, backs = [], []
    real_view, real_back = loop.inference_view, loop.back_warped

    def inference_view(imgs, kps, draws):
        v = real_view(imgs, kps, draws)
        built.append(v)
        return v._replace(images=torch.as_tensor(nchw(next(jax_views)[0])))

    def back_warped(view):
        backs.append(real_back(view))
        return backs[-1]

    loop.inference_view, loop.back_warped = inference_view, back_warped

    def draws(lo, a, batch):
        return _jax_draws(jax.random.fold_in(RNG, lo * 131 + a + 1), batch)

    for t in tr.teachers:
        t.eval()
    ori, augs = loop.predict_all(draws)
    rounds = []
    for r in jax_round["rounds"]:
        loop.predict_all = lambda draws, given=r["given"]: given
        sel, _ = loop.round(None)
        rounds.append({
            "enable": sel.enable, "sel_counts": sel.sel_counts,
            "threshold": sel.threshold,
            "lma": [loop.lma_int[0].history, loop.lma_int[1].history,
                    loop.lma_ext.history],
            "kps": tr.train_data.kps.numpy().copy(),
            "islabeled": tr.train_data.islabeled.numpy().copy()})
    return {"trainer": tr, "ori": ori, "augs": augs, "built": built,
            "backs": backs, "rounds": rounds}


def test_round_views_match_jax(jax_round, port_round):
    """Per batch: the view without augmentation equals JAX's to float32
    rounding (XLA divides by 255 as a multiplication: 1 ulp); the augmented
    views, built from JAX's draws, have JAX's flips exactly and its warp
    matrices at float32 rounding (rtol 1e-6).  Their images are not
    compared here: JAX's training warp is a two-pass (Catmull-Smith)
    resample that differs from the port's exact bilinear sampling on
    high-frequency images; test_torch_ops holds the port's augmentation to
    JAX's exact gather sampler at the same source positions."""
    built, want = port_round["built"], jax_round["views"]
    assert len(built) == len(want) == 2 * (1 + AUG_VIEWS)     # 2 batches
    for i, (v, (img, wm, flip)) in enumerate(zip(built, want)):
        if i % (1 + AUG_VIEWS) == 0:
            np.testing.assert_allclose(v.images.numpy(), nchw(img), rtol=0,
                                       atol=6e-8)
        np.testing.assert_array_equal(v.isflip.numpy(), flip)
        np.testing.assert_allclose(v.warpmat.numpy(), wm, rtol=1e-6,
                                   atol=1e-7)
        assert v.heatmaps is None                # no targets are built
    flips = np.concatenate([f for _, _, f in want])
    assert flips.any() and not flips.all()


def test_round_back_warped_heatmaps_match_jax(jax_round, port_round):
    """Both teachers' last stacks, eval-mode BN, warped back: to 1e-5."""
    backs, want = port_round["backs"], jax_round["back"]
    assert len(backs) == len(want)
    for b, w in zip(backs, want):
        assert b.shape == (2, b.shape[1], K, OUT, OUT)
        np.testing.assert_allclose(b.numpy(), np.transpose(w, (0, 1, 4, 2, 3)),
                                   atol=1e-5)


def test_round_coords_match_jax(jax_round, port_round):
    """Decoded original-frame coordinates equal JAX's exactly wherever the
    decode is unambiguous: the map's top two values differ by more than
    1e-6 (random-init maps are nearly flat, so near-ties are real), or the
    map has no positive value and none within 1e-6 below 0 (the decode
    masks it on both sides; warped-back maps are 0 outside the view).  At
    least 90% of the entries are compared."""
    n_views = 1 + AUG_VIEWS
    got = np.concatenate([port_round["ori"][None], port_round["augs"]])
    want = np.concatenate([jax_round["ori"][None], jax_round["augs"]])
    sure = np.zeros(got.shape[:-1], bool)              # [V, M, N, K]
    lo = 0
    for i, back in enumerate(port_round["backs"]):     # batch-major order
        v, n = i % n_views, back.shape[1]
        flat = back.flatten(-2)
        top2 = flat.topk(2, dim=-1).values
        masked = (top2[..., 0] <= 0) & ~((flat > -1e-6) & (flat < 0)).any(-1)
        sure[v, :, lo:lo + n] = ((top2[..., 0] - top2[..., 1] > 1e-6)
                                 | masked).numpy()
        lo += n if v == n_views - 1 else 0
    assert sure.mean() >= 0.9, sure.mean()
    np.testing.assert_array_equal(got[sure], want[sure])


def test_round_selection_matches_jax(jax_round, port_round):
    """Given identical predictions, two rounds select the same joints at the
    same threshold, leave the same LMA histories, and leave the trainer
    with the same kps and islabeled, exactly.  The rounds select some
    joints but not all."""
    for ours, theirs in zip(port_round["rounds"], jax_round["rounds"]):
        for key in ("enable", "sel_counts", "kps", "islabeled"):
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
        assert ours["threshold"] == theirs["threshold"]
        for a, b in zip(ours["lma"], theirs["lma"]):
            np.testing.assert_array_equal(a, b)
        assert 0 < ours["sel_counts"][-1] < ours["enable"].size
    first, second = port_round["rounds"]
    assert np.isnan(first["lma"][2][..., :2]).all()
    assert not np.isnan(second["lma"][2][..., 1:]).any()


def test_round_resets_before_injecting(port_round):
    """The second round starts again from the pristine arrays: a joint it
    does not select is back to its pristine value, labeled rows are never
    touched, and the teachers are in train mode after predicting."""
    tr = port_round["trainer"]
    first, second = port_round["rounds"]
    unl = np.asarray(tr.unlabeled_idxs)
    lab = np.asarray(tr.labeled_idxs)
    dropped = (first["enable"] > 0) & (second["enable"] == 0)
    assert dropped.any()
    assert (second["kps"][unl][dropped] == 0).all()
    np.testing.assert_array_equal(second["kps"][lab], first["kps"][lab])
    flipped = (second["enable"] > 0).any(axis=1)
    np.testing.assert_array_equal(second["islabeled"][unl], flipped)
    assert all(t.training for t in tr.teachers)


def test_round_draws_are_seeded_per_epoch():
    """The trainer's default draws: reproducible for (seed, epoch) and
    different for another epoch."""
    def flips(seed, epoch):
        d = PL.round_draws(seed, epoch, "cpu")
        return torch.stack([d(0, a, 64).contrast for a in range(2)])
    assert torch.equal(flips(3, 1), flips(3, 1))
    assert not torch.equal(flips(3, 1), flips(3, 2))
    assert not torch.equal(flips(3, 1), flips(4, 1))


# -------------------------------------------------------- rounds in run()
RUN_KW = dict(KW, train_count=4, epochs=1, pseudo_rounds=1, pseudo_interval=1)


def _stub_predictions(monkeypatch):
    """Teacher predictions a few pixels from the truth (random-init
    teachers at 64 px predict outside the 200-px decode box's legal range,
    so nothing would be selected); the round's own inference is compared
    with JAX above."""
    def predict_all(self, draws):
        tr = self.trainer
        return _near_truth(tr.train_data.kps_test.numpy(), tr.unlabeled_idxs,
                           0)
    monkeypatch.setattr(PL.PseudoLabelingLoop, "predict_all", predict_all)


@pytest.fixture(scope="module", params=[MTUBPLTrainer, DualPoseUBPLTrainer],
                ids=["MT_UBPL", "DualPose_UBPL"])
def pseudo_run(request, tmp_path_factory):
    """One epoch with a pseudo round, then a second trainer resumed from its
    checkpoint."""
    mp = pytest.MonkeyPatch()
    _stub_predictions(mp)
    try:
        cls = request.param
        base = str(tmp_path_factory.mktemp("pseudo") / "exp")
        tr = cls(Config(**RUN_KW), device="cpu")
        pristine = (tr.train_data.kps.clone(), tr.train_data.islabeled.clone())
        idx_lists = (list(tr.labeled_idxs), list(tr.unlabeled_idxs))
        tr.run(base)
        resumed = cls(Config(**RUN_KW), device="cpu")
        history = resumed.run(base, resume=True)
    finally:
        mp.undo()
    return {"trainer": tr, "base": base, "pristine": pristine,
            "idx_lists": idx_lists, "resumed": resumed, "history": history}


def test_run_writes_round_json(pseudo_run):
    """The round after epoch 1 is logged as round_1.json with its
    selection count."""
    path = os.path.join(pseudo_run["base"], "logs", "pseudoRounds",
                        "round_1.json")
    with open(path) as f:
        log = json.load(f)
    assert log["epoch"] == 1 and log["selected"] > 0
    assert log["selected"] == log["sel_counts"][-1]
    assert pseudo_run["trainer"]._pseudo_rounds_done == 1


def test_run_flips_islabeled(pseudo_run):
    """Selected joints are injected with vis 1, their samples flip into
    the labeled pool; the sampler's index lists stay as they were."""
    tr = pseudo_run["trainer"]
    kps0, isl0 = pseudo_run["pristine"]
    unl = tr.unlabeled_idxs
    injected = tr.train_data.kps[unl, :, 2] > 0
    assert injected.any() and (kps0[unl, :, 2] == 0).all()
    assert torch.equal(tr.train_data.islabeled[unl],
                       injected.any(dim=1).to(torch.int32))
    assert (isl0[unl] == 0).all()
    assert (tr.labeled_idxs, tr.unlabeled_idxs) == pseudo_run["idx_lists"]


def test_run_checkpoints_pseudo_state(pseudo_run):
    """The checkpoint holds the rounds spent, the injected arrays and the
    LMA histories [3, N, K, 3] with NaN where empty."""
    ckpt = torch.load(checkpoint_paths(pseudo_run["base"])[0],
                      weights_only=True)
    tr = pseudo_run["trainer"]
    assert ckpt["pseudo_rounds_done"] == 1
    assert torch.equal(ckpt["pseudo_kps"], tr.train_data.kps)
    assert torch.equal(ckpt["pseudo_islabeled"], tr.train_data.islabeled)
    n_unl = len(tr.unlabeled_idxs)
    assert ckpt["pseudo_lma"].shape == (3, n_unl, K, 3)
    assert torch.isnan(ckpt["pseudo_lma"][..., :2]).all()


def test_resume_restores_pseudo_state(pseudo_run):
    """run(resume=True) from that checkpoint restores the rounds spent, kps,
    islabeled and the LMA histories exactly, with the pristine arrays as
    the loop's reset baseline; the spent budget runs no further epoch."""
    tr, back = pseudo_run["trainer"], pseudo_run["resumed"]
    assert pseudo_run["history"] == []
    assert back._pseudo_rounds_done == 1
    assert torch.equal(back.train_data.kps, tr.train_data.kps)
    assert torch.equal(back.train_data.islabeled, tr.train_data.islabeled)
    a, b = back._pseudo_loop, tr._pseudo_loop
    for x, y in zip(a.lma_int + [a.lma_ext], b.lma_int + [b.lma_ext]):
        np.testing.assert_array_equal(x.history, y.history)
    kps0, isl0 = pseudo_run["pristine"]
    assert torch.equal(a._kps0, kps0) and torch.equal(a._islabeled0, isl0)


def test_resume_rejects_another_dataset(pseudo_run):
    """A checkpointed pseudo state of another training-set size raises."""
    cls = type(pseudo_run["trainer"])
    other = cls(Config(**dict(RUN_KW, train_count=6)), device="cpu")
    with pytest.raises(ValueError, match="pseudo-state resume"):
        other.resume(pseudo_run["base"])


@pytest.mark.parametrize("case", ["interval", "budget", "regime"])
def test_pseudo_round_schedule(case, monkeypatch):
    """A round runs only every pseudo_interval epochs, until pseudo_rounds
    are spent, and only in the dual-teacher regimes (MT ignores the
    setting, as the JAX package does)."""
    _stub_predictions(monkeypatch)
    kw = dict(RUN_KW, pseudo_rounds=1, pseudo_interval=2)
    cls = MeanTeacherTrainer if case == "regime" else MTUBPLTrainer
    tr = cls(Config(**kw), device="cpu")
    if case == "interval":
        assert tr.maybe_pseudo_round(0) is None
        assert tr.maybe_pseudo_round(1) is not None
        assert tr._pseudo_rounds_done == 1
    elif case == "budget":
        tr._pseudo_rounds_done = 1
        assert tr.maybe_pseudo_round(1) is None
    else:
        assert tr.maybe_pseudo_round(1) is None and tr._pseudo_loop is None
