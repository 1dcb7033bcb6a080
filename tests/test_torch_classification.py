"""The port's classification branch against the JAX package on the same
inputs: the five class losses, the four CIFAR families in every feature
mode, ``make_class_view``, the CIFAR splits and cache, one ``train_step``
of each mode, ``validate()`` and ``python -m ubpl_torch classification``.

All JAX work runs once, in the module-scoped ``ref`` fixture:

  * forwards: random flax weights (shapes from ``jax.eval_shape``, values
    from a numpy seed, no flax init program) carried into the port by
    ``class_state_dict_from_jax``; bs 2 at 32x32, fp32.  One jitted program
    per family runs all four feature modes in eval and train mode: the
    modes share the ConvOne weights (their flax trees are cut from it), so
    XLA compiles the shared backbone once;
  * steps: ``ubpl_tpu``'s real ``ClassificationTrainer`` (VGG11, 4 training
    images, bs 4 = 2 + 2) in float64, started from random weights with
    perturbed EMA teachers, each mode's step handed the view JAX builds
    with the step's own key (bit-identical views, as
    ``test_torch_mt_ubpl.py`` explains); the ``mt_ubpl`` trainer then runs
    the JAX package's ``exec_regime`` for one more epoch, which writes the
    ``classification.json`` the port's CLI is held to.
"""
import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixture_archives import make_cifar
from ubpl_torch import __main__ as CLI
from ubpl_torch.config import Config
from ubpl_torch.data.cifar import CIFAR10Data, CIFAR100Data
from ubpl_torch.models import create_class_model
from ubpl_torch.models.weights import (class_state_dict_from_jax,
                                       flax_entries, flax_to_port)
from ubpl_torch.ops import augment as A
from ubpl_torch.train import classification as PC
from ubpl_torch.train import losses as L
from ubpl_torch.train.common import make_class_view

FAMILIES = ["VGG11", "ResNet18", "ResNet50", "MobileNet"]
FEATURE_MODES = ["default", "MaxPool", "AvgPool", "ConvOne"]
STEP_MODES = ["supervised", "mt", "mt_ubpl"]
N_TRAIN, N_VALID = 16, 8
STEP_KW = dict(model="VGG", data_source="cifar10", train_count=4,
               valid_count=8, label_ratio=0.5, train_bs=4,
               train_bs_labeled=2, infer_bs=8, compute_dtype="float32",
               epochs=1, seed=3)
STEP_NUM = 1
SCHED = dict(cons_weight=3.0, pseudo_weight=0.8, ema_alpha=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _random_tree(shapes, rng):
    """numpy values for a flax (params, batch_stats) shape tree: kernels
    of variance 1 / fan_in (activations stay near 1), BN scales near 1,
    small biases and means, variances in [0.5, 1.5]."""
    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(1.0 / fan_in), s.shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.standard_normal(s.shape)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: fill(p, s).astype(np.float32), shapes)
    return tree["params"], tree["batch_stats"]


_TO_FLAX = {"conv": (2, 3, 1, 0), "deconv": (2, 3, 0, 1), "dense": (1, 0)}


@functools.cache
def _entries(fam, mode, num_classes=10):
    """``flax_entries`` of a port classifier and its tensors' shapes (the
    module built on the meta device: structure only)."""
    with torch.device("meta"):
        net = create_class_model(fam, num_classes, mode)
    return (tuple(flax_entries(net)),
            {k: tuple(v.shape) for k, v in net.state_dict().items()})


def _flax_shapes(fam, mode, num_classes=10):
    """The flax (params, batch_stats) shape tree of a port classifier's
    flax counterpart, from ``flax_entries`` (flax's own apply then checks
    every shape it is handed against its layers)."""
    entries, shapes = _entries(fam, mode, num_classes)
    tree = {}
    for kind, fp, key, layout in entries:
        shape = shapes[key]
        if layout is not None:
            shape = tuple(shape[i] for i in _TO_FLAX[layout])
        _set(tree, ("params" if kind == "p" else "batch_stats",) + fp,
             jax.ShapeDtypeStruct(shape, jnp.float32))
    return tree


def _mode_trees(fam, params, stats):
    """Each feature mode's flax trees, cut from the ConvOne mode's (the
    same arrays: the modes differ only in the tap)."""
    where = {key: fp for _, fp, key, _ in _entries(fam, "ConvOne")[0]}
    out = {}
    for mode in FEATURE_MODES:
        p, s = {}, {}
        for kind, fp, key, _ in _entries(fam, mode)[0]:
            src = params if kind == "p" else stats
            _set(p if kind == "p" else s, fp, _get(src, where[key]))
        out[mode] = (p, s)
    return out


def _nchw(x):
    x = np.asarray(x)
    return np.moveaxis(x, -1, 1) if x.ndim == 4 else x


def _outputs(out, mode):
    """(logits1, logits2, feat or None) of a classifier's output."""
    (l1, l2), feat = out if mode != "default" else (out, None)
    return l1, l2, feat


def _synthetic_ds(cls, cache_dir, seed=7):
    rng = np.random.default_rng(0)
    return cls.from_arrays(
        rng.integers(0, 256, (N_TRAIN, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, (N_TRAIN,)),
        rng.integers(0, 256, (N_VALID, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, (N_VALID,)), cache_dir=str(cache_dir), seed=seed)


def _loss_inputs():
    rng = np.random.default_rng(11)
    B, C = 6, 10
    return dict(
        logits=rng.normal(0, 2, (B, C)).astype(np.float32),
        logits2=rng.normal(0, 2, (B, C)).astype(np.float32),
        teacher=rng.normal(0, 2, (2, B, C)).astype(np.float32),
        labels=np.array([3, -1, 0, 9, -1, 5]),
        sw=np.array([0.0, 0.8, 1.0, 0.0, 0.5, 1.0], np.float32),
        f1=rng.normal(0, 1, (B, 2, 2, 8)).astype(np.float32),
        f2=rng.normal(0, 1, (B, 2, 2, 8)).astype(np.float32))


def _ramp_images(B, R):
    """uint8 images linear in x and y, never clamped by the noise, where
    bilinear and JAX's two-pass linear warp are both exact."""
    yy, xx = np.mgrid[0:R, 0:R]
    img = np.stack([80 + xx + yy, 140 - xx + yy, 100 + xx], -1)
    return np.stack([img + 2 * b for b in range(B)]).astype(np.uint8)


# --------------------------------------------------------------- reference
def _ref_losses():
    import ubpl_tpu.train.losses as JL
    return jax.jit(lambda x: {
        "class_loss": JL.class_loss(x["logits"], x["labels"]),
        "class_loss_weighted": JL.class_loss(x["logits"], x["labels"],
                                             x["sw"], True),
        "class_dist": JL.class_dist(x["logits"], x["logits2"]),
        "class_sym_dist": JL.class_sym_dist(x["logits"], x["logits2"]),
        "class_pseudo": JL.class_pseudo(x["logits"], x["teacher"], x["sw"]),
        "class_feature_dist": JL.class_feature_dist(x["f1"], x["f2"]),
    })(_loss_inputs())


def _ref_forwards():
    """Every family and feature mode on one input, in float64: the eval
    forward (the reference of the port's fp32 one), the train-mode forward
    and its new BatchNorm stats."""
    from ubpl_tpu.models import create_class_model as jcreate
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    f64 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), tree)
    out = {}
    for fam in FAMILIES:
        params, stats = _random_tree(
            _flax_shapes(fam, "ConvOne"), rng)

        def run(params, stats, x, fam=fam):
            res = {}
            for mode, (p, s) in _mode_trees(fam, params, stats).items():
                net, variables = jcreate(fam, 10, mode), {
                    "params": p, "batch_stats": s}
                res[mode] = (net.apply(variables, x, train=False),
                             *net.apply(variables, x, train=True,
                                        mutable=["batch_stats"]))
            return res
        with jax.enable_x64(True):
            got = jax.jit(run)(f64(params), f64(stats), f64(x))
        trees = _mode_trees(fam, params, stats)
        for mode in FEATURE_MODES:
            ev, tr, new_stats = got[mode]
            out[fam, mode] = jax.tree_util.tree_map(np.asarray, {
                "trees": trees[mode], "eval": ev, "train": tr,
                "new_stats": new_stats["batch_stats"]})
    return x, out


def _ref_view():
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.train.common import make_class_view as jview
    cfg = JConfig()
    cfg.inp_res = 32
    imgs = _ramp_images(4, 32)
    key = jax.random.PRNGKey(21)
    means = np.array([0.5, 0.5, 0.5], np.float32)
    view, plain = jax.jit(lambda k, i, m: (
        jview(k, i, m, cfg), jview(None, i, m, cfg, augment=False)))(
            key, jnp.asarray(imgs), jnp.asarray(means))
    return {"key": key, "images": imgs, "means": means,
            "view": np.asarray(view), "plain": np.asarray(plain)}


def _port_init(model, key, sample, train=True):
    """Stand-in for ``ubpl_tpu.models.factory.init_model``: random trees of
    the model's shapes, seeded by the key (no flax init program)."""
    return _random_tree(
        _flax_shapes(getattr(model, "model_type", "MobileNet"), model.mode,
                     model.num_classes),
        np.random.default_rng(int(np.asarray(key).ravel()[-1])))


def _port_init_stacked(model, keys, sample, train=True):
    trees = [_port_init(model, k, sample) for k in keys]
    return jax.tree_util.tree_map(lambda *x: np.stack(x), *trees)


def _ref_steps(tmp):
    """One float64 step of each mode, then (mt_ubpl) one epoch of
    ``exec_regime``."""
    import ubpl_tpu.train.classification as JC
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.data.cifar import CIFAR10Data as JCIFAR
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    rng = np.random.default_rng(5)
    out = {}
    real = (JC.init_model, JC.init_model_stacked, JC.make_class_view)
    JC.init_model, JC.init_model_stacked = _port_init, _port_init_stacked
    build_view = None           # one program: the modes' views agree
    try:
        for mode in STEP_MODES:
            cfg = JConfig(**STEP_KW, cache_dir=str(tmp / f"jcache_{mode}"))
            tr = JC.ClassificationTrainer(
                cfg, mode=mode, datasource=_synthetic_ds(
                    JCIFAR, tmp / f"jcache_{mode}"))
            idxs = np.array(tr.unlabeled_idxs[:2] + tr.labeled_idxs[:2])
            st = np_tree(tr.state)
            perturb = lambda x: jax.tree_util.tree_map(  # noqa: E731
                lambda a: a * (1 + 0.05 * rng.standard_normal(
                    a.shape)).astype(np.float32), x)
            before = JC.ClassState(
                st.params, st.batch_stats, perturb(st.ema_params),
                perturb(st.ema_batch_stats), None)
            with jax.enable_x64(True):
                state = jax.jit(lambda b: b._replace(opt_state=tr.tx.init(
                    b.params)))(jax.tree_util.tree_map(
                        lambda a: np.asarray(a, np.float64), before))
                key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed),
                                         STEP_NUM)
                if build_view is None:
                    build_view = jax.jit(lambda k, x, m, cfg=cfg: real[2](
                        k, x, m, cfg))
                view = build_view(key, tr.train_images[idxs], tr.means)
                JC.make_class_view = lambda *a, **k: view
                new, aux = tr.train_step(state, jnp.asarray(idxs), STEP_NUM,
                                         SCHED["cons_weight"],
                                         SCHED["pseudo_weight"],
                                         SCHED["ema_alpha"])
                JC.make_class_view = real[2]
                out[mode] = {"before": before,
                             "after": np_tree(new._replace(opt_state=None)),
                             "aux": np_tree(aux), "view": np.asarray(view),
                             "labels": np.asarray(tr.train_labels[idxs]),
                             "islabeled": np.asarray(
                                 tr.train_islabeled[idxs])}
                if mode == "mt_ubpl":
                    tr.state = new
                    out["cli"] = _ref_exec_regime(JC, tr, tmp)
                    out["cli"]["final"] = np_tree(tr.state._replace(
                        opt_state=None))
    finally:
        JC.init_model, JC.init_model_stacked, JC.make_class_view = real
    return out


def _ref_exec_regime(JC, trainer, tmp):
    """``ubpl_tpu``'s ``exec_regime`` (mt_ubpl) on the fixture's trainer:
    one epoch, its validation and the classification.json it writes."""
    real = JC.ClassificationTrainer
    JC.ClassificationTrainer = lambda *a, **k: trainer
    try:
        history = JC.exec_regime(params={
            "mode": "mt_ubpl", "experiment_root": str(tmp / "jexp")})
    finally:
        JC.ClassificationTrainer = real
    (run,) = os.listdir(tmp / "jexp")
    with open(tmp / "jexp" / run / "logs" / "classification.json") as f:
        return {"history": history, "json": json.load(f)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    x, fwd = _ref_forwards()
    return {"losses": jax.tree_util.tree_map(np.asarray, _ref_losses()),
            "x": x, "forwards": fwd, "view": _ref_view(),
            "steps": _ref_steps(tmp)}


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("name", ["class_loss", "class_loss_weighted",
                                  "class_dist", "class_sym_dist",
                                  "class_pseudo", "class_feature_dist"])
def test_class_losses_match_jax(ref, name):
    """Each class loss's (sum, count): rtol 1e-6, counts exact."""
    x = _loss_inputs()
    logits, labels = t(x["logits"]), torch.as_tensor(x["labels"])
    got = {
        "class_loss": lambda: L.class_loss(logits, labels),
        "class_loss_weighted": lambda: L.class_loss(logits, labels,
                                                    t(x["sw"]), True),
        "class_dist": lambda: L.class_dist(logits, t(x["logits2"])),
        "class_sym_dist": lambda: L.class_sym_dist(logits, t(x["logits2"])),
        "class_pseudo": lambda: L.class_pseudo(logits, t(x["teacher"]),
                                               t(x["sw"])),
        "class_feature_dist": lambda: L.class_feature_dist(
            t(_nchw(x["f1"])), t(_nchw(x["f2"]))),
    }[name]()
    want = ref["losses"][name]
    np.testing.assert_allclose(np.asarray(got[0]), want[0], rtol=1e-6)
    assert int(got[1]) == int(want[1])


# ---------------------------------------------------------------- forwards
def _port_net(ref, fam, mode):
    r = ref["forwards"][fam, mode]
    with torch.device("meta"):          # weights come from flax
        net = create_class_model(fam, 10, mode)
    net.load_state_dict(class_state_dict_from_jax(*r["trees"], fam, mode),
                        assign=True)
    return net, r


def _check(got, want, mode):
    for g, w in zip(_outputs(got, mode), _outputs(want, mode)):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.detach().numpy(), _nchw(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", FEATURE_MODES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_eval_forward_matches_flax(ref, fam, mode):
    """Eval mode in fp32 (against flax in float64): both heads' logits and
    the feature tap, rtol 1e-4 / atol 1e-5."""
    net, r = _port_net(ref, fam, mode)
    with torch.no_grad():
        got = net.eval()(t(_nchw(ref["x"])))
    _check(got, r["eval"], mode)


@pytest.mark.parametrize("mode", FEATURE_MODES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_train_forward_matches_flax(ref, fam, mode):
    """Train mode: logits, feature tap and the new BatchNorm running stats
    (flax's biased-variance update), rtol 1e-4 / atol 1e-5, in float64 on
    both sides: BatchNorm over 2 x 4 x 4 values per channel makes the
    deep train-mode nets ill-conditioned (ResNet50's fp32 outputs leave
    float64's by up to 5e-4 in either framework; ROADMAP C.3)."""
    net, r = _port_net(ref, fam, mode)
    net.double()
    with torch.no_grad():
        got = net.train()(t(_nchw(ref["x"]), torch.float64))
    _check(got, r["train"], mode)
    want = class_state_dict_from_jax(r["trees"][0], r["new_stats"], fam,
                                     mode)
    n_stats = 0
    for k, v in net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            n_stats += 1
    assert n_stats > 0


def test_feature_taps_differ_by_mode(ref):
    """The case is non-trivial: the modes share weights and logits, their
    taps differ, and ResNet50 runs the Bottleneck path."""
    feats = {m: _outputs(ref["forwards"]["ResNet50", m]["eval"], m)[2]
             for m in FEATURE_MODES}
    assert feats["default"] is None
    assert feats["MaxPool"].shape == feats["AvgPool"].shape == (2, 4, 4, 1024)
    assert feats["ConvOne"].shape == (2, 8, 8, 1024)
    assert not np.allclose(feats["MaxPool"], feats["AvgPool"])
    l1 = [_outputs(ref["forwards"]["ResNet50", m]["eval"], m)[0]
          for m in FEATURE_MODES]
    for other in l1[1:]:
        np.testing.assert_allclose(other, l1[0], rtol=1e-6)
    net = create_class_model("ResNet50", 10, "default")
    assert type(net.stages[0][0]).__name__ == "Bottleneck"


def test_flax_kernel_layouts():
    """flax -> port layouts: conv HWIO -> OIHW, depthwise [3,3,1,C] ->
    [C,1,3,3], dense [in,out] -> [out,in]."""
    w = np.arange(3 * 3 * 2 * 4, dtype=np.float32).reshape(3, 3, 2, 4)
    assert flax_to_port(w, "conv")[1, 0, 2, 1] == w[2, 1, 0, 1]
    dw = np.arange(3 * 3 * 5, dtype=np.float32).reshape(3, 3, 1, 5)
    assert flax_to_port(dw, "conv").shape == (5, 1, 3, 3)
    assert flax_to_port(dw, "conv")[4, 0, 1, 2] == dw[1, 2, 0, 4]
    d = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(flax_to_port(d, "dense"), d.T)


# -------------------------------------------------------------------- view
def test_make_class_view_matches_jax(ref):
    """``make_class_view`` fed JAX's draws (``ubpl_tpu`` augment_batch's key
    split) against JAX's on ramp images: pixels whose source lies inside
    [1, R-2] to 1e-4 (bilinear and JAX's two-pass warp are both exact on
    ramps there, as in test_warp_matches_jax_training_warp); the
    un-augmented view exactly."""
    import ubpl_tpu.ops.transforms as JT
    v = ref["view"]
    B, R = v["images"].shape[:2]
    key = v["key"]
    r_flip, r_noise, r_aff = jax.random.split(key, 3)
    r_apply, r_con, r_bri = jax.random.split(r_noise, 3)
    r_s, r_a = jax.random.split(r_aff)
    draws = A.AugmentDraws(
        flip=torch.as_tensor(np.array(jax.random.uniform(r_flip, (B,))
                                      <= 0.5)),
        noise_apply=torch.as_tensor(np.array(
            jax.random.uniform(r_apply, (B,)) <= 0.5)),
        contrast=t(jax.random.uniform(r_con, (B,), minval=0.8, maxval=1.2)),
        brightness=t(jax.random.uniform(r_bri, (B,), minval=-0.2,
                                        maxval=0.2)),
        scale_normal=t(jax.random.normal(r_s, (B,))),
        angle_normal=t(jax.random.normal(r_a, (B,))))
    cfg = Config()
    cfg.inp_res = R
    u8 = torch.as_tensor(v["images"])
    got = make_class_view(u8, t(v["means"]), cfg, draws).numpy()
    assert got.shape == (B, 3, R, R)
    np.testing.assert_allclose(
        make_class_view(u8, t(v["means"]), cfg).numpy(), _nchw(v["plain"]),
        atol=1e-6)
    aug = A.augment_batch(u8.permute(0, 3, 1, 2).float() / 255,
                          torch.zeros(B, 1, 3), torch.full((B, 2), R // 2.0),
                          torch.full((B,), R / 200.0), draws, inp_res=R)
    mats = np.asarray(JT.affine_warp_matrix(
        jnp.asarray(aug.center.numpy()), jnp.asarray(aug.scale.numpy()),
        jnp.asarray(aug.angle.numpy()), (R, R)), np.float64)
    n_flip = int(draws.flip.sum())
    assert 0 < n_flip < B and 0 < int(draws.noise_apply.sum()) < B
    for b in range(B):
        inv = np.linalg.inv(mats[b])
        ys, xs = np.mgrid[0:R, 0:R] - 1.0
        sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2] + 1
        sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2] + 1
        inside = (sx >= 1) & (sx <= R - 2) & (sy >= 1) & (sy <= R - 2)
        assert inside.sum() > R * R / 4
        np.testing.assert_allclose(np.moveaxis(got[b], 0, -1)[inside],
                                   v["view"][b][inside], atol=1e-4)


# ------------------------------------------------------------------- CIFAR
@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_cifar_splits_and_cache_match_jax(tmp_path, name):
    """From torchvision's pickled batches: records, the semi split, the
    labelled / unlabelled indices and the JSON cache file's bytes equal
    ``ubpl_tpu.data.cifar``'s for the same seed; materialised arrays
    too."""
    from ubpl_tpu.data import cifar as JD
    make_cifar(str(tmp_path / "data"), name, n_train=30, n_test=12)
    cls = {"cifar10": (CIFAR10Data, JD.CIFAR10Data),
           "cifar100": (CIFAR100Data, JD.CIFAR100Data)}[name]
    got, want = [c(data_root=str(tmp_path / "data"),
                   cache_dir=str(tmp_path / side), seed=9)
                 for c, side in zip(cls, ("port", "jax"))]
    np.testing.assert_array_equal(got._train_images, want._train_images)
    np.testing.assert_array_equal(got._valid_targets, want._valid_targets)
    a, b = got.get_semi_data(20, 10, 0.3), want.get_semi_data(20, 10, 0.3)
    assert a == b
    assert a[0][a[5][0]]["label"] == -1 and len(a[4]) == 6
    (fa,), (fb,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert fa == fb == f"{name}_20_10_0.3.json"
    with open(tmp_path / "port" / fa, "rb") as f1, \
            open(tmp_path / "jax" / fb, "rb") as f2:
        assert f1.read() == f2.read()
    for x, y in zip(got.materialize(a[0]), want.materialize(b[0])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert got.get_data(20, 10) == want.get_data(20, 10)


def test_cifar_missing_root_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="cifar-10-batches-py"):
        CIFAR10Data(data_root=str(tmp_path), cache_dir=str(tmp_path))


# ------------------------------------------------------------------- steps
def _port_sd(params, stats):
    """flax trees of the step's VGG11 -> its port state_dict in float64
    (``class_state_dict_from_jax`` gives float32)."""
    sd = {}
    for kind, fp, key, layout in _entries("VGG", "AvgPool")[0]:
        w = _get(params if kind == "p" else stats, fp)
        sd[key] = torch.as_tensor(np.ascontiguousarray(
            flax_to_port(np.asarray(w, np.float64), layout)))
    return sd


def _branch_sds(state, n):
    """(students', teachers') float64 state_dicts of a JAX ClassState
    (numpy; a leading branch axis when n > 1)."""
    def take(tree, i):
        return jax.tree_util.tree_map(lambda a: a[i], tree) if n > 1 else tree
    return ([_port_sd(take(state.params, i), take(state.batch_stats, i))
             for i in range(n)],
            [_port_sd(take(state.ema_params, i),
                      take(state.ema_batch_stats, i)) for i in range(n)])


def _net(sd):
    """A float64 VGG11 holding ``sd`` (built on the meta device: no
    initialisation to throw away)."""
    with torch.device("meta"):
        net = create_class_model("VGG", 10, "AvgPool")
    net.load_state_dict(sd, assign=True)
    return net


@pytest.fixture(scope="module")
def port_steps(ref):
    out = {}
    for mode in STEP_MODES:
        r = ref["steps"][mode]
        n = 2 if mode == "mt_ubpl" else 1
        s_sd, t_sd = _branch_sds(r["before"], n)
        students = [_net(sd) for sd in s_sd]
        teachers = [_net(sd).requires_grad_(False) for sd in t_sd]
        opt = torch.optim.AdamW(
            [p for s in students for p in s.parameters()],
            lr=Config().lr, weight_decay=Config().wd)
        view = torch.as_tensor(_nchw(r["view"])).double()
        metrics = PC.class_step(
            students, teachers, opt, view, torch.as_tensor(r["labels"]),
            torch.as_tensor(r["islabeled"]), mode, **SCHED)
        want_s, want_t = _branch_sds(r["after"], n)
        out[mode] = SimpleNamespace(students=students, teachers=teachers,
                                    metrics=metrics, want_s=want_s,
                                    want_t=want_t)
    return out


def test_step_case_is_nontrivial(ref):
    """Labelled and unlabelled samples, teachers apart from students, every
    loss of mt_ubpl above 0."""
    r = ref["steps"]["mt_ubpl"]
    assert r["islabeled"].tolist() == [0, 0, 1, 1]      # the step's batch
    assert (r["labels"][:2] == -1).all() and (r["labels"][2:] >= 0).all()
    for key in ("ce", "cons", "pseudo", "fdl"):
        assert r["aux"][key] > 0, key


@pytest.mark.parametrize("mode", STEP_MODES)
def test_step_losses_match_jax(ref, port_steps, mode):
    """The step's metrics (ce, cons, pseudo, fdl as the mode has them):
    same keys, rtol 1e-5."""
    got, want = port_steps[mode].metrics, ref["steps"][mode]["aux"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   err_msg=k)


def _close_params(nets, wants):
    """AdamW's first step moves each weight by about lr * sign(g): all
    within 3e-4 (about one lr), and >= 99.9% of elements within 1e-6 (the
    criterion of test_torch_mt_ubpl.py)."""
    n_tot = n_close = 0
    for net, want in zip(nets, wants):
        for name, p in net.named_parameters():
            d = np.abs(p.detach().numpy() - want[name].numpy())
            assert d.max() <= 3e-4, (name, d.max())
            n_tot += d.size
            n_close += int((d <= 1e-6).sum())
    assert n_close / n_tot >= 0.999, n_close / n_tot


@pytest.mark.parametrize("mode", STEP_MODES)
def test_step_student_params_match_jax(port_steps, mode):
    s = port_steps[mode]
    _close_params(s.students, s.want_s)


@pytest.mark.parametrize("mode", STEP_MODES)
def test_step_ema_params_match_jax(port_steps, mode):
    """The EMA teachers after the step (ema_alpha 0.5 of the new students)
    under the same criterion."""
    s = port_steps[mode]
    _close_params(s.teachers, s.want_t)


@pytest.mark.parametrize("mode", STEP_MODES)
def test_step_bn_stats_match_jax(port_steps, mode):
    """Students' and teachers' BatchNorm running stats after the step (the
    teachers' from their own train-mode forward, not from the EMA): rtol
    1e-6."""
    s = port_steps[mode]
    for nets, wants in ((s.students, s.want_s), (s.teachers, s.want_t)):
        for net, w in zip(nets, wants):
            for k, v in net.state_dict().items():
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(v.numpy(), w[k].numpy(),
                                               rtol=1e-6, atol=1e-12,
                                               err_msg=k)


# ---------------------------------------------------------------- trainer
def _trainer(tmp_path, mode="mt_ubpl", **kw):
    cfg = Config(**{**STEP_KW, "cache_dir": str(tmp_path / "pcache"), **kw})
    return PC.ClassificationTrainer(
        cfg, mode, datasource=_synthetic_ds(CIFAR10Data, tmp_path / "pcache"),
        device="cpu")


def test_validate_matches_jax(ref, tmp_path, monkeypatch):
    """``validate()`` with the JAX run's final EMA teachers (float64):
    the accuracy JAX's validation gave, on the same split."""
    tr = _trainer(tmp_path)
    tr.teachers = [_net(sd) for sd in
                   _branch_sds(ref["steps"]["cli"]["final"], 2)[1]]
    real = PC.make_class_view
    monkeypatch.setattr(PC, "make_class_view",
                        lambda *a, **k: real(*a, **k).double())
    acc = tr.validate()
    assert acc == ref["steps"]["cli"]["history"][-1]["acc"]


@pytest.mark.parametrize("mode", STEP_MODES)
def test_trainer_epoch_each_mode(tmp_path, mode):
    """One epoch of each mode on the CPU (MobileNet, epoch-1 schedules:
    EMA weight 0.5): the JAX step's metric keys, finite losses, the EMA
    teachers moved away from their students, then a validation in
    [0, 1]."""
    tr = _trainer(tmp_path, mode, model="MobileNet", train_count=8)
    losses = tr.train_epoch(1)
    keys = {"supervised": {"ce"}, "mt": {"ce", "cons"},
            "mt_ubpl": {"ce", "cons", "pseudo", "fdl"}}[mode]
    assert set(losses) == keys and np.isfinite(list(losses.values())).all()
    assert tr._step_num == (1 if mode == "supervised" else 2)
    for s, te in zip(tr.students, tr.teachers):
        assert not all(torch.equal(a, b) for a, b in
                       zip(s.parameters(), te.parameters()))
    assert 0 <= tr.validate() <= 1


def test_trainer_refuses_cpu_by_default(tmp_path, monkeypatch):
    """device=None means CUDA and raises without it; an unknown mode
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**STEP_KW)
    ds = _synthetic_ds(CIFAR10Data, tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PC.ClassificationTrainer(cfg, "mt", datasource=ds)
    with pytest.raises(ValueError, match="mt_ubpl"):
        PC.ClassificationTrainer(cfg, "ubpl", datasource=ds, device="cpu")


# --------------------------------------------------------------------- CLI
def test_cli_classification_writes_what_jax_writes(ref, tmp_path):
    """``python -m ubpl_torch classification --mode=mt_ubpl --device=cpu``
    on a CIFAR-10 tree in torchvision's layout: exit 0 and
    logs/classification.json with the keys of the JAX package's (its
    history entries too), the pose model defaulting to VGG and the
    split cache written."""
    make_cifar(str(tmp_path / "data"), "cifar10", n_train=20, n_test=8)
    rc = CLI.main(["classification", "--mode=mt_ubpl", "--device=cpu",
                   f"--data_root={tmp_path / 'data'}", "--train_count=8",
                   "--valid_count=8", "--label_ratio=0.5", "--train_bs=4",
                   "--train_bs_labeled=2", "--infer_bs=8", "--epochs=2",
                   "--compute_dtype=float32",
                   f"--experiment_root={tmp_path / 'exp'}",
                   f"--cache_dir={tmp_path / 'cache'}"])
    assert rc == 0
    (run,) = os.listdir(tmp_path / "exp")
    assert run.startswith("cifar10(8_0.5)_Classification_mt_ubpl_")
    with open(tmp_path / "exp" / run / "logs" / "classification.json") as f:
        got = json.load(f)
    want = ref["steps"]["cli"]["json"]
    assert set(got) == set(want) == {"history", "best_acc", "best_epoch"}
    assert len(got["history"]) == 2
    for h in got["history"]:
        assert set(h) == set(want["history"][0])
        assert np.isfinite(list(h.values())).all()
    assert os.listdir(tmp_path / "cache") == ["cifar10_8_8_0.5.json"]
