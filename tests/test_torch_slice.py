"""The port's slice end to end against the JAX package on one init:
serving (``PoseEstimator``) and one supervised training step.

All JAX model work (flax init, the jitted train step, the JAX
``PoseEstimator``) runs once in the module-scoped ``ref`` fixture: on a CPU
host an HG2 flax init alone takes ~16 s.  The port side runs once in
``port``.  Tiny sizes: HG2, K=5, 64 -> 16, bs 4, device="cpu".

Serving compares in float32.  The training comparisons run the network in
float64 on both sides (the JAX side under ``jax.enable_x64``; both cast the
heatmaps to float32 for the loss, as ``forward_heatmaps`` does): at this
size the train-mode network is ill-conditioned — its deepest hourglass
level is 1x1, so BatchNorm normalises n = 4 values per channel — and
float32 rounding alone moves the stem's gradient by ~60% (relative norm)
in either framework, measured against float64.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ubpl_torch.config import Config
from ubpl_torch.infer import PoseEstimator
from ubpl_torch.models import create_pose_model
from ubpl_torch.models.weights import load_state, state_dict_from_jax
from ubpl_torch.train import common as C
from ubpl_torch.train.base_trainer import synthetic_arrays
from ubpl_torch.train.supervised import SupervisedTrainer, supervised_step

K, R, OUT, BS, N_SERVE = 5, 64, 16, 4, 6
MEANS = np.array([0.45, 0.5, 0.55], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on one host: torch's intra-op
    threads would oversubscribe the cores (measured 2 s -> 57 s for one
    step under six workers), so this module computes single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (BS, R, R, 3), dtype=np.uint8)
    # some joints leave the frame, so the visibility re-gate matters
    kps = np.concatenate([rng.uniform(-3, R + 3, (BS, K, 2)),
                          np.ones((BS, K, 1))], -1).astype(np.float32)
    serve = rng.integers(0, 256, (N_SERVE, R, R, 3), dtype=np.uint8)
    return imgs, kps, serve


@pytest.fixture(scope="module")
def ref():
    """JAX package: init, one supervised step on the un-augmented view
    (forward_heatmaps + joint_mse + optax.adamw), and serving."""
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.infer import PoseEstimator as JPoseEstimator
    from ubpl_tpu.models import create_pose_model as jcreate, init_model
    from ubpl_tpu.train import losses as JL
    from ubpl_tpu.train.common import forward_heatmaps, make_view

    cfg = JConfig(model="HG2", inp_res=R, out_res=OUT, kps_count=K,
                  compute_dtype="float32")
    model = jcreate("HG2", K, "AvgPool", dtype=None)
    params, stats = init_model(model, jax.random.PRNGKey(0),
                               jnp.zeros((1, R, R, 3), jnp.float32))
    imgs, kps, serve = _inputs()
    view = make_view(jax.random.PRNGKey(0), jnp.asarray(imgs),
                     jnp.asarray(kps), jnp.asarray(MEANS), cfg, augment=False)

    est = JPoseEstimator(model, params, stats, MEANS, cfg, batch_size=BS)
    serve_kps, serve_scores = est.predict(serve)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out = {"params": np_tree(params), "stats": np_tree(stats),
           "view": jax.tree_util.tree_map(np.asarray, view._asdict()),
           "serve_kps": np.asarray(serve_kps),
           "serve_scores": np.asarray(serve_scores)}

    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jnp.asarray(x, jnp.float64), t)
        params64, stats64 = f64(out["params"]), f64(out["stats"])
        images64 = jnp.asarray(out["view"]["images"], jnp.float64)

        def loss_fn(p):
            (preds, _), new_bs = forward_heatmaps(model, p, stats64,
                                                  images64, True, None)
            s, n = JL.joint_mse(preds, view.heatmaps)
            loss = cfg.pose_weight * jnp.where(n > 0, s / jnp.maximum(n, 1),
                                               s)
            return loss, (new_bs, preds)

        (loss, (new_bs, preds)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params64)
        tx = optax.adamw(cfg.lr, weight_decay=cfg.wd)
        updates, _ = tx.update(grads, tx.init(params64), params64)
        new_params = optax.apply_updates(params64, updates)
        out.update({"loss": float(loss), "preds": np.asarray(preds),
                    "new_stats": np_tree(new_bs), "grads": np_tree(grads),
                    "new_params": np_tree(new_params)})
    return out


@pytest.fixture(scope="module")
def port(ref):
    """The port on the same init (carried across by state_dict_from_jax),
    the same inputs, device="cpu"."""
    cfg = Config(model="HG2", inp_res=R, out_res=OUT, kps_count=K,
                 compute_dtype="float32")
    sd = state_dict_from_jax(ref["params"], ref["stats"], 2)
    model = load_state(create_pose_model("HG2", K), sd)
    imgs, kps, serve = _inputs()
    means = torch.as_tensor(MEANS)
    view = C.make_view(torch.as_tensor(imgs), torch.as_tensor(kps), means,
                       cfg)
    view64 = view._replace(images=view.images.double())
    fwd_model = copy.deepcopy(model).double()
    with torch.no_grad():
        preds, _ = C.forward_heatmaps(fwd_model, view64.images, True,
                                      cfg.compute_dtype)
    step_model = copy.deepcopy(model).double()
    opt = torch.optim.AdamW(step_model.parameters(), lr=cfg.lr,
                            weight_decay=cfg.wd)
    metrics = supervised_step(step_model, opt, view64, cfg)
    est = PoseEstimator(copy.deepcopy(model), sd, MEANS, cfg, batch_size=BS,
                        device="cpu")
    serve_kps, serve_scores = est.predict(serve)
    with torch.no_grad():
        eval_preds, _ = C.forward_heatmaps(
            est.model, C.images_to_float(torch.as_tensor(serve)) -
            means[None, :, None, None], False, cfg.compute_dtype)
    return {"view": view, "preds": preds, "fwd_model": fwd_model,
            "step_model": step_model, "loss": float(metrics["pec_loss"]),
            "serve_kps": serve_kps, "serve_scores": serve_scores,
            "eval_last": eval_preds[:, -1]}


def _torch_keyed(ref, params_key, stats_key):
    return state_dict_from_jax(ref[params_key], ref[stats_key], 2)


def test_view_matches_jax(ref, port):
    """Un-augmented view: images (NCHW) atol 1e-6, targets atol 1e-5,
    re-gated keypoints exact."""
    rv, pv = ref["view"], port["view"]
    np.testing.assert_allclose(pv.images.numpy(),
                               np.moveaxis(rv["images"], -1, 1), atol=1e-6)
    np.testing.assert_allclose(pv.heatmaps.numpy(),
                               np.moveaxis(rv["heatmaps"], -1, 1), atol=1e-5)
    np.testing.assert_array_equal(pv.kps.numpy(), rv["kps"])
    assert 0 < pv.gate.sum() < pv.gate.numel()


def test_train_forward_matches_flax(ref, port):
    """Train-mode forward (float64) on the carried-over init: heatmap
    stacks, cast to float32 by both, at rtol 1e-5 / atol 1e-6; updated BN
    running stats (flax's biased-variance update) at rtol 1e-6."""
    np.testing.assert_allclose(port["preds"].numpy(),
                               np.moveaxis(ref["preds"], -1, 2),
                               rtol=1e-5, atol=1e-6)
    want = _torch_keyed(ref, "params", "new_stats")
    got = port["fwd_model"].state_dict()
    stat_keys = [k for k in want if k.endswith(("running_mean",
                                                "running_var"))]
    assert stat_keys
    for key in stat_keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-6, err_msg=key)


def test_step_loss_matches_jax(ref, port):
    """pose_weight * JointMSE of the supervised step: rtol 1e-5."""
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)


def test_step_grads_match_jax(ref, port):
    """Gradients of every parameter: rtol 1e-3, atol 1e-6 * max|g| over all
    parameters (the conv biases in front of a train-mode BatchNorm have an
    exactly-zero gradient, which both frameworks give as rounding noise)."""
    want = _torch_keyed(ref, "grads", "stats")
    g_max = max(float(w.abs().max()) for w in want.values())
    for name, p in port["step_model"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-6 * g_max,
                                   err_msg=name)


def test_step_params_match_jax(ref, port):
    """Post-step parameters: AdamW's first step moves each weight by about
    lr * sign(g), so a gradient near 0 may flip by up to 2 lr: all within
    3e-4 (about one lr), and >= 99.9% of elements within 1e-6."""
    want = _torch_keyed(ref, "new_params", "stats")
    n_tot = n_close = 0
    for name, p in port["step_model"].named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 3e-4, (name, d.max())
        n_tot += d.size
        n_close += int((d <= 1e-6).sum())
    assert n_close / n_tot >= 0.999, n_close / n_tot


def test_serving_matches_jax(ref, port):
    """PoseEstimator(device="cpu") vs the JAX PoseEstimator, 6 images in
    chunks of 4 (ragged last chunk): coords equal wherever the heatmap's
    top-2 margin is > 1e-4 (argmax well defined), scores rtol 1e-4."""
    last = port["eval_last"].flatten(2)
    top2 = last.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 1e-4).numpy()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(port["serve_kps"][clear],
                                  ref["serve_kps"][clear])
    np.testing.assert_allclose(port["serve_scores"], ref["serve_scores"],
                               rtol=1e-4)


def test_synthetic_data_matches_jax():
    """The port draws the synthetic dataset exactly as ubpl_tpu's
    _setup_synthetic_data does from the same seed."""
    from ubpl_tpu.config import Config as JConfig
    from ubpl_tpu.train.supervised import SupervisedTrainer as JTrainer
    kw = dict(synthetic_data=True, synthetic_kps=K, inp_res=32,
              train_count=6, valid_count=3, label_ratio=0.5, seed=9)
    jt = object.__new__(JTrainer)     # data setup only, no model init
    jt.cfg, jt.mesh = JConfig(**kw), None
    jt._setup_synthetic_data()
    train, valid, n_lab = synthetic_arrays(Config(**kw))
    assert n_lab == len(jt.labeled_idxs)
    for ours, theirs in ((train, jt.train_data), (valid, jt.valid_data)):
        for key in ("images", "kps", "kps_test", "islabeled"):
            np.testing.assert_array_equal(ours[key],
                                          np.asarray(getattr(theirs, key)))


def test_supervised_trainer_cpu(monkeypatch):
    """SupervisedTrainer on the CPU: each step builds its targets through
    the kernel wrapper exactly once; loss and PCK are finite."""
    calls = []
    real = C.heatmap_synth.synthesize_heatmaps

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(C.heatmap_synth, "synthesize_heatmaps", spy)
    cfg = Config(model="HG2", synthetic_data=True, synthetic_kps=K,
                 inp_res=R, out_res=OUT, train_count=8, valid_count=5,
                 label_ratio=1.0, train_bs=BS, infer_bs=BS,
                 compute_dtype="float32")
    tr = SupervisedTrainer(cfg, device="cpu")
    losses = tr.train_epoch()
    assert len(calls) == 2 and np.isfinite(losses["pec_loss"])
    preds, accs, errs = tr.validate()
    assert len(preds[0]) == 5 and len(accs[0]) == K + 1
    assert np.isfinite(accs[0]).all() and np.isfinite(errs[0]).all()
