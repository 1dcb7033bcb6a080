"""LitePose, the init strategies and ``utils/comm.py`` of the port against
the JAX package.

All JAX work runs once, in the module-scoped ``ref`` fixture: LitePose
(K=5, 64x64 input, bs 2, AvgPool feature tap) on random flax weights (shapes
from the port's ``flax_entries``, values from a numpy seed) carried into
the port by ``litepose_state_dict_from_jax``, its eval forward in float32
and its train-mode forward in float64 (BatchNorm over 2 x 4 x 4 values at
the deepest stage: ROADMAP C.3); flax's SAME transposed conv on one-hot
kernels; and ``ubpl_tpu``'s ``parameters_initialize`` in every mode.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from ubpl_torch.models import create_pose_model
from ubpl_torch.models.init_strategies import parameters_initialize
from ubpl_torch.models.layers import (BatchNorm, ConvTranspose, Dense,
                                      flax_truncated_normal_)
from ubpl_torch.models.litepose import LitePose
from ubpl_torch.models.weights import (flax_entries, flax_to_port,
                                       litepose_state_dict_from_jax)
from ubpl_torch.utils import comm

K, R = 5, 64
INIT_MODES = ["constant", "uniform", "normal", "xavier", "kaiming_uniform",
              "kaiming_normal"]
TRUNC = 0.87962566103423978     # std of N(0, 1) truncated to [-2, 2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


_TO_FLAX = {"conv": (2, 3, 1, 0), "deconv": (2, 3, 0, 1), "dense": (1, 0)}


def _random_flax_trees(net, rng):
    """numpy (params, batch_stats) of ``net``'s flax counterpart: kernels
    of variance 1 / fan_in, BN scales near 1, small biases and means,
    variances in [0.5, 1.5]."""
    sd, tree = net.state_dict(), {"params": {}, "batch_stats": {}}
    for kind, fp, key, layout in flax_entries(net):
        shape = tuple(sd[key].shape)
        if layout is not None:
            shape = tuple(shape[i] for i in _TO_FLAX[layout])
            w = rng.normal(0, 1 / math.sqrt(np.prod(shape[:-1])), shape)
        elif fp[-1] == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif fp[-1] == "var":
            w = rng.uniform(0.5, 1.5, shape)
        else:
            w = 0.1 * rng.standard_normal(shape)
        _set(tree["params" if kind == "p" else "batch_stats"], fp,
             w.astype(np.float32))
    return tree["params"], tree["batch_stats"]


def _nchw(x):
    x = np.asarray(x)
    if x.ndim == 5:                      # [B, 1, h, w, K] feature stack
        return np.moveaxis(x, -1, 2)
    return np.moveaxis(x, -1, 1)


def _init_shapes():
    """flax kernel shapes of the init-strategy test model (``_init_net``)."""
    return {"conv": (3, 3, 16, 32), "dw": (3, 3, 1, 32),
            "deconv": (4, 4, 32, 16), "dense": (256, 128)}


def _init_net():
    net = nn.Sequential(nn.Conv2d(16, 32, 3), nn.Conv2d(32, 32, 3, groups=32),
                        BatchNorm(32), ConvTranspose(32, 16, 4),
                        Dense(256, 128))
    with torch.no_grad():
        net[2].running_mean.uniform_(-1, 1)
        net[2].running_var.uniform_(0.5, 2)
    return net


@pytest.fixture(scope="module")
def ref():
    from ubpl_tpu.models import create_pose_model as jcreate
    from ubpl_tpu.models.init_strategies import parameters_initialize as jinit
    rng = np.random.default_rng(3)
    with torch.device("meta"):
        params, stats = _random_flax_trees(LitePose(K, "AvgPool"), rng)
    x = rng.standard_normal((2, R, R, 3)).astype(np.float32)
    net = jcreate("LitePose", K, "AvgPool")

    def fwd(p, s, x, train):
        return net.apply({"params": p, "batch_stats": s}, x, train=train,
                         mutable=["batch_stats"] if train else False)
    f64 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), tree)
    ev = jax.jit(fwd, static_argnums=3)(params, stats, x, False)
    with jax.enable_x64(True):
        tr, new = jax.jit(fwd, static_argnums=3)(f64(params), f64(stats),
                                                 f64(x), True)
    # flax's SAME transposed conv on every one-hot kernel [4, 4, 2, 3]
    import flax.linen as fnn
    onehot = np.eye(4 * 4 * 2 * 3, dtype=np.float32).reshape(-1, 4, 4, 2, 3)
    xt = rng.standard_normal((1, 5, 6, 2)).astype(np.float32)
    deconv = fnn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME",
                               use_bias=False)
    dt = jax.jit(jax.vmap(lambda k: deconv.apply({"params": {"kernel": k}},
                                                 xt)))(onehot)
    # ubpl_tpu's parameters_initialize on the test model's kernel shapes
    tree = {name: {"kernel": jnp.zeros(s)} for name, s in
            _init_shapes().items()}
    tree["bn"] = {"scale": jnp.zeros(32), "bias": jnp.ones(32)}
    inits = jax.jit(lambda k: {m: jinit(tree, k, m) for m in INIT_MODES})(
        jax.random.PRNGKey(1))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": params, "stats": stats, "x": x, "eval": np_tree(ev),
            "train": np_tree(tr), "new_stats": np_tree(new["batch_stats"]),
            "onehot": onehot, "deconv_x": xt, "deconv": np.asarray(dt),
            "inits": np_tree(inits)}


# ---------------------------------------------------------------- LitePose
def _port(ref):
    with torch.device("meta"):          # weights come from flax
        net = LitePose(K, "AvgPool")
    net.load_state_dict(litepose_state_dict_from_jax(
        ref["params"], ref["stats"], K), assign=True)
    return net


def _check(got, want):
    (o1, o2), feat = got
    (w1, w2), wfeat = want
    assert tuple(o1.shape) == (2, K, R // 4, R // 4)
    assert tuple(o2.shape) == (2, K, R // 2, R // 2)
    assert tuple(feat.shape) == (2, 1, K, R // 8, R // 8)
    for g, w in ((o1, w1), (o2, w2), (feat, wfeat)):
        np.testing.assert_allclose(g.detach().numpy(), _nchw(w), rtol=1e-4,
                                   atol=1e-5)


def test_eval_forward_matches_flax(ref):
    """Eval mode, fp32: both heatmap outputs (64 -> 16x16 and 32x32) and
    the AvgPool feature stack [B, 1, K, 8, 8]: rtol 1e-4 / atol 1e-5."""
    net = _port(ref).eval()
    with torch.no_grad():
        got = net(torch.as_tensor(_nchw(ref["x"])))
    _check(got, ref["eval"])


def test_train_forward_matches_flax(ref):
    """Train mode in float64 on both sides: both outputs, the feature and
    every BatchNorm's new running stats (flax's biased-variance update),
    rtol 1e-4 / atol 1e-5."""
    net = _port(ref).double().train()
    with torch.no_grad():
        got = net(torch.as_tensor(_nchw(ref["x"])).double())
    _check(got, ref["train"])
    want = litepose_state_dict_from_jax(ref["params"], ref["new_stats"], K)
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, BatchNorm)
                                for m in net.modules())
    sd = net.state_dict()
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_feature_modes_and_factory():
    """``create_pose_model("LitePose", K, mode)``: "default" returns the two
    outputs alone; MaxPool / AvgPool pool the first output 2x2 into the
    feature stack, ConvOne taps it as it is; one stack."""
    torch.manual_seed(0)
    net = create_pose_model("LitePose", K, "default")
    assert isinstance(net, LitePose) and net.n_stack == 1
    x = torch.randn(1, 3, R, R)
    with torch.no_grad():
        o1, o2 = net.eval()(x)
        for mode, pool in (("MaxPool", torch.nn.functional.max_pool2d),
                           ("AvgPool", torch.nn.functional.avg_pool2d),
                           ("ConvOne", None)):
            net.mode = mode
            outs, feat = net(x)
            assert torch.equal(outs[0], o1) and torch.equal(outs[1], o2)
            want = o1 if pool is None else pool(o1, 2, 2)
            assert torch.equal(feat, want[:, None])
    with pytest.raises(ValueError, match="unknown pose model"):
        create_pose_model("LitePose2", K)


def test_mobile_block_middle_conv_is_dense():
    """ConvMobileBlock's k x k conv is a dense conv (no groups), mid =
    in + out // 2 wide, as the JAX package computes it; the skip only
    where the shape is kept."""
    net = LitePose(K)
    block = net.stages[0][0]
    assert block.conv2.conv.groups == 1
    assert block.conv2.conv.weight.shape == (16 + 12, 16 + 12, 7, 7)
    assert not block.residual and net.stages[0][1].residual


def test_transposed_conv_one_hot(ref):
    """flax ConvTranspose(k=4, s=2, SAME) against the port's
    ``ConvTranspose`` with ``flax_to_port``'s kernel, for each of the 96
    one-hot kernels [4, 4, in 2, out 3] on a 5x6 input: to 1e-5 (a kernel
    tap moved by one pixel, or in/out swapped, fails), output 10x12."""
    conv = ConvTranspose(2, 3, 4)
    x = torch.as_tensor(_nchw(ref["deconv_x"]))
    for k, want in zip(ref["onehot"], ref["deconv"]):
        with torch.no_grad():
            conv.weight.copy_(torch.as_tensor(flax_to_port(k, "deconv")
                                              .copy()))
            got = conv(x)
        assert tuple(got.shape) == (1, 3, 10, 12)
        np.testing.assert_allclose(got.numpy(), _nchw(want), atol=1e-5)
    assert np.abs(ref["deconv"]).sum(axis=(1, 2, 3, 4)).min() > 0


def test_transposed_conv_rejects_odd_kernel():
    with pytest.raises(ValueError, match="even kernel"):
        ConvTranspose(2, 3, 3)


# ---------------------------------------------------------------- inits
def _kernels(net):
    """port weight -> (name, flax shape) of the init-strategy test model."""
    return {"conv": net[0].weight, "dw": net[1].weight,
            "deconv": net[3].weight, "dense": net[4].weight}


def _expect(mode, shape):
    """(mean, std, lo, hi) of ``mode`` on a flax kernel ``shape``."""
    rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fi, fo = shape[-2] * rf, shape[-1] * rf
    if mode == "constant":
        return 0.5, 0.0, 0.5, 0.5
    if mode == "uniform":
        return 0.5, math.sqrt(1 / 12), 0.0, 1.0
    if mode == "normal":
        return 0.0, 1.0, -math.inf, math.inf
    if mode == "kaiming_normal":
        std = math.sqrt(2 / fi)
        return 0.0, std, -2 * std / TRUNC, 2 * std / TRUNC
    bound = math.sqrt(6 / (fi + fo) if mode == "xavier" else 6 / fi)
    return 0.0, bound / math.sqrt(3), -bound, bound


def _check_moments(w, mode, shape):
    _check_draws(w, *_expect(mode, shape), truncated=mode == "kaiming_normal")


def _check_draws(w, mean, std, lo, hi, truncated=False):
    """Draws within [lo, hi], mean and std within 5 standard errors; a
    truncated normal reaches near its bounds and does not pile up there."""
    w = np.asarray(w, np.float64).ravel()
    n = w.size
    assert w.min() >= lo and w.max() <= hi
    if std == 0:
        assert (w == mean).all()
        return
    assert abs(w.mean() - mean) <= 5 * std / math.sqrt(n)
    assert abs(w.std() / std - 1) <= 5 / math.sqrt(2 * n)
    if truncated:
        assert np.abs(w).max() > 0.9 * hi
        assert (np.abs(w) >= hi * (1 - 1e-6)).sum() <= 1


@pytest.mark.parametrize("mode", INIT_MODES)
def test_parameters_initialize_distribution(ref, mode):
    """Each strategy's draws (conv, depthwise conv, transposed conv, dense)
    have the mean, std and bounds of flax's initializer on the flax kernel
    shape — the same as ``ubpl_tpu``'s ``parameters_initialize`` draws for
    those shapes; biases 0, BatchNorm weights 1, running stats untouched;
    reproducible from the generator."""
    net = _init_net()
    stats = [b.clone() for b in net[2].buffers()]
    g = torch.Generator().manual_seed(5)
    assert parameters_initialize(net, g, mode) is net
    shapes = _init_shapes()
    for name, w in _kernels(net).items():
        assert tuple(flax_to_port(np.zeros(shapes[name]), "deconv" if
                                  name == "deconv" else "conv" if
                                  len(shapes[name]) == 4 else "dense")
                     .shape) == tuple(w.shape)
        _check_moments(w.detach().numpy(), mode, shapes[name])
        _check_moments(ref["inits"][mode][name]["kernel"], mode,
                       shapes[name])
    assert (net[0].bias == 0).all() and (net[4].bias == 0).all()
    assert (net[2].weight == 1).all() and (net[2].bias == 0).all()
    assert (ref["inits"][mode]["bn"]["scale"] == 1).all()
    assert (ref["inits"][mode]["bn"]["bias"] == 0).all()
    for a, b in zip(stats, net[2].buffers()):
        assert torch.equal(a, b)
    again = parameters_initialize(_init_net(), torch.Generator()
                                  .manual_seed(5), mode)
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_parameters_initialize_unknown_mode():
    """An unknown mode raises the JAX package's ValueError, choices
    listed."""
    from ubpl_tpu.models.init_strategies import parameters_initialize as jinit
    with pytest.raises(ValueError) as want:
        jinit({}, jax.random.PRNGKey(0), "he")
    with pytest.raises(ValueError) as got:
        parameters_initialize(_init_net(), None, "he")
    assert str(got.value) == str(want.value)
    assert "kaiming_normal" in str(got.value)


def test_flax_default_inits():
    """The flax defaults the port copies: ``Dense`` draws lecun_normal
    (truncated at 2 std, std 1/sqrt(fan_in)) with a zero bias;
    ``ConvTranspose`` uniform(+-1/sqrt(k*k*in)) (flax's fan of its
    [k, k, in, out] kernel, not torch's); ``flax_truncated_normal_``
    reproducible from a generator."""
    torch.manual_seed(0)
    d = Dense(400, 300)
    std = 1 / math.sqrt(400)
    _check_draws(d.weight.detach().numpy(), 0.0, std, -2 * std / TRUNC,
                 2 * std / TRUNC, truncated=True)
    assert (d.bias == 0).all()
    c = ConvTranspose(48, 24, 4)
    bound = 1 / math.sqrt(4 * 4 * 48)
    w = c.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.99 * bound
    a, b = torch.empty(1000), torch.empty(1000)
    flax_truncated_normal_(a, 0.3, torch.Generator().manual_seed(2))
    flax_truncated_normal_(b, 0.3, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


# -------------------------------------------------------------------- comm
def test_comm_helpers_match_jax(tmp_path):
    """utils/comm.py against ubpl_tpu.utils.comm: the same results and the
    same files."""
    from ubpl_tpu.utils import comm as jcomm
    for x in (-2.5, -1, 0, 0.0, 3, 1e-9):
        assert comm.math_signal(x) == jcomm.math_signal(x)
    for name in ("b.json", "a.json", "c.txt"):
        (tmp_path / name).write_text(name)
    pattern = str(tmp_path / "*.json")
    assert comm.file_scan(pattern) == jcomm.file_scan(pattern) == [
        str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    for p in (str(tmp_path / "a.json"), str(tmp_path), str(tmp_path / "x")):
        assert comm.file_isfile(p) == jcomm.file_isfile(p)
    for p in ("/d/e/img.tar.gz", "x.png", "noext"):
        assert comm.file_split_filename(p) == jcomm.file_split_filename(p)
    for mod, side in ((comm, "port"), (jcomm, "jax")):
        dst = tmp_path / side / "deep" / "a.json"
        mod.file_copy(str(tmp_path / "a.json"), str(dst))
        assert dst.read_text() == "a.json"
        d = str(tmp_path / side / "made" / "here")
        assert mod.folder_ensure(d) == d and os.path.isdir(d)
        assert mod.folder_ensure(d) == d
