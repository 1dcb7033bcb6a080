"""The hourglass's train-mode BatchNorm + ReLU kernel pair
(``ubpl_torch/ops/kernels/batch_norm_relu.py``) and the layers that call it.

On the CPU: the plain version against an independent float64 formula
(flax's biased running-variance update), the layers' choice of path
(eval mode, a batch group and the CPU keep today's ops, bit for bit), a
``StackedHourglass`` train step through the op, as on the card, against
the pre-kernel composition, the state-dict keys and the kernel's
registration.  With ``@pytest.mark.cuda``:
the kernels against the plain version on the card at the main path's
shapes (they skip without one).  The file imports no JAX, so the card's
tests run with ``--noconftest``.
"""
import copy
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ubpl_torch.models.layers as L
from ubpl_torch.models import create_pose_model
from ubpl_torch.models.layers import BatchNorm, ConvBlock, Residual
from ubpl_torch.ops.kernels import KERNELS
from ubpl_torch.ops.kernels import batch_norm_relu as K

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "torch_import_hg2.npz")
EPS, MOMENTUM = 1e-5, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share the host: compute single-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bn(C, seed, dtype=torch.float64, device="cpu"):
    """A train-mode ``BatchNorm`` with drawn weights and running stats."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.5 * torch.randn(C, generator=g))
        bn.bias.copy_(0.5 * torch.randn(C, generator=g))
        bn.running_mean.copy_(torch.randn(C, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=g))
    return bn.to(device=device, dtype=dtype).train()


def _formula(x, cb, weight, bias, running_mean, running_var):
    """relu(BN_train(x + cb)) written out, and flax's running update."""
    v = x if cb is None else x + cb.view(1, -1, 1, 1)
    dims = (0, 2, 3)
    mean = v.mean(dims)
    var = ((v - mean.view(1, -1, 1, 1)) ** 2).mean(dims)
    y = ((v - mean.view(1, -1, 1, 1)) / torch.sqrt(var + EPS).view(
        1, -1, 1, 1)) * weight.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    return (F.relu(y), (1 - MOMENTUM) * running_mean + MOMENTUM * mean,
            (1 - MOMENTUM) * running_var + MOMENTUM * var)


# ------------------------------------------------------------- plain, CPU
@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (4, 6, 1, 1)],
                         ids=["5x3", "1x1"])
@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
@pytest.mark.parametrize("has_bias", [True, False], ids=["bias", "nobias"])
def test_plain_matches_formula(shape, update, has_bias):
    """The plain version in float64: output, running mean and flax's biased
    running variance (or the stats untouched with ``update_stats`` off),
    and the gradients of x, the conv bias, gamma and beta, against the
    formula written out: rtol 1e-10."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(1.0, 2.0, shape), requires_grad=True)
    cb = (torch.tensor(rng.normal(size=shape[1]), requires_grad=True)
          if has_bias else None)
    bn = _bn(shape[1], 1)
    bn.update_stats = update
    ref_w = bn.weight.detach().clone().requires_grad_()
    ref_b = bn.bias.detach().clone().requires_grad_()
    ref_y, ref_rm, ref_rv = _formula(x, cb, ref_w, ref_b, bn.running_mean,
                                     bn.running_var)
    if not update:
        ref_rm, ref_rv = bn.running_mean.clone(), bn.running_var.clone()
    y = K.batch_norm_relu_plain(x, cb, bn)
    torch.testing.assert_close(y, ref_y, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(bn.running_mean, ref_rm, rtol=1e-10,
                               atol=1e-12)
    torch.testing.assert_close(bn.running_var, ref_rv, rtol=1e-10,
                               atol=1e-12)
    dy = torch.tensor(rng.normal(size=shape))
    leaves = [x, bn.weight, bn.bias] + ([cb] if has_bias else [])
    got = torch.autograd.grad(y, leaves, dy)
    want = torch.autograd.grad(ref_y, [x, ref_w, ref_b]
                               + ([cb] if has_bias else []), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def test_cpu_wrapper_takes_plain_version():
    """A CPU tensor goes to the plain version, bit for bit, with no launch
    and no kernel call counted."""
    x = torch.randn(4, 6, 3, 3, dtype=torch.float64)
    cb = torch.randn(6, dtype=torch.float64)
    a, b = _bn(6, 2), _bn(6, 2)
    before = (K.launches, K.calls)
    assert torch.equal(K.batch_norm_relu(x, cb, a),
                       K.batch_norm_relu_plain(x, cb, b))
    assert torch.equal(a.running_var, b.running_var)
    assert (K.launches, K.calls) == before


def test_wrapper_rejects_other_devices():
    """Neither CPU nor CUDA: the wrapper raises, it never falls back."""
    with pytest.raises(ValueError):
        K.batch_norm_relu(torch.zeros(2, 4, 2, 2, device="meta"), None,
                          _bn(4, 0).to("meta"))


def test_kernel_is_registered():
    """The module is in ``KERNELS`` with the registry's attributes; it
    replaces no Pallas kernel."""
    assert K in KERNELS
    assert K.NAME == "batch_norm_relu"
    assert K.SOURCE == "ubpl_torch/ops/kernels/batch_norm_relu.py"
    assert os.path.exists(os.path.join(os.path.dirname(
        os.path.dirname(__file__)), K.SOURCE))
    assert K.REPLACES.startswith("none")
    assert isinstance(K.launches, int) and isinstance(K.calls, int)


@pytest.mark.parametrize("n,C", [(1, 64), (63, 256), (512, 256), (513, 128),
                                 (2048, 256), (8192, 256), (131072, 128),
                                 (524288, 64), (1000003, 96)])
def test_split_rows_covers_every_row(n, C):
    """The passes' split of n rows: whole row tiles per program, every row
    in exactly one program, and about ``PROGRAMS`` programs in all (one
    path for every shape, the 4x4 level's 512 rows included)."""
    G, rows = K._split_rows(n, C)
    c_blocks = -(-C // K.BLOCK_C)
    assert rows % K.BLOCK_R == 0 and rows > 0
    assert (G - 1) * rows < n <= G * rows
    assert 1 <= G * c_blocks < K.PROGRAMS + c_blocks


# ------------------------------------------------------ the layers' paths
def _old_conv_block(m, x):
    x = m.conv(x)
    if m.bn is not None:
        x = m.bn(x)
    return F.relu(x) if m.relu else x


def _old_residual(m, x):
    residual = x if m.skip_layer is None else m.skip_layer(x)
    out = m.conv1(F.relu(m.bn1(x)))
    out = m.conv2(F.relu(m.bn2(out)))
    out = m.conv3(F.relu(m.bn3(out)))
    return out + residual


def _layer(kind):
    torch.manual_seed(3)
    if kind == "conv_block":
        return ConvBlock(4, 8, 3, bn=True, relu=True).double(), \
            _old_conv_block
    return Residual(4, 8).double(), _old_residual


def _no_kernel(monkeypatch):
    def refuse(*args):
        raise AssertionError("batch_norm_relu called")
    monkeypatch.setattr(L, "batch_norm_relu", refuse)


@pytest.mark.parametrize("kind", ["conv_block", "residual"])
def test_eval_mode_runs_todays_ops(kind, monkeypatch):
    """Eval mode (serving) never reaches the fused op and gives today's
    output bit for bit."""
    m, old = _layer(kind)
    for bn in m.modules():
        if isinstance(bn, BatchNorm):
            with torch.no_grad():
                bn.running_mean.normal_()
    m.eval()
    x = torch.randn(2, 4, 6, 6, dtype=torch.float64)
    want = old(m, x)
    _no_kernel(monkeypatch)
    assert torch.equal(m(x), want)


@pytest.mark.parametrize("kind", ["conv_block", "residual"])
def test_batch_group_path_runs_todays_ops(kind, monkeypatch):
    """With a batch group (data parallel) the BatchNorms keep their global
    statistics (``_GlobalBatchNorm``) and the layers today's ops: output,
    running stats and gradients bit for bit.  The group's collectives are
    a one-rank world's (the local values)."""
    m, old = _layer(kind)
    m2 = copy.deepcopy(m)
    for net in (m, m2):
        for bn in net.modules():
            if isinstance(bn, BatchNorm):
                bn.group = "batch group"
    monkeypatch.setattr(L, "all_gather_stacked", lambda x, group: x[None])
    monkeypatch.setattr(L, "all_reduce_sum", lambda x, group: x)
    x = torch.randn(3, 4, 5, 5, dtype=torch.float64)
    want = old(m2, x)
    want.sum().backward()
    _no_kernel(monkeypatch)
    got = m(x)
    got.sum().backward()
    assert torch.equal(got, want)
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    for (k, a), b in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(a.grad, b.grad), k


def _as_on_the_card(monkeypatch):
    """The layers' choice as a CUDA tensor makes it, on the CPU: the plain
    version then stands in for the kernels."""
    monkeypatch.setattr(L, "_fused", lambda x, *bns: all(
        bn.training and bn.group is None for bn in bns))


@pytest.mark.parametrize("kind", ["conv_block", "residual"])
def test_cpu_train_mode_runs_todays_ops(kind, monkeypatch):
    """On the CPU, train mode keeps today's ops (the conv with its bias,
    ``BatchNorm``, ``F.relu``): output, running stats and gradients bit for
    bit, so CPU runs of the program read as before."""
    m, old = _layer(kind)
    m2 = copy.deepcopy(m)
    x = torch.randn(3, 4, 5, 5, dtype=torch.float64)
    want = old(m2, x)
    want.sum().backward()
    _no_kernel(monkeypatch)
    got = m(x)
    got.sum().backward()
    assert torch.equal(got, want)
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    for (k, a), b in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(a.grad, b.grad), k


@pytest.mark.parametrize("kind", ["conv_block", "residual"])
def test_train_mode_takes_the_fused_op(kind, monkeypatch):
    """Train mode without a group, as on the card: every BN-ReLU goes
    through ``batch_norm_relu`` (1 call in a ``ConvBlock``, 3 in a
    ``Residual``), the convs before bn2 and bn3 hand it their biases, and
    the result equals today's composition in float64 (rtol 1e-12)."""
    m, old = _layer(kind)
    m2 = copy.deepcopy(m)
    x = torch.randn(3, 4, 5, 5, dtype=torch.float64)
    want = old(m2, x)
    _as_on_the_card(monkeypatch)
    seen = []

    def spy(x, conv_bias, bn):
        seen.append((conv_bias, bn))
        return K.batch_norm_relu(x, conv_bias, bn)
    monkeypatch.setattr(L, "batch_norm_relu", spy)
    got = m(x)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    if kind == "conv_block":
        assert seen == [(m.conv.bias, m.bn)]
    else:
        assert seen == [(None, m.bn1), (m.conv1.conv.bias, m.bn2),
                        (m.conv2.conv.bias, m.bn3)]
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=k)


@pytest.mark.parametrize("name", ["HG1", "HG2"])
def test_stacked_hourglass_train_step_equals_composition(name, monkeypatch):
    """A ``StackedHourglass`` train-mode forward and backward (float64, inp
    64, bs 4) through ``batch_norm_relu``, as on the card, equals the
    pre-kernel composition: heatmaps, features, running stats and every parameter's
    gradient (relative 1e-9, a gradient to the largest one's norm: the
    conv runs without its bias and the bias is added after it, a different
    rounding that the 1x1 level amplifies, ROADMAP C.3; the biases of the
    convs before a BatchNorm have a gradient that is 0 in exact
    arithmetic).  ``batch_norm_relu`` runs 10 + 43 times per stack."""
    torch.manual_seed(0)
    model = create_pose_model(name, 5, "AvgPool").double().train()
    old = copy.deepcopy(model)
    x = torch.randn(4, 3, 64, 64, dtype=torch.float64)
    calls = []

    def spy(*args):
        calls.append(1)
        return K.batch_norm_relu(*args)
    monkeypatch.setattr(L, "batch_norm_relu", spy)
    _as_on_the_card(monkeypatch)
    preds, feats = model(x)
    ((preds ** 2).sum() + (feats ** 2).sum()).backward()
    assert len(calls) == 10 + 43 * model.n_stack
    monkeypatch.setattr(L, "_fused", lambda x, *bns: False)
    preds2, feats2 = old(x)
    ((preds2 ** 2).sum() + (feats2 ** 2).sum()).backward()
    assert len(calls) == 10 + 43 * model.n_stack
    for a, b in ((preds, preds2), (feats, feats2)):
        assert float((a - b).detach().norm() / b.detach().norm()) <= 1e-9
    new_sd, old_sd = model.state_dict(), old.state_dict()
    assert list(new_sd) == list(old_sd)
    for k in new_sd:
        assert float((new_sd[k] - old_sd[k]).norm()) <= 1e-9 * max(
            1.0, float(old_sd[k].norm())), k
    top = max(float(p.grad.norm()) for p in old.parameters())
    for (k, a), b in zip(model.named_parameters(), old.parameters()):
        assert float((a.grad - b.grad).norm()) <= 1e-9 * max(
            top, float(b.grad.norm())), k


def test_state_dict_keys_unchanged():
    """The convs keep their biases and the BatchNorms their buffers: an HG2's
    keys are the reference checkpoint's (less the dead same-width skip
    convs and the BN counters)."""
    g = np.load(GOLDEN)
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    live = set()
    for k in sd:
        if k.endswith("num_batches_tracked"):
            continue
        if ".skip_layer." in k:
            w = sd[k[:k.index(".skip_layer.")] + ".skip_layer.conv.weight"]
            if w.shape[0] == w.shape[1]:
                continue
        live.add(k)
    model = create_pose_model(f"HG{int(g['n_stack'])}", int(g["k"]))
    assert set(model.state_dict()) == live
    assert "hgs.0.0.up1.conv1.conv.bias" in live
    assert "pre.0.conv.bias" in live


# ------------------------------------------------------------- the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernels have no CPU "
                    "mode)")


def _ulp(scale):
    """One bf16 ulp at ``scale``."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _case(C, hw, has_bias, dtype=torch.bfloat16, seed=0, bs=32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(bs, C, hw, hw, device="cuda", generator=g) * 1.5
         + 0.3).to(dtype).contiguous(memory_format=torch.channels_last)
    cb = (0.2 * torch.randn(C, device="cuda", generator=g)).to(
        torch.float64 if dtype == torch.float64 else torch.float32) \
        if has_bias else None
    dy = torch.randn(bs, C, hw, hw, device="cuda", generator=g).to(
        dtype).contiguous(memory_format=torch.channels_last)
    pdtype = torch.float64 if dtype == torch.float64 else torch.float32
    return x, cb, dy, _bn(C, seed + 1, pdtype, "cuda")


def _run(fn, x, cb, dy, bn):
    """y, running stats and the gradients of x, cb, gamma, beta."""
    x = x.detach().clone().requires_grad_()
    cb = None if cb is None else cb.detach().clone().requires_grad_()
    y = fn(x, cb, bn)
    leaves = [x, bn.weight, bn.bias] + ([] if cb is None else [cb])
    grads = torch.autograd.grad(y, leaves, dy.to(y.dtype))
    return (y.detach(), bn.running_mean.clone(), bn.running_var.clone(),
            *grads)


#: per input dtype: y and dx within tol(scale) of the reference (dx where
#: its pre-ReLU value is not within 1e-4 of 0: a rounding of the statistics
#: may flip the mask there), running stats rtol, gamma's and beta's
#: gradients to their norm (such flips), and the conv bias's gradient
#: against the sum of the returned dx, to the sum of |dx| (for bf16, the
#: fp32 sum before dx's rounding: at most 2^-8 away)
TOL = {torch.bfloat16: (_ulp, 1e-5, 5e-3, 2.0 ** -8),
       torch.float32: (lambda s: 1e-5 * s, 1e-5, 1e-3, 1e-5),
       torch.float64: (lambda s: 1e-12 * s, 1e-10, 1e-10, 1e-12)}


def _compare(got, ref, x, cb, ref_bn):
    tol, stats_rtol, grad_rel, bias_rel = TOL[x.dtype]
    y, ref_y = got[0].to(ref[0].dtype), ref[0]
    assert got[0].dtype == x.dtype
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    assert float((y - ref_y).abs().max()) <= tol(float(ref_y.abs().max()))
    for a, b in zip(got[1:3], ref[1:3]):
        torch.testing.assert_close(a, b, rtol=stats_rtol,
                                   atol=stats_rtol * float(b.abs().max()))
    v = x.double() + (0 if cb is None else cb.double().view(1, -1, 1, 1))
    pre = ((v - v.mean((0, 2, 3), keepdim=True))
           * v.var((0, 2, 3), unbiased=False, keepdim=True).add(EPS).rsqrt()
           * ref_bn.weight.double().view(1, -1, 1, 1)
           + ref_bn.bias.double().view(1, -1, 1, 1)).abs() > 1e-4
    dx, ref_dx = got[3].to(ref[3].dtype), ref[3]
    assert float(((dx - ref_dx).abs() * pre).max()) <= tol(
        float(ref_dx.abs().max()))
    for a, b in zip(got[4:6], ref[4:6]):
        assert float((a - b).norm() / b.norm()) <= grad_rel
    if cb is not None:
        summed = got[3].double().sum((0, 2, 3))
        spread = got[3].double().abs().sum((0, 2, 3))
        assert bool(((got[6].double() - summed).abs()
                     <= bias_rel * spread).all())


@pytest.mark.cuda
@pytest.mark.parametrize("has_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("hw", [128, 64, 16, 8, 4])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_kernel_matches_plain_on_cuda(C, hw, has_bias):
    """bf16 channels_last at bs 32 against the plain version run in fp32 on
    the same values (``TOL``): y and dx within one bf16 ulp of their scale,
    running stats rtol 1e-5, gamma's and beta's gradients 5e-3 of their
    norm, the conv bias's gradient the fp32 sum of dx; the batch mean and
    inverse std rtol 1e-5 against float64."""
    _need_cuda()
    x, cb, dy, bn = _case(C, hw, has_bias)
    ref_bn = copy.deepcopy(bn)
    calls, launches = K.calls, K.launches
    got = _run(K.batch_norm_relu, x, cb, dy, bn)
    assert K.calls == calls + 1 and K.launches > launches
    ref = _run(K.batch_norm_relu_plain, x.float(), cb, dy.float(), ref_bn)
    _compare(got, ref, x, cb, ref_bn)
    v = x.double() + (0 if cb is None else cb.double().view(1, -1, 1, 1))
    mean, invstd = K._forward(x, cb, copy.deepcopy(bn))[1:]
    torch.testing.assert_close(mean.double(), v.mean((0, 2, 3)),
                               rtol=1e-5, atol=1e-5 * float(v.abs().max()))
    torch.testing.assert_close(
        invstd.double(), v.var((0, 2, 3), unbiased=False).add(EPS).rsqrt(),
        rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kernel_is_deterministic_on_cuda():
    """Two calls on the same input give the same bits: output, running
    stats and every gradient (no float atomics)."""
    _need_cuda()
    for hw in (64, 4):
        x, cb, dy, bn = _case(128, hw, True, seed=5)
        a = _run(K.batch_norm_relu, x, cb, dy, copy.deepcopy(bn))
        b = _run(K.batch_norm_relu, x, cb, dy, copy.deepcopy(bn))
        for s, t in zip(a, b):
            assert torch.equal(s, t)


@pytest.mark.cuda
@pytest.mark.parametrize("has_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("hw", [64, 4])
def test_kernel_launches_per_call_on_cuda(hw, has_bias):
    """One path at every level: a forward is 3 launches (statistics,
    combine, normalise), a backward 4 (sums, combine, dx, the conv bias's
    combine), 3 without a conv bias."""
    _need_cuda()
    x, cb, dy, bn = _case(128, hw, has_bias, seed=9)
    x.requires_grad_()
    before = K.launches
    y = K.batch_norm_relu(x, cb, bn)
    assert K.launches == before + 3
    y.backward(dy)
    assert K.launches == before + 3 + (4 if has_bias else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [64, 4])
def test_kernel_frozen_stats_on_cuda(hw):
    """``update_stats`` off (a ``remat`` recompute): the same output, and
    the running statistics left as they were, bit for bit."""
    _need_cuda()
    x, cb, dy, bn = _case(128, hw, True, seed=3)
    frozen = copy.deepcopy(bn)
    frozen.update_stats = False
    a = _run(K.batch_norm_relu, x, cb, dy, copy.deepcopy(bn))
    b = _run(K.batch_norm_relu, x, cb, dy, frozen)
    assert torch.equal(a[0], b[0])
    assert torch.equal(frozen.running_mean, bn.running_mean)
    assert torch.equal(frozen.running_var, bn.running_var)
    for s, t in zip(a[3:], b[3:]):
        assert torch.equal(s, t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hw", [64, 4])
def test_kernel_runs_fp32_and_fp64_on_cuda(dtype, hw):
    """fp32 input (the benchmark's float32 witness) and fp64 input (the
    float64 steps of ``chip_smoke.py``) go through the kernels too,
    against the plain version in the same dtype (``TOL``)."""
    _need_cuda()
    x, cb, dy, bn = _case(64, hw, True, dtype=dtype, seed=7)
    ref_bn = copy.deepcopy(bn)
    launches = K.launches
    with torch.backends.cudnn.flags(allow_tf32=False):
        got = _run(K.batch_norm_relu, x, cb, dy, bn)
        ref = _run(K.batch_norm_relu_plain, x, cb, dy, ref_bn)
    assert K.launches > launches
    _compare(got, ref, x, cb, ref_bn)


@pytest.mark.cuda
def test_kernel_takes_nchw_on_cuda():
    """A CUDA tensor in NCHW memory (a float64 network's convs give one)
    runs through the kernels too, copied to channels_last: the same
    values as the channels_last input, bit for bit."""
    _need_cuda()
    x, cb, dy, bn = _case(64, 8, True)
    launches = K.launches
    got = _run(K.batch_norm_relu, x.contiguous(), cb, dy,
               copy.deepcopy(bn))
    assert K.launches > launches
    want = _run(K.batch_norm_relu, x, cb, dy, copy.deepcopy(bn))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_on_cuda():
    """A CUDA tensor the kernels do not take (an integer dtype) raises; it
    never falls back to the plain version."""
    _need_cuda()
    x, cb, _, bn = _case(64, 8, True)
    launches = K.launches
    with pytest.raises(ValueError):
        K.batch_norm_relu(x.to(torch.int32), cb, bn)
    assert K.launches == launches


@pytest.mark.cuda
def test_hg3_train_forward_takes_the_kernel_139_times_on_cuda():
    """An HG3 train-mode forward on the card (bf16 autocast, channels_last)
    takes the kernels once per BatchNorm: 139 calls."""
    _need_cuda()
    model = create_pose_model("HG3", 9, "AvgPool").cuda().to(
        memory_format=torch.channels_last).train()
    x = torch.randn(2, 3, 256, 256, device="cuda").contiguous(
        memory_format=torch.channels_last)
    calls = K.calls
    with torch.autocast("cuda", torch.bfloat16), torch.no_grad():
        model(x)
    assert K.calls == calls + 139
