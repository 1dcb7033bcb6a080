"""ViTPose in the port (``ubpl_torch/models/vitpose.py``) against its plain
float32 reference (``tests/vitpose_reference.py``) on seeded random
weights, at a test size (2 blocks of 64, 4 heads, 64 x 64 input, drop path
0.55); its drop-path masks; the MT_UBPL trainer with it; the published
sizes, built on the meta device.  The ``cuda`` test holds the graphed
trainer against an eager one on the card: ``python -m pytest --noconftest
-m cuda tests/test_torch_vitpose.py`` (this file imports no JAX)."""
import math
import os
import sys

import numpy as np
import pytest
import torch

import ubpl_torch.train.common as C
import ubpl_torch.train.mt_ubpl as MT
from ubpl_torch.config import Config
from ubpl_torch.infer import PoseEstimator
from ubpl_torch.models import create_pose_model, param_count
from ubpl_torch.models.vitpose import drop_path_scales
from ubpl_torch.train.mt_ubpl import MTUBPLTrainer

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]   # the tests, the checkout
import vitpose_reference as R  # noqa: E402

NAME, K, RES, DEPTH, WIDTH, HEADS, RATE = "ViTPose-2x64x4", 5, 64, 2, 64, 4, \
    0.55
#: the float32 tolerance, relative to the reference's norm
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _state(seed):
    """Seeded random weights for the test size: every float tensor drawn
    (LayerNorm and BatchNorm scales around 1, running variances
    positive), the call counter at 0."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in create_pose_model(NAME, K).state_dict() \
            .items():
        if k == "drop_calls":
            sd[k] = torch.zeros_like(v)
            continue
        x = torch.randn(v.shape, generator=g)
        if k.endswith("running_var"):
            x = x.abs() + 0.5
        elif v.dim() == 1 and k.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = x * (0.3 if v.dim() <= 1 else v[0].numel() ** -0.5)
        sd[k] = x
    return sd


def _pair(dtype=torch.float32, seed=0):
    port = create_pose_model(NAME, K)
    ref = R.ViTPose(K, DEPTH, WIDTH, HEADS, RATE, RES)
    sd = _state(seed)
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    return port.to(dtype), ref.to(dtype)


def _images(dtype=torch.float32, n=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, RES, RES, generator=g).to(dtype)


# ------------------------------------------------------------ the network
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_reference(mode):
    """Heatmaps and the feature tap agree to 1e-5 in float32; in train
    mode with the same drop-path masks (one call counted on each side)."""
    port, ref = _pair()
    x = _images()
    port.train(mode == "train")
    ref.train(mode == "train")
    (p, f), (rp, rf) = port(x), ref(x)
    assert p.shape == (3, 1, K, RES // 4, RES // 4)
    assert f.shape == (3, 1, 256, RES // 8, RES // 8)
    assert _rel(p, rp) < TOL and _rel(f, rf) < TOL
    calls = int(mode == "train")
    assert int(port.drop_calls) == int(ref.drop_calls) == calls


def _loss(out):
    """A loss that weighs every heatmap and feature cell differently."""
    g = torch.Generator().manual_seed(2)
    p, f = out
    return sum((t * torch.randn(t.shape, generator=g).to(t.dtype)).sum()
               for t in (p, f))


def _grads(net, x):
    net.train()
    net.zero_grad()
    _loss(net(x)).backward()
    return {n: p.grad for n, p in net.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_gradient_matches_reference(dtype):
    """Every parameter's gradient of a train-mode step (drop path on)
    agrees leaf by leaf: to 1e-5 in float32, 1e-10 in float64.  The key
    bias, a third of each ``qkv.bias``, has a zero gradient in exact
    arithmetic (softmax is unchanged by a shift along the keys), so in
    float32 both sides hold rounding noise there: only float64 can hold
    it to zero, and does, to 1e-12 of the leaf."""
    port, ref = _pair(dtype)
    x = _images(dtype)
    got, want = _grads(port, x), _grads(ref, x)
    assert set(got) == set(want)
    tol = TOL if dtype == torch.float32 else 1e-10
    bad = {n: _rel(got[n], want[n]) for n in got
           if not _rel(got[n], want[n]) < tol}
    assert not bad
    if dtype == torch.float64:
        for i in range(DEPTH):
            g = got[f"blocks.{i}.attn.qkv.bias"]
            assert float(g[WIDTH:2 * WIDTH].abs().max()) < 1e-12 * float(
                g.norm())


def test_bf16_forward_fails_the_float32_tolerance():
    """The comparison sees precision: the network in bfloat16 misses the
    float32 reference by far more than the tolerance."""
    port, ref = _pair()
    x = _images()
    port.to(torch.bfloat16).eval()
    ref.eval()
    p, f = port(x.to(torch.bfloat16))
    rp, rf = ref(x)
    assert _rel(p.float(), rp) > 100 * TOL
    assert _rel(f.float(), rf) > 100 * TOL


# ------------------------------------------------------------- the masks
def _scales(salt, calls, grad, rows, depth=DEPTH, rate=RATE):
    rates = torch.tensor(torch.linspace(0.0, rate, depth).tolist())
    return drop_path_scales(torch.tensor([salt]), torch.tensor([calls]),
                            grad, rates, rows)


@pytest.mark.parametrize("case", ["same", "reference", "grad", "calls",
                                  "salt"])
def test_masks_are_a_function_of_state(case):
    """The same salt, counter and grad give the same masks, as the
    reference writes the rule; a teacher (no grad) and its student, the
    next call, and another network's salt draw others."""
    a = _scales(0.37, 5, True, 64)
    if case == "same":
        assert torch.equal(a, _scales(0.37, 5, True, 64))
    elif case == "reference":
        assert torch.equal(a, R.masks(torch.tensor([0.37]),
                                      torch.tensor([5]), True, DEPTH, RATE,
                                      64))
    else:
        b = {"grad": lambda: _scales(0.37, 5, False, 64),
             "calls": lambda: _scales(0.37, 6, True, 64),
             "salt": lambda: _scales(-0.37, 5, True, 64)}[case]()
        assert not torch.equal(a[1:], b[1:])
        assert torch.equal(a[0], b[0])          # block 0 never drops


def test_kept_share_per_block_within_three_sigma():
    """Over 4,096 rows each of ViTPose-H's 32 blocks keeps each branch's
    rows with probability 1 - p, within 3 standard deviations, and scales
    the kept ones by 1 / (1 - p)."""
    rows, depth = 4096, 32
    s = _scales(0.71, 3, True, rows, depth, 0.55)
    p = torch.linspace(0.0, 0.55, depth)
    kept = (s > 0).double().mean(-1)                  # [depth, 2]
    q = (1.0 - p.double())[:, None]
    sigma = torch.sqrt(q * (1.0 - q) / rows).clamp(min=1e-12)
    assert bool(((kept - q).abs() <= 3 * sigma).all())
    assert torch.allclose(s.amax(-1), (1.0 / (1.0 - p))[:, None].expand(
        depth, 2))


def test_eval_and_no_rate_draw_no_masks():
    """Eval mode and a zero drop-path rate leave the counter alone."""
    port, _ = _pair()
    port.eval()(_images())
    assert int(port.drop_calls) == 0
    port.drop_path_rate = 0.0
    port.train()(_images())
    assert int(port.drop_calls) == 0


# ------------------------------------------------------- sizes and serving
@pytest.mark.parametrize("name,width,depth,heads,rate,params", [
    ("ViTPose-B", 768, 12, 12, 0.3, 89.99e6),
    ("ViTPose-L", 1024, 24, 16, 0.5, 307.5e6),
    ("ViTPose-H", 1280, 32, 16, 0.55, 636.5e6)])
def test_published_sizes(name, width, depth, heads, rate, params):
    """The published widths, depths and heads, the MLP at 4x, drop path,
    the 256/256 head to K; built on the meta device (no memory)."""
    net = create_pose_model(name, 9, device="meta")
    blk = net.blocks[0]
    assert len(net.blocks) == depth and blk.attn.heads == heads
    assert blk.attn.qkv.weight.shape == (3 * width, width)
    assert blk.mlp.fc1.weight.shape == (4 * width, width)
    assert net.pos_embed.shape == (1, 257, width)
    assert net.deconv_layers[0].weight.shape == (width, 256, 4, 4)
    assert net.deconv_layers[3].weight.shape == (256, 256, 4, 4)
    assert net.final_layer.weight.shape == (9, 256, 1, 1)
    assert net.drop_path_rate == rate
    assert abs(param_count(net) - params) < 0.005 * params


def test_pose_estimator_serves_vitpose():
    """``PoseEstimator`` takes a ViTPose and its state dict and decodes
    the reference's eval maps."""
    port, ref = _pair()
    cfg = Config(model=NAME, inp_res=RES, out_res=RES // 4,
                 compute_dtype="float32")
    cfg.kps_count = K
    est = PoseEstimator(port, _state(0), (0.5, 0.5, 0.5), cfg, 4, "cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (3, RES, RES, 3),
                                             dtype=np.uint8)
    kps, scores = est.predict(imgs)
    x = C.normalize_images(torch.as_tensor(imgs), est.means)
    with torch.no_grad():
        maps = ref.eval()(x)[0][:, -1]
    assert kps.shape == (3, K, 2)
    assert np.allclose(scores, maps.flatten(-2).amax(-1).numpy(), atol=1e-5)


# ----------------------------------------------------------- the trainer
KW = dict(model=NAME, synthetic_data=True, synthetic_kps=K, inp_res=RES,
          out_res=RES // 4, train_count=12, valid_count=4, label_ratio=0.5,
          train_bs=4, train_bs_labeled=2, infer_bs=4, seed=5,
          pseudo_score_thr=0.0)


def _batches(tr, n):
    """``n`` batches of the trainer's sampler, over as many epochs as
    that takes."""
    out = []
    while len(out) < n:
        out += [np.asarray(b) for b in tr.make_sampler()]
    return out[:n]


def _trainer(device="cpu", **kw):
    return MTUBPLTrainer(Config(**{**KW, "compute_dtype": "float32", **kw}),
                         device=device)


def _forward_float64(model, images, train, compute_dtype, remat=False):
    model.train(train)
    return model(images.double())


def _with_reference_networks(tr):
    """``tr`` with the reference networks in place of its students and
    teachers (same states), and a fresh AdamW over them."""
    def swap(net):
        ref = R.ViTPose(K, DEPTH, WIDTH, HEADS, RATE, RES).to(
            next(net.parameters()).dtype)
        ref.load_state_dict(net.state_dict())
        return ref
    tr.students = [swap(s) for s in tr.students]
    tr.teachers = [swap(t).requires_grad_(False) for t in tr.teachers]
    tr.optimizer = torch.optim.AdamW(
        [p for s in tr.students for p in s.parameters()], lr=tr.cfg.lr,
        weight_decay=tr.cfg.wd)
    return tr


def test_trainer_step_equals_reference_networks_step(monkeypatch):
    """Two MT_UBPL steps through ``run_train_steps`` (teachers first, drop
    path in all four networks) against the same steps with the reference
    networks put in place: every metric, each student's and teacher's
    parameters and BatchNorm statistics, AdamW's moments and the
    counters agree.  In float64: Adam's first step divides each gradient
    by its own size, so a leaf whose gradient is rounding noise in float32
    (the key bias) would move by an amount rounding decides, up to the
    learning rate."""
    monkeypatch.setattr(C, "forward_heatmaps", _forward_float64)
    monkeypatch.setattr(MT, "forward_heatmaps", _forward_float64)
    port, ref = _trainer(), _trainer()
    for tr in (port, ref):
        for net in (*tr.students, *tr.teachers):
            net.double()
    _with_reference_networks(ref)
    batches = _batches(port, 2)
    sched = (3.0, 0.7, 0.8, 0.5)
    got = port.run_train_steps(batches, *sched)
    want = ref.run_train_steps(batches, *sched)
    for g, w in zip(got, want):
        for k in w:
            assert torch.allclose(g[k], w[k], rtol=1e-9, atol=1e-12), k
    assert any(float(v.abs().sum()) > 0 for k, v in got[0].items()
               if k in ("pec", "mtc", "fdc"))
    for a, b in zip((*port.students, *port.teachers),
                    (*ref.students, *ref.teachers)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        for k in sb:
            assert torch.allclose(sa[k].double(), sb[k].double(),
                                  rtol=1e-9, atol=1e-12), k
    for p, q in zip(port.optimizer.param_groups[0]["params"],
                    ref.optimizer.param_groups[0]["params"]):
        for k in ("exp_avg", "exp_avg_sq"):
            assert _rel(port.optimizer.state[p][k],
                        ref.optimizer.state[q][k]) < 1e-10, k
    # 2 steps x 4 networks x 2 views x 4 rows x 16 tokens; 16 mask sets
    assert (port.backbone_tokens, port.drop_path_draws) == (1024, 16)
    assert all(int(n.drop_calls) == 4 for n in (*port.students,
                                                *port.teachers))


def test_trainer_float32_first_step_within_tolerance():
    """In float32 the first step's metrics and gradients (AdamW's first
    moment over 1 - beta1) agree to 1e-5 with the reference networks'."""
    port, ref = _trainer(), _with_reference_networks(_trainer())
    batch = _batches(port, 1)
    sched = (3.0, 0.7, 0.8, 0.5)
    (got,), (want,) = (tr.run_train_steps(batch, *sched)
                       for tr in (port, ref))
    for k in want:
        assert _rel(got[k].double(), want[k].double()) < TOL or \
            torch.equal(got[k], want[k]), k
    for p, q in zip(port.optimizer.param_groups[0]["params"],
                    ref.optimizer.param_groups[0]["params"]):
        assert _rel(port.optimizer.state[p]["exp_avg"],
                    ref.optimizer.state[q]["exp_avg"]) < TOL


# ----------------------------------------------------------------- card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_matches_eager_on_card(dtype):
    """The test size, bs 4 over 4 steps: step 1 eager, step 2 captures,
    3 and 4 replay (fresh drop-path masks each, from the counters the
    graph advances); equal to the eager trainer bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    graphed, eager = (_trainer(dev, compute_dtype=dtype) for _ in range(2))
    assert graphed.step_graph.enabled
    eager.step_graph.enabled = False
    batches = _batches(graphed, 4)
    sched = (3.0, 0.7, 0.8, 0.5)
    got = [graphed.run_train_steps([b], *sched)[0] for b in batches]
    want = [eager.run_train_steps([b], *sched)[0] for b in batches]
    assert (graphed.eager_steps, graphed.graph_captures,
            graphed.graph_replays) == (1, 1, 3)
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    for a, b in zip((*graphed.students, *graphed.teachers),
                    (*eager.students, *eager.teachers)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
        assert int(a.drop_calls) == 8
    assert not math.isnan(float(got[-1]["pec"].sum()))
