"""A network enters the benchmark by new files only: a toy network of
the layer kinds a transformer pose model has (a patch convolution, a
drawn position table, LayerNorm, attention through
``scaled_dot_product_attention``, two linear layers, a transposed
convolution), defined here and nowhere else, goes through the registry,
``weights.make_states``, the analytic flops and ``reference_steps``."""
from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark import weights as W
from benchmark.reference import nets, registry
from benchmark.runners.training import reference_steps

RES, DIM, HEADS, PATCH, K = 16, 16, 2, 4, 3


class ToyAttention(nets.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nets.Linear(dim, 3 * dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).view(B, N, 3, self.heads, C // self.heads) \
            .permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v).transpose(1, 2) \
            .reshape(B, N, C)


def attention_flops(mod, inp, out):
    """q k^T and (softmax) v: 2 x N x N x C each, over the heads."""
    _, N, C = inp[0].shape
    return 2 * 2 * N * N * C


class Toy(nets.Module):
    """Heatmap stacks [B, 1, K, 2h, 2w] and the tokens as features."""

    def __init__(self, k):
        super().__init__()
        n = (RES // PATCH) ** 2
        self.patch = nets.Conv(3, DIM, PATCH, stride=PATCH, padding=0)
        self.pos = nn.Parameter(torch.empty(1, n, DIM))
        self.norm = nn.LayerNorm(DIM)
        self.attn = ToyAttention(DIM, HEADS)
        self.fc = nets.Linear(DIM, DIM)
        self.up = nets.ConvTranspose(DIM, k, 4, stride=2, padding=1)

    def forward(self, x):
        t = self.patch(x)
        B, C, h, w = t.shape
        t = t.flatten(2).transpose(1, 2) + self.pos
        t = t + self.attn(self.norm(t))
        t = self.fc(t)
        maps = self.up(t.transpose(1, 2).reshape(B, C, h, w))
        return maps[:, None], t


TOY = registry.Network(
    "Toy", lambda arch, k: Toy(k), exact=True,
    drawn=lambda m: nets.drawn_layers(m) + [("pos", m.pos.shape, DIM)],
    products={ToyAttention: attention_flops})


@pytest.fixture
def toy():
    registry.register(TOY)
    yield
    registry.unregister(TOY)


def test_the_registry_builds_the_toy_beside_the_networks_it_found(toy):
    assert isinstance(nets.build("Toy", K), Toy)
    assert isinstance(nets.build("HG2", K), nets.StackedHourglass)
    assert isinstance(nets.build("ResNet18", 10), nets.ResNet18)
    with pytest.raises(ValueError, match="0 reference networks build"):
        nets.build("Toy2", K)


def test_a_clashing_entry_is_refused():
    """A new entry cannot change what an existing name builds: the same
    prefix again is refused when declared, a longer prefix or an exact
    name that overlaps it when looked up."""
    nets.build("HG2", K)                         # the package's entries
    with pytest.raises(ValueError, match="declare the prefix 'HG'"):
        registry.register(registry.Network("HG", lambda arch, k: Toy(k)))
    for clash in (registry.Network("HG2", lambda arch, k: Toy(k)),
                  registry.Network("HG2", lambda arch, k: Toy(k),
                                   exact=True)):
        registry.register(clash)
        try:
            with pytest.raises(ValueError,
                               match="2 reference networks build 'HG2'"):
                nets.build("HG2", K)
            assert isinstance(nets.build("HG3", K), nets.StackedHourglass)
        finally:
            registry.unregister(clash)
    assert isinstance(nets.build("HG2", K), nets.StackedHourglass)


def test_make_states_draws_what_the_entry_declares(toy):
    sd = W.make_states("Toy", K, 2, 5, torch.device("cpu"))
    net = Toy(K)
    assert set(sd[0]) == set(net.state_dict())
    net.load_state_dict(sd[0])
    bound = DIM ** -0.5
    assert 0 < float(sd[0]["pos"].abs().max()) <= bound
    assert not torch.equal(sd[0]["pos"], sd[1]["pos"])
    assert torch.equal(sd[0]["norm.weight"], torch.ones(DIM))
    assert torch.equal(sd[0]["norm.bias"], torch.zeros(DIM))
    # a transposed convolution's fan-in is one output's weight: out x k x k
    assert float(sd[0]["up.weight"].abs().max()) <= (K * 16) ** -0.5
    assert float(sd[0]["up.weight"].abs().max()) > (DIM * 16) ** -0.5


def counted(fn):
    with sdpa_kernel(SDPBackend.MATH), FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


def test_toy_flops_equal_the_counter(toy):
    net = Toy(K)
    net.load_state_dict(W.make_states("Toy", K, 1, 3,
                                      torch.device("cpu"))[0])
    x = torch.randn(2, 3, RES, RES)
    with torch.no_grad():
        assert counted(lambda: net(x)) == 2 * flops.forward_flops(
            "Toy", K, RES)

    def step():
        maps, feats = net(x)
        (maps.square().mean() + feats.square().mean()).backward()
    assert counted(step) == 2 * (flops.forward_flops("Toy", K, RES)
                                 + flops.backward_flops("Toy", K, RES))
    names = [n for n, _ in flops.layers("Toy", K, RES)]
    assert names == ["patch", "attn.qkv", "attn", "fc", "up"]


def test_reference_steps_train_the_toy(toy):
    cell = SimpleNamespace(
        config={"hyper": {"lr": 1e-3, "wd": 0.0}},
        traffic={"check_steps": 2, "schedule": {"ema_alpha": 0.5}})
    states = W.make_states("Toy", K, 2, 7, torch.device("cpu"))
    x = torch.randn(4, 3, RES, RES)

    def step_loss(i, students, teachers):
        with torch.no_grad():
            target = sum(t(x)[0] for t in teachers) / len(teachers)
        loss = sum((s(x)[0] - target - 0.1).square().mean()
                   for s in students)
        return loss, None, {"mse": [float(loss.detach())]}

    ref = reference_steps(cell, "Toy", K, states, torch.device("cpu"),
                          "fp32", step_loss)
    assert len(ref.losses) == 2 and ref.terms == {"mse": [ref.losses[0]]}
    assert ref.first_grads["s1.pos"] > 0
    assert set(ref.changes) == {f"{g}{m}.{n}" for g in "st" for m in (0, 1)
                                for n, _ in Toy(K).named_parameters()}
    assert ref.changes["s0.up.weight"] > 0 and ref.changes["t0.pos"] > 0
