"""Plain PyTorch reference of ViTPose, declared in ``NETWORKS``
(``registry``): "ViTPose-B", "-L", "-H" at their published sizes for
256 x 256 inputs, and test sizes "ViTPose-<depth>x<width>x<heads>" (drop
path 0.55, 64 x 64 inputs).

Written from Xu et al. 2022 ("ViTPose", arXiv:2204.12484) and its config
``configs/body/2d_kpt_sview_rgb_img/topdown_heatmap/coco/
ViTPose_huge_coco_256x192.py`` (ViTAE-Transformer/ViTPose): a 16 x 16
patch convolution (stride 16, padding 2), ``x + pos_embed[:, 1:] +
pos_embed[:, :1]``, pre-LN blocks ``x = x + dp(Attn(LN1(x)))``, ``x = x +
dp(MLP(LN2(x)))`` (LayerNorm eps 1e-6; attention ``softmax(q k^T /
sqrt(d)) v`` written out, heads of width / heads; MLP 4x with the erf
GELU), the last LayerNorm, the simple head (two [ConvTranspose 4x4 s2 p1
to 256, no bias, BatchNorm, ReLU], a 1x1 conv to K).  Outputs: heatmaps
[B, 1, K, R/4, R/4] and the head's last feature average-pooled 2 x 2
[B, 1, 256, R/8, R/8].  Attribute names are the program's, so one state
dict loads into both.

Departures from mmpose, the program's too: square inputs (256 x 256,
not 256 x 192); drop path's masks from a counter-based integer hash of the
network's ``drop_salt``, its call counter ``drop_calls``, whether grad is
enabled and the block, branch and row (``masks``), written out here again;
teachers in train mode drop as well.  The BatchNorm is ``nets.BN`` (batch
statistics in train mode).

In train mode with grad, each block is recomputed in the backward
(``torch.utils.checkpoint``, exact), so that the fp32 reference of four
ViTPose-H networks and their AdamW fits on one card beside the check's
inputs.  Precision as ``nets``: in ``"fp8"`` the operands of every product
(q, k, v, the probabilities) and the output of every layer, LayerNorm,
GELU and residual sum are rounded to float8.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import nets
from .registry import Network

M32, MUL = 0xFFFFFFFF, 0x45D9F3B
SIZES = {"ViTPose-B": (768, 12, 12, 0.3), "ViTPose-L": (1024, 24, 16, 0.5),
         "ViTPose-H": (1280, 32, 16, 0.55)}


def mix(x):
    """A 32-bit integer hash of int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * MUL) & M32
    x = x ^ (x >> 16)
    x = (x * MUL) & M32
    return x ^ (x >> 16)


def masks(salt, calls, grad, depth, rate, rows):
    """[depth, 2, rows] residual scales: row r of block i's branch j (0
    attention, 1 MLP) is dropped (0) where its uniform, the top 24 bits
    of ``mix(mix(position ^ key))`` over 2^24, falls under
    ``linspace(0, rate, depth)[i]``, else kept at 1 / (1 - p); key =
    ``mix(mix(salt's float32 bits ^ mix(calls)) ^ grad)``."""
    key = salt.float().view(torch.int32).long() & M32
    key = mix(mix(key ^ mix(calls & M32)) ^ (1 if grad else 0))
    pos = torch.arange(depth * 2 * rows, device=salt.device)
    u = (mix(mix(pos ^ key)) >> 8).float() / 2 ** 24
    p = torch.linspace(0.0, rate, depth).to(salt.device)[:, None, None]
    return (u.view(depth, 2, rows) >= p).float() / (1.0 - p)


class LayerNorm(nets.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return self.rnd(F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                                     1e-6))


class AttentionCore(nets.Module):
    """softmax(q k^T / sqrt(d)) v over [B, heads, N, d]: the two products
    of activations that ``products`` counts."""

    def forward(self, q, k, v):
        q, k, v = self.rnd(q), self.rnd(k), self.rnd(v)
        a = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(q.shape[-1]),
                          dim=-1)
        return self.rnd(self.rnd(a) @ v)


def attention_flops(mod, inp, out):
    """q k^T and the probabilities times v: 2 x N x N x d each, over the
    heads (4 N^2 width per image)."""
    _, heads, n, d = inp[0].shape
    return 4 * n * n * heads * d


class Attn(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nets.Linear(width, 3 * width)
        self.core = AttentionCore()
        self.proj = nets.Linear(width, width)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return self.proj(self.core(q, k, v).transpose(1, 2)
                         .reshape(B, N, C))


class Mlp(nets.Module):
    def __init__(self, width, hidden):
        super().__init__()
        self.fc1 = nets.Linear(width, hidden)
        self.fc2 = nets.Linear(hidden, width)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(self.rnd(0.5 * h * (1.0 + torch.erf(
            h / math.sqrt(2.0)))))


class Block(nets.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = Attn(width, heads)
        self.norm2 = LayerNorm(width)
        self.mlp = Mlp(width, 4 * width)

    def forward(self, x, s):
        x = self.rnd(x + self.attn(self.norm1(x)) * s[0][:, None, None])
        return self.rnd(x + self.mlp(self.norm2(x)) * s[1][:, None, None])


class ViTPose(nets.Module):
    def __init__(self, k, depth, width, heads, rate, res):
        super().__init__()
        grid = (res + 4 - 16) // 16 + 1
        self.depth, self.width, self.rate = depth, width, rate
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nets.Conv(3, width, 16, stride=16, padding=2)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, width))
        self.blocks = nn.ModuleList(Block(width, heads)
                                    for _ in range(depth))
        self.last_norm = LayerNorm(width)
        self.deconv_layers = nn.Sequential(
            nets.ConvTranspose(width, 256, 4, stride=2, padding=1,
                               bias=False), nets.BN(256), nn.ReLU(),
            nets.ConvTranspose(256, 256, 4, stride=2, padding=1, bias=False),
            nets.BN(256), nn.ReLU())
        self.final_layer = nets.Conv(256, k, 1)
        self.register_buffer("drop_salt", torch.zeros(1))
        self.register_buffer("drop_calls", torch.zeros(1, dtype=torch.int64))

    def forward(self, x):
        B = x.shape[0]
        if self.training:
            s = masks(self.drop_salt, self.drop_calls,
                      torch.is_grad_enabled(), self.depth, self.rate, B)
            self.drop_calls += 1
        else:
            s = torch.ones(self.depth, 2, B, device=x.device)
        t = self.patch_embed.proj(x)
        h, w = t.shape[-2:]
        t = t.flatten(2).transpose(1, 2)
        t = self.rnd(t + self.pos_embed[:, 1:] + self.pos_embed[:, :1])
        recompute = self.training and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            t = (checkpoint(blk, t, s[i], use_reentrant=False) if recompute
                 else blk(t, s[i]))
        t = self.last_norm(t).transpose(1, 2).reshape(B, self.width, h, w)
        feature = self.deconv_layers(t)
        return (self.final_layer(feature)[:, None],
                self.rnd(F.avg_pool2d(feature, 2, 2))[:, None])


def build(arch, k):
    """ViTPose ``arch``: a published name (256 x 256 inputs) or a test size
    (64 x 64)."""
    if arch in SIZES:
        width, depth, heads, rate = SIZES[arch]
        return ViTPose(k, depth, width, heads, rate, 256)
    depth, width, heads = (int(v) for v in arch[len("ViTPose-"):].split("x"))
    return ViTPose(k, depth, width, heads, SIZES["ViTPose-H"][3], 64)


NETWORKS = [Network(
    "ViTPose", build,
    drawn=lambda m: nets.drawn_layers(m) + [
        ("pos_embed", m.pos_embed.shape, m.width),
        ("drop_salt", m.drop_salt.shape, 1)],
    products={AttentionCore: attention_flops})]
