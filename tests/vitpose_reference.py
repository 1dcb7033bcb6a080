"""Plain reference of ViTPose for the port's tests: float32 (or whatever
dtype its weights are given), plain ``torch`` operations, written from the
paper and the published config without the port's code (it imports
neither ``ubpl_torch`` nor JAX).

ViTPose (Xu et al. 2022, arXiv:2204.12484; ViTAE-Transformer/ViTPose,
``configs/body/2d_kpt_sview_rgb_img/topdown_heatmap/coco/
ViTPose_huge_coco_256x192.py``): a 16 x 16 patch convolution (stride 16,
padding 2), ``x + pos_embed[:, 1:] + pos_embed[:, :1]``, pre-LN blocks
``x = x + dp(Attn(LN1(x)))``, ``x = x + dp(MLP(LN2(x)))`` (LayerNorm eps
1e-6; attention ``softmax(q k^T / sqrt(d)) v`` written out; MLP with the
erf GELU), the last LayerNorm, and the simple head: two [ConvTranspose
4x4 s2 p1 to 256, no bias, BatchNorm, ReLU], a 1x1 conv to K.  Its
parameter and buffer names are the port's, so one state dict loads into
both.

Departures from mmpose, each the port's too:

  * the outputs: heatmaps [B, 1, K, R/4, R/4] and the head's last
    256-channel feature average-pooled 2 x 2 [B, 1, 256, R/8, R/8] (the
    UBPL feature tap), as the stacked hourglass returns them;
  * the head's BatchNorm moves its running variance towards the biased
    batch variance (flax's update, the port's ``layers.BatchNorm``);
    normalisation in train mode uses batch statistics either way;
  * drop path draws its masks from a counter-based integer hash of the
    network's salt, its call counter, whether grad is enabled, and the
    block, branch and row, not from a global generator (``masks``, the
    rule as the benchmark's reference ``benchmark/reference/vitpose.py``
    writes it out apart from the port's code, imported from there so that
    the tests and the benchmark hold the port to one copy); teachers in
    train mode drop too;
  * the input is square (256 x 256 in the benchmark, not 256 x 192).
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.vitpose import masks


class Attn(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        B, N, C = x.shape
        d = C // self.heads
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        a = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d), dim=-1)
        return self.proj((a @ v).transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, width, hidden):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0))))


class Block(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = Attn(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = Mlp(width, 4 * width)

    def forward(self, x, s):
        x = x + self.attn(self.norm1(x)) * s[0][:, None, None]
        return x + self.mlp(self.norm2(x)) * s[1][:, None, None]


class BN(nn.Module):
    """BatchNorm with the biased running-variance update (momentum 0.1)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        shape = (1, -1, 1, 1)
        return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + 1e-5)
                * self.weight.view(shape) + self.bias.view(shape))


class ViTPose(nn.Module):
    def __init__(self, k, depth, width, heads, rate, res):
        super().__init__()
        grid = (res + 4 - 16) // 16 + 1
        self.depth, self.width, self.rate = depth, width, rate
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, width, 16, 16, padding=2)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, width))
        self.blocks = nn.ModuleList(Block(width, heads)
                                    for _ in range(depth))
        self.last_norm = nn.LayerNorm(width, eps=1e-6)
        self.deconv_layers = nn.Sequential(
            nn.ConvTranspose2d(width, 256, 4, 2, 1, bias=False), BN(256),
            nn.ReLU(), nn.ConvTranspose2d(256, 256, 4, 2, 1, bias=False),
            BN(256), nn.ReLU())
        self.final_layer = nn.Conv2d(256, k, 1)
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
        s = s.to(x.dtype)
        t = self.patch_embed.proj(x)
        h, w = t.shape[-2:]
        t = t.flatten(2).transpose(1, 2)
        t = t + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for i, blk in enumerate(self.blocks):
            t = blk(t, s[i])
        t = self.last_norm(t).transpose(1, 2).reshape(B, self.width, h, w)
        feature = self.deconv_layers(t)
        return (self.final_layer(feature)[:, None],
                F.avg_pool2d(feature, 2, 2)[:, None])
