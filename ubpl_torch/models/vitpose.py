"""ViTPose: a plain vision transformer with a deconvolution heatmap head
(Xu et al. 2022, "ViTPose: Simple Vision Transformer Baselines for Human
Pose Estimation", arXiv:2204.12484; configs/body/2d_kpt_sview_rgb_img/
topdown_heatmap/coco/ViTPose_*_coco_256x192.py of ViTAE-Transformer/
ViTPose).

Port-only: ``ubpl_tpu`` has no ViTPose, so there is no JAX parity test and
no carrying of flax or reference checkpoints (``models/weights.py``) for
it; ``tests/vitpose_reference.py`` is the plain float32 reference that the
tests hold it to.

With B images of R x R and N = (R/16)^2 tokens:

  * patch embedding: a 16 x 16 conv, stride 16, padding 2, 3 -> width;
    the grid flattened to tokens; ``x + pos_embed[:, 1:] +
    pos_embed[:, :1]`` (``pos_embed`` [1, 1 + N, width], no class token);
  * ``depth`` pre-LN blocks, ``x = x + dp(Attn(LN1(x)))``, ``x = x +
    dp(MLP(LN2(x)))``: LayerNorm eps 1e-6, attention through
    ``F.scaled_dot_product_attention`` (qkv with bias, heads of
    width / heads), MLP width -> 4 width -> width with exact (erf) GELU;
  * the last LayerNorm, the tokens back to [B, width, R/16, R/16];
  * the head: two [ConvTranspose2d 4x4 s2 p1 to 256, no bias ->
    BatchNorm -> ReLU], then a 1x1 conv (with bias) to K.

Returns heatmaps [B, 1, K, R/4, R/4] and, for ``mode != "default"``, the
head's last 256-channel feature pooled 2 x 2 ([B, 1, 256, R/8, R/8]), the
tap the UBPL feature decorrelation reads, as ``StackedHourglass`` does
with ``n_stack = 1``.

Departures from mmpose: the head's BatchNorm is the port's
``layers.BatchNorm`` (flax's biased running-variance update, shared with
the hourglass); drop path (``dp``, stochastic depth) draws its masks from
a counter-based hash of the network's own state (``drop_path_scales``),
not from the global generator, so that a CUDA graph replays fresh masks
and a reference reproduces them.

Drop path: block i drops each row's residual branch with probability
``linspace(0, drop_path_rate, depth)[i]``, independently for the attention
and the MLP branch, and scales kept rows by 1 / (1 - p); train mode only.
Each train-mode forward makes one set of masks for every block from
``drop_salt`` (a per-network float, drawn with the weights), the call
counter ``drop_calls`` (advanced once per forward, before any block runs,
so that a recomputed block sees the same masks) and whether grad is
enabled (an EMA teacher and its student, which share salt and counter,
draw apart).  Teachers run in train mode, so they drop too: Mean Teacher's
noise.  Neither buffer is a parameter: the EMA leaves them alone.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import span
from .layers import BatchNorm

FEATURE_MODES = ("default", "MaxPool", "AvgPool")
#: published sizes: name -> (width, depth, heads, drop_path_rate)
SIZES = {"ViTPose-B": (768, 12, 12, 0.3), "ViTPose-L": (1024, 24, 16, 0.5),
         "ViTPose-H": (1280, 32, 16, 0.55)}
PATCH, MLP_RATIO, HEAD_WIDTH, LN_EPS = 16, 4, 256, 1e-6

_M32 = 0xFFFFFFFF
#: odd multiplier under 2^31, so that a 32-bit value times it fits int64
_MUL = 0x45D9F3B


def parse_name(name):
    """(width, depth, heads, drop_path_rate, res) of a published name (its
    position table for 256 x 256 inputs), or of a test size
    ``ViTPose-<depth>x<width>x<heads>`` (ViTPose-H's drop path rate, 64 x 64
    inputs); None for any other name.  The name fixes the input side, so a
    reference network built from the name alone has the same table."""
    if name in SIZES:
        return (*SIZES[name], 256)
    if not name.startswith("ViTPose-"):
        return None
    try:
        depth, width, heads = (int(v) for v in name[8:].split("x"))
    except ValueError:
        return None
    return width, depth, heads, SIZES["ViTPose-H"][3], 64


def _grid(side):
    """Patches along a side of ``side`` pixels (16 x 16, stride 16,
    padding 2)."""
    return (side + 4 - PATCH) // PATCH + 1


def _mix(x):
    """A 32-bit integer hash of int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL) & _M32
    x = x ^ (x >> 16)
    x = (x * _MUL) & _M32
    return x ^ (x >> 16)


def drop_path_scales(salt, calls, grad, rates, rows):
    """[depth, 2, rows] float32 residual scales of one forward: 0 where
    row r of block i's branch j (0 attention, 1 MLP) is dropped, else
    1 / (1 - rates[i]).  A pure function of the salt's float32 bits, the
    call counter, ``grad`` and the position, in int64 device arithmetic
    (no host sync, the same on the CPU and the card)."""
    key = salt.float().view(torch.int32).long() & _M32
    key = _mix(_mix(key ^ _mix(calls & _M32)) ^ int(grad))
    depth = rates.shape[0]
    idx = torch.arange(depth * 2 * rows, device=salt.device)
    u = (_mix(_mix(idx ^ key)) >> 8).float() * 2.0 ** -24
    p = rates.float()[:, None, None]
    keep = u.view(depth, 2, rows) >= p
    return keep.float() / (1.0 - p)


def _sdpa_backends(dtype):
    """The attention kernels allowed on the card: flash (cuDNN where flash
    refuses the shape) for half precision, the memory-efficient kernel
    for float32; never the math backend, which builds the N x N maps."""
    from torch.nn.attention import SDPBackend
    if dtype in (torch.bfloat16, torch.float16):
        return [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION]
    return [SDPBackend.EFFICIENT_ATTENTION]


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v over [B, heads, N, d]; on the card
    through a pinned backend (``_sdpa_backends``)."""
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v)
    from torch.nn.attention import sdpa_kernel
    with sdpa_kernel(_sdpa_backends(q.dtype), set_priority=True):
        return F.scaled_dot_product_attention(q, k, v)


class Attention(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).view(B, N, 3, self.heads, C // self.heads) \
            .permute(2, 0, 3, 1, 4)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, width, hidden):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-LN transformer block; ``scales`` [2, B] (or None: no drop path)
    multiply the attention and the MLP branch row by row."""

    def __init__(self, width, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = Mlp(width, MLP_RATIO * width)

    def forward(self, x, scales=None):
        a = self.attn(self.norm1(x))
        x = x + (a if scales is None else a * scales[0][:, None, None])
        m = self.mlp(self.norm2(x))
        return x + (m if scales is None else m * scales[1][:, None, None])


class ViTPose(nn.Module):
    """ViTPose with ``depth`` blocks of ``width`` and ``heads`` heads (see
    the module docstring); ``res``: the input's side, which sizes
    ``pos_embed``.  Built under ``with torch.device(d)``, its weights are
    made and drawn on ``d``."""

    def __init__(self, k, depth=32, width=1280, heads=16, mode="AvgPool",
                 drop_path_rate=0.55, res=256):
        super().__init__()
        if mode not in FEATURE_MODES:
            raise ValueError(f"unknown feature mode {mode!r} for ViTPose "
                             f"({' | '.join(FEATURE_MODES)})")
        self.mode, self.n_stack = mode, 1
        self.width, self.drop_path_rate = width, drop_path_rate
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, width, PATCH, PATCH, padding=2)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + _grid(res) ** 2,
                                                  width))
        self.blocks = nn.ModuleList(Block(width, heads) for _ in range(depth))
        self.last_norm = nn.LayerNorm(width, eps=LN_EPS)
        layers, inp = [], width
        for _ in range(2):
            layers += [nn.ConvTranspose2d(inp, HEAD_WIDTH, 4, 2, 1,
                                          bias=False),
                       BatchNorm(HEAD_WIDTH), nn.ReLU()]
            inp = HEAD_WIDTH
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(HEAD_WIDTH, k, 1)
        self.register_buffer("drop_salt", torch.zeros(1))
        self.register_buffer("drop_calls", torch.zeros(1, dtype=torch.int64))
        # the float32 values of the CPU's linspace, wherever it is built
        self.register_buffer("drop_rates", torch.tensor(torch.linspace(
            0.0, drop_path_rate, depth, device="cpu").tolist()),
            persistent=False)
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self):
        """ViTPose's: linears and ``pos_embed`` truncated normal (std 0.02,
        at +-2) with zero biases, LayerNorm 1 / 0; the head's deconvolutions
        and last conv normal (std 0.001), its biases 0; the patch
        convolution PyTorch's default; a salt uniform on +-1."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        for m in (self.deconv_layers[0], self.deconv_layers[3],
                  self.final_layer):
            nn.init.normal_(m.weight, std=0.001)
        nn.init.zeros_(self.final_layer.bias)
        self.drop_salt.uniform_(-1.0, 1.0)

    def tokens(self, height, width):
        """Tokens per image through the blocks at an input of this size."""
        return _grid(height) * _grid(width)

    def forward(self, x):
        B = x.shape[0]
        scales = None
        if self.training and self.drop_path_rate > 0:
            scales = drop_path_scales(self.drop_salt, self.drop_calls,
                                      torch.is_grad_enabled(),
                                      self.drop_rates, B)
            self.drop_calls.add_(1)
        with span("vit.embed"):
            t = self.patch_embed.proj(x)
            h, w = t.shape[-2:]
            n = self.pos_embed.shape[1] - 1
            if h * w != n:
                raise ValueError(f"ViTPose's position table holds {n} "
                                 f"patches; a {x.shape[-2]} x {x.shape[-1]}"
                                 f" input makes {h * w}")
            t = t.flatten(2).transpose(1, 2)
            t = t + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        with span("vit.blocks"):
            for i, blk in enumerate(self.blocks):
                t = blk(t, None if scales is None else scales[i])
            t = self.last_norm(t)
        with span("vit.head"):
            feature = self.deconv_layers(
                t.transpose(1, 2).reshape(B, self.width, h, w))
            preds = self.final_layer(feature)[:, None]
            if self.mode == "default":
                return preds
            pool = F.avg_pool2d if self.mode == "AvgPool" else F.max_pool2d
            return preds, pool(feature, 2, 2)[:, None]

