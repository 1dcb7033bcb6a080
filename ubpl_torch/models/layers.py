"""Layer library of the hourglass family (NCHW ``nn.Module``s).

Port of ``ubpl_tpu/models/layers.py`` (reference models/base/layers.py:
Conv :31-50, Residual :53-84, recursive Hourglass :87-111, Merge :123-130).
Module and attribute names follow the reference, so ``state_dict`` keys are
the reference checkpoints' keys.  The reference's dead same-width skip
convs (created but never run when ``inp_dim == out_dim``) are left out.

Initialisation is PyTorch's default, which the JAX package copies
(uniform(+-1/sqrt(fan_in)) for conv kernels and biases).  Where the JAX
package keeps flax's own defaults (the classification nets' ``nn.Dense``
heads and VGG's conv biases, LitePose's ``nn.ConvTranspose``), ``Dense``,
``flax_truncated_normal_`` and ``ConvTranspose`` draw from the same
distributions.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

# std of N(0, 1) truncated to [-2, 2] (flax variance_scaling's correction)
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis with the JAX package's running-stat
    update.

    flax ``nn.BatchNorm(momentum=0.9)`` (``ubpl_tpu/models/layers.py:51,69``)
    moves ``running_var`` towards the *biased* batch variance, while
    ``nn.BatchNorm2d`` uses the unbiased one; with n values per channel the
    two differ by n/(n-1) — a factor 2 at the hourglass's 1x1 level at
    bs 2.  The port is held against the JAX package, so it reproduces the
    biased update: cuDNN/ATen's fused update is run and then corrected,
    without a second pass over the activations.  Normalisation itself uses
    the biased variance in both frameworks.  Eval mode uses the stored
    running stats and is unaffected.

    ``update_stats=False`` (set while ``torch.utils.checkpoint`` recomputes
    a forward) normalises with batch statistics but leaves the running
    stats alone, so a recomputed forward does not update them twice.
    """

    def __init__(self, num_features, momentum=0.1, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        # the op updates a copy: the buffer it saves for backward must not
        # be modified afterwards.  A recompute runs the same op (it must
        # save the same tensors) on throwaway copies.
        mean = (self.running_mean if self.update_stats
                else self.running_mean.clone())
        new_var = self.running_var.clone()
        y = F.batch_norm(x, mean, new_var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            # new = (1-m) old + m var_unbiased; want (1-m) old + m var_biased
            # = new - (new - (1-m) old) / n
            self.running_var.copy_(new_var - (
                new_var - (1.0 - self.momentum) * self.running_var) / n)
        return y


class ConvBlock(nn.Module):
    """Reference Conv: conv(+bias) -> optional BN -> optional ReLU."""

    def __init__(self, inp_dim, out_dim, kernel_size=3, stride=1, bn=False,
                 relu=True):
        super().__init__()
        self.conv = nn.Conv2d(inp_dim, out_dim, kernel_size, stride,
                              padding=(kernel_size - 1) // 2, bias=True)
        self.bn = BatchNorm(out_dim) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.relu:
            x = F.relu(x)
        return x


class Residual(nn.Module):
    """Reference Residual: pre-activation BN-ReLU 1-3-1 bottleneck + skip;
    the 1x1 skip conv exists only where the width changes."""

    def __init__(self, inp_dim, out_dim):
        super().__init__()
        mid = out_dim // 2
        self.bn1 = BatchNorm(inp_dim)
        self.conv1 = ConvBlock(inp_dim, mid, 1, relu=False)
        self.bn2 = BatchNorm(mid)
        self.conv2 = ConvBlock(mid, mid, 3, relu=False)
        self.bn3 = BatchNorm(mid)
        self.conv3 = ConvBlock(mid, out_dim, 1, relu=False)
        self.skip_layer = (ConvBlock(inp_dim, out_dim, 1, relu=False)
                           if inp_dim != out_dim else None)

    def forward(self, x):
        residual = x if self.skip_layer is None else self.skip_layer(x)
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        return out + residual


class Hourglass(nn.Module):
    """Reference recursive Hourglass(n, f): down path, recursion, 2x
    nearest upsample, sum with the skip branch."""

    def __init__(self, n, f, increase=0):
        super().__init__()
        nf = f + increase
        self.up1 = Residual(f, f)
        self.low1 = Residual(f, nf)
        self.low2 = Hourglass(n - 1, nf) if n > 1 else Residual(nf, nf)
        self.low3 = Residual(nf, f)

    def forward(self, x):
        up1 = self.up1(x)
        low = self.low3(self.low2(self.low1(F.max_pool2d(x, 2, 2))))
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")


class Merge(nn.Module):
    """Reference Merge: 1x1 conv, no BN, no ReLU."""

    def __init__(self, x_dim, y_dim):
        super().__init__()
        self.conv = ConvBlock(x_dim, y_dim, 1, relu=False, bn=False)

    def forward(self, x):
        return self.conv(x)


def flax_truncated_normal_(tensor, std, generator=None):
    """flax ``variance_scaling(..., "truncated_normal")``: N(0, 1) truncated
    to [-2, 2], scaled so that the result's std is ``std``."""
    s = std / _TRUNC_STD
    return nn.init.trunc_normal_(tensor, 0.0, s, -2.0 * s, 2.0 * s,
                                 generator=generator)


class Dense(nn.Linear):
    """flax ``nn.Dense`` defaults: lecun_normal kernel (truncated normal,
    variance 1/fan_in), zero bias."""

    def reset_parameters(self):
        flax_truncated_normal_(self.weight, self.in_features ** -0.5)
        nn.init.zeros_(self.bias)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(2, 2),
    padding="SAME", use_bias=False)`` for an even k.

    ``lax.conv_transpose`` pads the 2x-dilated input by k/2 on each side
    and correlates it with the kernel as stored (no flip): that is
    ``ConvTranspose2d(padding=k/2 - 1)`` with the kernel flipped in both
    spatial axes (``models/weights.py`` flips it when carrying flax
    weights).  Kernels are drawn as the JAX package's
    ``torch_kernel_init`` does on flax's [k, k, in, out] kernel:
    uniform(+-1/sqrt(k * k * in)); ``nn.ConvTranspose2d``'s own default
    would take the fan from ``out``."""

    def __init__(self, inp_dim, out_dim, kernel_size):
        if kernel_size % 2:
            raise ValueError("SAME transposed conv at stride 2 needs an "
                             f"even kernel, not {kernel_size}")
        super().__init__(inp_dim, out_dim, kernel_size, stride=2,
                         padding=kernel_size // 2 - 1, bias=False)

    def reset_parameters(self):
        bound = (self.in_channels * self.kernel_size[0]
                 * self.kernel_size[1]) ** -0.5
        nn.init.uniform_(self.weight, -bound, bound)
