"""LitePose: a large-kernel inverted-residual pose net.

Port of ``ubpl_tpu/models/litepose.py`` (reference models/pose/
LitePose.py): one stack, the arch2 MobileNet-style backbone, and a
deconv refine/loop head with two heatmap outputs, at 1/4 and 1/2 of the
input (64x64 and 128x128 at 256x256).  NCHW.  Returns the tuple of the two
maps ``[B, K, H, W]``, and for ``mode != "default"`` also the feature tap
``[B, 1, K, h, w]``: the first output, pooled 2x2 ("MaxPool", "AvgPool") or
as it is (any other mode), with a stack axis as the hourglass's features.

``ConvMobileBlock``'s middle conv is a dense k x k conv (no groups), as in
the JAX package.  The transposed convs are flax's SAME ones
(``layers.ConvTranspose``).  Submodules are registered in flax's creation
order (``models/weights.py``).
"""
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, ConvTranspose

ARCH2_CFG = (
    ((16, 24, 7, 2), (24, 24, 7, 1), (24, 24, 7, 1), (24, 24, 7, 1), (24, 24, 7, 1), (24, 24, 7, 1)),
    ((24, 64, 7, 2), (64, 64, 7, 1), (64, 64, 7, 1), (64, 64, 7, 1), (64, 64, 7, 1), (64, 64, 7, 1), (64, 64, 7, 1), (64, 64, 7, 1)),
    ((64, 64, 7, 2), (64, 64, 7, 1), (64, 72, 7, 1), (72, 72, 7, 1), (72, 72, 7, 1), (72, 72, 7, 1), (72, 72, 7, 1), (72, 72, 7, 1)),
    ((72, 72, 7, 1), (72, 80, 7, 1), (80, 100, 7, 1), (100, 120, 7, 1), (120, 140, 7, 1), (140, 140, 7, 1), (140, 140, 7, 1), (140, 140, 7, 1), (140, 140, 7, 1), (140, 160, 7, 1)),
)
DECONV_CHANNELS = (48, 24, 24)
DECONV_KERNELS = (4, 4, 4)


class ConvBNBase(nn.Module):
    """Reference ConvBlockBase: conv (no bias) -> BN -> optional ReLU6."""
    FLAX_SCOPE = "ConvBNBase"

    def __init__(self, inp, out, kernel_size, stride=1, activation=True):
        super().__init__()
        self.conv = nn.Conv2d(inp, out, kernel_size, stride,
                              kernel_size // 2, bias=False)
        self.bn = BatchNorm(out)
        self.activation = activation

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x.clamp(0.0, 6.0) if self.activation else x


class ConvMobileBlock(nn.Module):
    """Reference ConvMobileBlock: 1 - k - 1 inverted residual, with the
    skip where the shape is kept."""
    FLAX_SCOPE = "ConvMobileBlock"

    def __init__(self, inp, out, kernel_size, stride=1):
        super().__init__()
        mid = inp + out // 2
        self.conv1 = ConvBNBase(inp, mid, 1, activation=False)
        self.conv2 = ConvBNBase(mid, mid, kernel_size, stride,
                                activation=False)
        self.conv3 = ConvBNBase(mid, out, 1)
        self.residual = inp == out and stride == 1

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return y + x if self.residual else y


class _HeadLayer(nn.Module):
    """Level l of the head: the 2x deconv of the running map plus the 2x
    deconv of the backbone's matching checkpoint ("loop"); from level 1 on
    also the two 5x5 ConvBNBase pairs whose sum is an output."""

    def __init__(self, inp, loop_inp, out, kernel_size, raw_inp=None, k=0):
        super().__init__()
        self.deconv = ConvTranspose(inp, out, kernel_size)
        self.loop = ConvTranspose(loop_inp, out, kernel_size)
        self.final = raw_inp is not None
        if self.final:
            self.ff = nn.Sequential(ConvBNBase(out, out, 5),
                                    ConvBNBase(out, k, 5))
            self.fl = nn.Sequential(ConvBNBase(raw_inp, raw_inp, 5),
                                    ConvBNBase(raw_inp, k, 5))

    def forward(self, x, checkpoint, raw):
        x = self.deconv(x) + self.loop(checkpoint)
        return x, (self.ff(x) + self.fl(raw) if self.final else None)


class LitePose(nn.Module):
    def __init__(self, k, mode="default", arch=ARCH2_CFG):
        super().__init__()
        self.k, self.mode, self.n_stack = k, mode, 1
        self.stem = nn.Sequential(ConvBNBase(3, 32, 3, 2),
                                  ConvBNBase(32, 16, 3, 1))
        channels, stages, inp = [16], [], 16
        for stage in arch:
            blocks = []
            for (_, out, ksz, stride) in stage:
                blocks.append(ConvMobileBlock(inp, out, ksz, stride))
                inp = out
            stages.append(nn.Sequential(*blocks))
            channels.append(inp)
        self.stages = nn.ModuleList(stages)
        head = []
        for lvl, (ch, ksz) in enumerate(zip(DECONV_CHANNELS,
                                            DECONV_KERNELS)):
            raw = channels[-lvl - 3] if lvl > 0 else None
            head.append(_HeadLayer(inp, channels[-lvl - 2], ch, ksz, raw, k))
            inp = ch
        self.head = nn.ModuleList(head)

    def forward(self, x):
        x = self.stem(x)
        checkpoints = [x]
        for stage in self.stages:
            x = stage(x)
            checkpoints.append(x)
        outputs = []
        for lvl, layer in enumerate(self.head):
            raw = checkpoints[-lvl - 3] if lvl > 0 else None
            x, out = layer(x, checkpoints[-lvl - 2], raw)
            if out is not None:
                outputs.append(out)
        outputs = tuple(outputs)
        if self.mode == "default":
            return outputs
        feat = outputs[0]
        if self.mode == "MaxPool":
            feat = F.max_pool2d(feat, 2, 2)
        elif self.mode == "AvgPool":
            feat = F.avg_pool2d(feat, 2, 2)
        return outputs, feat[:, None]
