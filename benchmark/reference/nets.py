"""Plain PyTorch reference layers and networks: the Newell stacked
hourglass and the CIFAR ResNet18 with two heads and a feature tap, both
declared in ``NETWORKS`` (``registry``).

Written from the published architectures (Newell et al. 2016, "Stacked
Hourglass Networks"; He et al. 2016, "Deep Residual Learning") as the
semi-supervised pose code lays them out: the hourglass's pre-activation
bottleneck residual, depth-4 recursion, 1x1 merges between stacks and an
AvgPool feature tap; the CIFAR ResNet's 3x3 stride-1 stem, four stages of
basic blocks, the tap after stage 3 and two linear heads.  Attribute names
follow the reference checkpoints' keys, so one state dict of weights loads
into these modules and into the program's.

Precision: in ``"fp32"`` (the reference) every value is float32.  In
``"fp8"`` (the control) the network is computed in fp8 where the program
computes in bf16: every operand of a convolution or linear layer and the
output of every layer, BatchNorm, residual sum and pooling is rounded to
float8 with one scale per tensor (e4m3 forward, e5m2 for the gradient
flowing back through the same point), the arithmetic in between in
float32.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from .registry import Network, lookup

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x, dtype, top):
    """``x`` rounded to the float8 ``dtype`` with one scale for the whole
    tensor (its largest magnitude maps to ``top``), in ``x``'s dtype."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class Fp8Round(torch.autograd.Function):
    """e4m3 rounding forward, e5m2 rounding of the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Module(nn.Module):
    """A reference layer: ``rnd`` rounds a value in the control's
    precision and passes it unchanged in the reference's."""
    precision = "fp32"

    def rnd(self, x):
        if self.precision == "fp32":
            return x
        if self.precision == "fp8":
            return Fp8Round.apply(x)
        raise ValueError(f"unknown precision {self.precision!r}")


class Conv(Module):
    """A 2-d convolution with "same" padding for odd k."""

    def __init__(self, inp, out, k, stride=1, bias=True, padding=None):
        super().__init__()
        self.stride = stride
        self.padding = (k - 1) // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty(out, inp, k, k))
        self.bias = nn.Parameter(torch.empty(out)) if bias else None

    def forward(self, x):
        return self.rnd(F.conv2d(self.rnd(x), self.rnd(self.weight),
                                 self.bias, self.stride, self.padding))


class ConvTranspose(Module):
    """A 2-d transposed convolution; weight [in, out, k, k]."""

    def __init__(self, inp, out, k, stride=1, padding=0, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(inp, out, k, k))
        self.bias = nn.Parameter(torch.empty(out)) if bias else None

    def forward(self, x):
        return self.rnd(F.conv_transpose2d(
            self.rnd(x), self.rnd(self.weight), self.bias, self.stride,
            self.padding))


class Linear(Module):
    def __init__(self, inp, out):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out, inp))
        self.bias = nn.Parameter(torch.empty(out))

    def forward(self, x):
        return self.rnd(F.linear(self.rnd(x), self.rnd(self.weight),
                                 self.bias))


class BN(Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training:
            return self.rnd(F.batch_norm(x, None, None, self.weight,
                                         self.bias, True, 0.0, 1e-5))
        return self.rnd(F.batch_norm(x, self.running_mean, self.running_var,
                                     self.weight, self.bias, False, 0.0,
                                     1e-5))


#: layers with a weight: their flops are counted from it
WEIGHTED = (Conv, ConvTranspose, Linear)


def drawn_layers(model):
    """[(name, shape, fan_in)] of every weight and bias of the weighted
    layers, fan_in the elements of one output's weight (PyTorch's default
    initialisation of each)."""
    out = []
    for mname, m in model.named_modules():
        if isinstance(m, WEIGHTED):
            fan_in = m.weight[0].numel()
            for pname, p in m.named_parameters(recurse=False):
                out.append((f"{mname}.{pname}", p.shape, fan_in))
    return out


def set_precision(model, precision):
    for m in model.modules():
        if isinstance(m, Module):
            m.precision = precision
    return model


# ------------------------------------------------------------- hourglass
class ConvBlock(nn.Module):
    """conv (+bias) -> optional BN -> optional ReLU."""

    def __init__(self, inp, out, k=3, stride=1, bn=False, relu=True):
        super().__init__()
        self.conv = Conv(inp, out, k, stride)
        self.bn = BN(out) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class Residual(Module):
    """Pre-activation 1x1-3x3-1x1 bottleneck at half width, with a 1x1
    skip conv only where the width changes."""

    def __init__(self, inp, out):
        super().__init__()
        mid = out // 2
        self.bn1, self.conv1 = BN(inp), ConvBlock(inp, mid, 1, relu=False)
        self.bn2, self.conv2 = BN(mid), ConvBlock(mid, mid, 3, relu=False)
        self.bn3, self.conv3 = BN(mid), ConvBlock(mid, out, 1, relu=False)
        self.skip_layer = (ConvBlock(inp, out, 1, relu=False)
                           if inp != out else None)

    def forward(self, x):
        skip = x if self.skip_layer is None else self.skip_layer(x)
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        y = self.conv3(F.relu(self.bn3(y)))
        return self.rnd(y + skip)


class Hourglass(Module):
    def __init__(self, n, f):
        super().__init__()
        self.up1 = Residual(f, f)
        self.low1 = Residual(f, f)
        self.low2 = Hourglass(n - 1, f) if n > 1 else Residual(f, f)
        self.low3 = Residual(f, f)

    def forward(self, x):
        low = self.low3(self.low2(self.low1(F.max_pool2d(x, 2, 2))))
        return self.rnd(self.up1(x) + F.interpolate(low, scale_factor=2,
                                                    mode="nearest"))


class Merge(nn.Module):
    """1x1 conv between stacks, no BN, no ReLU."""

    def __init__(self, inp, out):
        super().__init__()
        self.conv = ConvBlock(inp, out, 1, relu=False)

    def forward(self, x):
        return self.conv(x)


class StackedHourglass(Module):
    """``n_stack`` depth-4 hourglasses at 256 features; returns heatmap
    stacks [B, S, K, H/4, W/4] and AvgPool feature stacks
    [B, S, 256, H/8, W/8]."""

    def __init__(self, k, n_stack=3, features=256):
        super().__init__()
        f = features
        self.n_stack = n_stack
        self.pre = nn.Sequential(ConvBlock(3, 64, 7, 2, bn=True),
                                 Residual(64, 128), nn.MaxPool2d(2, 2),
                                 Residual(128, 128), Residual(128, f))
        self.hgs = nn.ModuleList(nn.Sequential(Hourglass(4, f))
                                 for _ in range(n_stack))
        self.features = nn.ModuleList(
            nn.Sequential(Residual(f, f), ConvBlock(f, f, 1, bn=True))
            for _ in range(n_stack))
        self.preds = nn.ModuleList(ConvBlock(f, k, 1, relu=False)
                                   for _ in range(n_stack))
        self.merge_features = nn.ModuleList(Merge(f, f)
                                            for _ in range(n_stack - 1))
        self.merge_preds = nn.ModuleList(Merge(k, f)
                                         for _ in range(n_stack - 1))

    def forward(self, x):
        x = self.pre(x)
        preds, feats = [], []
        for i in range(self.n_stack):
            feature = self.features[i](self.hgs[i](x))
            feats.append(self.rnd(F.avg_pool2d(feature, 2, 2)))
            p = self.preds[i](feature)
            preds.append(p)
            if i < self.n_stack - 1:
                x = self.rnd(x + self.merge_preds[i](p)
                             + self.merge_features[i](feature))
        return torch.stack(preds, 1), torch.stack(feats, 1)


# ---------------------------------------------------------------- ResNet
class BasicBlock(Module):
    def __init__(self, inp, out, stride):
        super().__init__()
        self.conv1 = Conv(inp, out, 3, stride, bias=False)
        self.bn1 = BN(out)
        self.conv2 = Conv(out, out, 3, 1, bias=False)
        self.bn2 = BN(out)
        self.shortcut = None
        if stride != 1 or inp != out:
            self.shortcut = nn.Sequential(Conv(inp, out, 1, stride,
                                               bias=False), BN(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        s = x if self.shortcut is None else self.shortcut(x)
        return self.rnd(F.relu(y + s))


class ResNet18(Module):
    """CIFAR ResNet18: returns ((logits1, logits2), AvgPool tap of
    stage 3)."""

    def __init__(self, num_classes=10, blocks=(2, 2, 2, 2)):
        super().__init__()
        self.conv1 = Conv(3, 64, 3, 1, bias=False)
        self.bn1 = BN(64)
        inp, stages = 64, []
        for i, (ch, n) in enumerate(zip((64, 128, 256, 512), blocks)):
            layer = []
            for j in range(n):
                layer.append(BasicBlock(inp, ch, 2 if i > 0 and j == 0
                                        else 1))
                inp = ch
            stages.append(nn.Sequential(*layer))
        self.stages = nn.ModuleList(stages)
        self.fc1 = Linear(inp, num_classes)
        self.fc2 = Linear(inp, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        feat = None
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i == 2:
                feat = self.rnd(F.avg_pool2d(x, 2, 2))
        # flatten in channel-last order, as the two heads were laid out
        x = torch.flatten(self.rnd(F.avg_pool2d(x, 4, 4)).permute(0, 2, 3, 1),
                          1)
        return (self.fc1(x), self.fc2(x)), feat


NETWORKS = [
    Network("HG", lambda arch, k: StackedHourglass(k, int(arch[2:]))),
    Network("ResNet18", lambda arch, classes: ResNet18(classes), exact=True,
            off_loss_path=("fc2",)),
]


def build(arch, classes_or_kps):
    """The reference network ``arch`` (any name ``registry`` finds)."""
    return lookup(arch).build(arch, classes_or_kps)
