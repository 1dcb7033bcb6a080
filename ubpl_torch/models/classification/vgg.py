"""CIFAR VGG with two FC heads and a feature tap.

Port of ``ubpl_tpu/models/classification/vgg.py`` (reference
models/classification/VGG.py).  NCHW, 32x32 inputs.  Every classifier of
this family returns ``(logits1, logits2)`` for ``mode="default"``, else
``((logits1, logits2), features)``: the tap after the first block, pooled
2x2 ("MaxPool", "AvgPool") or projected by a 1x1 conv ("ConvOne").

Submodules are registered in the order the flax module creates them, so
``models/weights.py`` can carry flax weights by walking the module.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Dense

CFG = {
    "VGG11": ([64, "M", 128, "M", 256, 256, "M", 512, 512], ["M", 512, 512, "M"]),
    "VGG13": ([64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512], ["M", 512, 512, "M"]),
    "VGG16": ([64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512], ["M", 512, 512, 512, "M"]),
    "VGG19": ([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512], ["M", 512, 512, 512, 512, "M"]),
}
FEATURE_MODES = ("default", "MaxPool", "AvgPool", "ConvOne")


def feature_tap(x, mode, project):
    """The family's feature tap of ``x`` (None for "default")."""
    if mode == "default":
        return None
    if mode == "MaxPool":
        return F.max_pool2d(x, 2, 2)
    if mode == "AvgPool":
        return F.avg_pool2d(x, 2, 2)
    return project(x)


def heads(x, fc1, fc2):
    """Flatten in flax's NHWC order, then the two linear heads."""
    x = torch.flatten(x.permute(0, 2, 3, 1), 1)
    return fc1(x), fc2(x)


def check_mode(mode):
    if mode not in FEATURE_MODES:
        raise ValueError(f"unknown feature mode {mode!r}; "
                         f"choices: {FEATURE_MODES}")


def _block(inp, cfg):
    """conv3x3 (+bias, zero-initialised as flax does) -> BN -> ReLU, and
    2x2 max pools at the "M" entries; returns (module, out channels)."""
    layers = []
    for p in cfg:
        if p == "M":
            layers.append(nn.MaxPool2d(2, 2))
            continue
        conv = nn.Conv2d(inp, p, 3, padding=1)
        nn.init.zeros_(conv.bias)
        layers += [conv, BatchNorm(p), nn.ReLU()]
        inp = p
    return nn.Sequential(*layers), inp


class VGG(nn.Module):
    def __init__(self, num_classes=10, model_type="VGG11", mode="default"):
        super().__init__()
        check_mode(mode)
        self.mode = mode
        c1, c2 = CFG[model_type]
        self.block1, ch = _block(3, c1)
        if mode == "ConvOne":
            self.project = nn.Conv2d(ch, 512, 1, bias=False)
        self.block2, ch = _block(ch, c2)
        self.fc1 = Dense(ch, num_classes)
        self.fc2 = Dense(ch, num_classes)

    def forward(self, x):
        x = self.block1(x)
        feat = feature_tap(x, self.mode, getattr(self, "project", None))
        out = heads(self.block2(x), self.fc1, self.fc2)
        return out if feat is None else (out, feat)
