"""CIFAR MobileNet-v1 with two heads and a feature tap after the
128-wide blocks.

Port of ``ubpl_tpu/models/classification/mobilenet.py`` (reference
models/classification/MobileNet.py): depthwise-separable blocks (a 3x3
conv with ``groups=inp``, then a 1x1), NCHW, 32x32 inputs; outputs as
``vgg.py`` describes.  Submodules are registered in flax's creation order
(``models/weights.py``).
"""
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Dense
from .vgg import check_mode, feature_tap, heads


def _conv_bn(inp, out, stride):
    return nn.Sequential(nn.Conv2d(inp, out, 3, stride, 1, bias=False),
                         BatchNorm(out), nn.ReLU())


def _conv_dw(inp, out, stride):
    return nn.Sequential(
        nn.Conv2d(inp, inp, 3, stride, 1, groups=inp, bias=False),
        BatchNorm(inp), nn.ReLU(),
        nn.Conv2d(inp, out, 1, bias=False), BatchNorm(out), nn.ReLU())


class MobileNet(nn.Module):
    def __init__(self, num_classes=10, mode="default"):
        super().__init__()
        check_mode(mode)
        self.mode = mode
        self.features1 = nn.Sequential(
            _conv_bn(3, 32, 2), _conv_dw(32, 64, 1), _conv_dw(64, 96, 2),
            _conv_dw(96, 96, 1), _conv_dw(96, 128, 2),
            _conv_dw(128, 128, 1))
        if mode == "ConvOne":
            self.project = nn.Conv2d(128, 128, 1, bias=False)
        self.features2 = nn.Sequential(
            _conv_dw(128, 256, 2), _conv_dw(256, 256, 1),
            _conv_dw(256, 512, 1))
        self.fc1 = Dense(512, num_classes)
        self.fc2 = Dense(512, num_classes)

    def forward(self, x):
        x = self.features1(x)
        feat = feature_tap(x, self.mode, getattr(self, "project", None))
        x = F.avg_pool2d(self.features2(x), 2, 2)
        out = heads(x, self.fc1, self.fc2)
        return out if feat is None else (out, feat)
