"""CIFAR ResNet with two heads and a feature tap after stage 3.

Port of ``ubpl_tpu/models/classification/resnet.py`` (reference
models/classification/ResNet.py): ``BasicBlock`` (ResNet18/34) and
``Bottleneck`` (ResNet50/101/152), NCHW, 32x32 inputs; outputs as
``vgg.py`` describes.  Submodules are registered in flax's creation order
(``models/weights.py``); ``_BN`` stands for the flax wrapper module of the
same name.
"""
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Dense
from .vgg import check_mode, feature_tap, heads

CFG = {
    "ResNet18": (2, 2, 2, 2),
    "ResNet34": (3, 4, 6, 3),
    "ResNet50": (3, 4, 6, 3),
    "ResNet101": (3, 4, 23, 3),
    "ResNet152": (3, 8, 36, 3),
}


class _BN(BatchNorm):
    FLAX_SCOPE = "_BN"


def _shortcut(inp, out, stride):
    """1x1 projection + BN where the shape changes, else None."""
    if stride == 1 and inp == out:
        return None
    return nn.Sequential(nn.Conv2d(inp, out, 1, stride, bias=False), _BN(out))


class BasicBlock(nn.Module):
    FLAX_SCOPE = "BasicBlock"
    expansion = 1

    def __init__(self, inp, out, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inp, out, 3, stride, 1, bias=False)
        self.bn1 = _BN(out)
        self.conv2 = nn.Conv2d(out, out, 3, 1, 1, bias=False)
        self.bn2 = _BN(out)
        self.shortcut = _shortcut(inp, out, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class Bottleneck(nn.Module):
    FLAX_SCOPE = "Bottleneck"
    expansion = 4

    def __init__(self, inp, out, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inp, out, 1, bias=False)
        self.bn1 = _BN(out)
        self.conv2 = nn.Conv2d(out, out, 3, stride, 1, bias=False)
        self.bn2 = _BN(out)
        self.conv3 = nn.Conv2d(out, out * 4, 1, bias=False)
        self.bn3 = _BN(out * 4)
        self.shortcut = _shortcut(inp, out * 4, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class ResNet(nn.Module):
    def __init__(self, num_classes=10, model_type="ResNet18",
                 mode="default"):
        super().__init__()
        check_mode(mode)
        self.mode = mode
        block = (BasicBlock if model_type in ("ResNet18", "ResNet34")
                 else Bottleneck)
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = _BN(64)
        inp, stages = 64, []
        for i, (ch, n) in enumerate(zip((64, 128, 256, 512),
                                        CFG[model_type])):
            blocks = []
            for j in range(n):
                blocks.append(block(inp, ch, 2 if i > 0 and j == 0 else 1))
                inp = ch * block.expansion
            stages.append(nn.Sequential(*blocks))
            if i == 2 and mode == "ConvOne":
                self.project = nn.Conv2d(inp, inp, 1, bias=False)
        self.stages = nn.ModuleList(stages)
        self.fc1 = Dense(inp, num_classes)
        self.fc2 = Dense(inp, num_classes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        feat = None
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i == 2:
                feat = feature_tap(x, self.mode,
                                   getattr(self, "project", None))
        out = heads(F.avg_pool2d(x, 4, 4), self.fc1, self.fc2)
        return out if feat is None else (out, feat)
