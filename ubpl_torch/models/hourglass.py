"""Stacked hourglass heatmap-regression model.

Port of ``ubpl_tpu/models/hourglass.py`` (reference models/pose/
hourglass.py).  NCHW; returns heatmap stacks ``[B, S, K, H, W]`` and, for
``mode != "default"``, projected feature stacks ``[B, S, 256, H/2, W/2]``
for the UBPL feature-decorrelation loss.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvBlock, Hourglass, Merge, Residual

FEATURE_MODES = ("default", "MaxPool", "AvgPool", "ConvOne")


class StackedHourglass(nn.Module):
    """Newell stacked hourglass.

    k: #joints; n_stack: #stacks ("HG3" -> 3); mode: feature tap
    "default" (no features) | "MaxPool" | "AvgPool" | "ConvOne".  The
    reference's ConvOne declares a 128-channel conv that cannot run on the
    256-channel features; as in the JAX package, the port runs a 256-channel
    1x1 conv (``project.{i}``, a key reference checkpoints do not have).
    """

    def __init__(self, k, n_stack=3, mode="AvgPool"):
        super().__init__()
        if mode not in FEATURE_MODES:
            raise ValueError(f"unknown feature mode {mode!r}")
        self.k, self.n_stack, self.mode = k, n_stack, mode
        self.pre = nn.Sequential(
            ConvBlock(3, 64, 7, 2, bn=True, relu=True),
            Residual(64, 128),
            nn.MaxPool2d(2, 2),
            Residual(128, 128),
            Residual(128, 256))
        self.hgs = nn.ModuleList(
            nn.Sequential(Hourglass(4, 256, 0)) for _ in range(n_stack))
        self.features = nn.ModuleList(
            nn.Sequential(Residual(256, 256),
                          ConvBlock(256, 256, 1, bn=True, relu=True))
            for _ in range(n_stack))
        if mode == "ConvOne":
            self.project = nn.ModuleList(
                ConvBlock(256, 256, 1, relu=False) for _ in range(n_stack))
        self.preds = nn.ModuleList(
            ConvBlock(256, k, 1, relu=False, bn=False)
            for _ in range(n_stack))
        self.merge_features = nn.ModuleList(
            Merge(256, 256) for _ in range(n_stack - 1))
        self.merge_preds = nn.ModuleList(
            Merge(k, 256) for _ in range(n_stack - 1))

    def _project(self, i, feature):
        if self.mode == "MaxPool":
            return F.max_pool2d(feature, 2, 2)
        if self.mode == "AvgPool":
            return F.avg_pool2d(feature, 2, 2)
        return self.project[i](feature)

    def forward(self, imgs):
        x = self.pre(imgs)
        preds_all, feats_all = [], []
        for i in range(self.n_stack):
            feature = self.features[i](self.hgs[i](x))
            if self.mode != "default":
                feats_all.append(self._project(i, feature))
            preds = self.preds[i](feature)
            preds_all.append(preds)
            if i < self.n_stack - 1:
                x = x + self.merge_preds[i](preds) + \
                    self.merge_features[i](feature)
        preds = torch.stack(preds_all, 1)
        if self.mode == "default":
            return preds
        return preds, torch.stack(feats_all, 1)
