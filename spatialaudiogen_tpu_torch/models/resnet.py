"""ResNet18 visual encoder, truncated at conv5_2 (port of
spatialaudiogen_tpu.models.resnet.ResNet18; reference
pyutils/tflib/models/image/resnet.py:110-249).

Plain two-conv residual blocks; channel-changing stages take a 1x1
un-normalised, bias-free shortcut conv. BN runs on batch statistics when
`batch_stats` is True (the reference quirk, see models.layers.BatchNorm).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from spatialaudiogen_tpu_torch.models.layers import Conv2D, max_pool_same

STAGES = ("conv2", "conv3", "conv4", "conv5")
FILTERS = (64, 64, 128, 256, 512)


def _conv_bn(in_c, out_c, k, s, relu):
    return Conv2D(in_c, out_c, (k, k), (s, s), padding="SAME", use_bias=False,
                  use_batch_norm=True, activation=F.relu if relu else None)


class ResidualBlock(nn.Module):
    """Identity-shortcut block (resnet.py:233-249)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_1 = _conv_bn(channels, channels, 3, 1, relu=True)
        self.conv_2 = _conv_bn(channels, channels, 3, 1, relu=False)

    def forward(self, x, batch_stats: bool):
        y = self.conv_2(self.conv_1(x, batch_stats), batch_stats)
        return F.relu(y + x)


class DownsampleBlock(nn.Module):
    """Block with a shortcut that matches the new shape (resnet.py:205-231):
    a 1x1 conv when the channels change, else a VALID max-pool."""

    def __init__(self, in_channels: int, features: int, strides: int = 2):
        super().__init__()
        self.strides = strides
        self.shortcut = None
        if in_channels != features:
            self.shortcut = Conv2D(in_channels, features, (1, 1), (strides, strides),
                                   padding="SAME", use_bias=False)
        self.conv_1 = _conv_bn(in_channels, features, 3, strides, relu=True)
        self.conv_2 = _conv_bn(features, features, 3, 1, relu=False)

    def forward(self, x, batch_stats: bool):
        if self.shortcut is not None:
            shortcut = self.shortcut(x)
        elif self.strides == 1:
            shortcut = x
        else:
            shortcut = F.max_pool2d(x, self.strides, self.strides)
        y = self.conv_2(self.conv_1(x, batch_stats), batch_stats)
        return F.relu(y + shortcut)


class ResNet18(nn.Module):
    """(N, C, H, W) frames -> conv5_2 features (N, 512, ceil(H/32), ceil(W/32))."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = _conv_bn(in_channels, FILTERS[0], 7, 2, relu=True)
        self.blocks = []
        for stage_idx, stage in enumerate(STAGES):
            prev, feats = FILTERS[stage_idx], FILTERS[stage_idx + 1]
            first = (DownsampleBlock(prev, feats, 2) if stage != "conv2"
                     else ResidualBlock(feats))
            for name, block in ((f"{stage}_1", first),
                                (f"{stage}_2", ResidualBlock(feats))):
                self.add_module(name, block)
                self.blocks.append(name)

    def forward(self, x, batch_stats: bool):
        y = max_pool_same(self.conv1(x, batch_stats), 3, 2)
        for name in self.blocks:
            y = getattr(self, name)(y, batch_stats)
        return y
