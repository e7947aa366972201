"""ResNet18 visual encoder, truncated at conv5_2 (port of
spatialaudiogen_tpu.models.resnet.ResNet18; reference
pyutils/tflib/models/image/resnet.py:110-249).

Plain two-conv residual blocks; channel-changing stages take a 1x1
un-normalised, bias-free shortcut conv. BN runs on batch statistics when
`batch_stats` is True (the reference quirk, see models.layers.BatchNorm),
and updates its running averages when `update_stats` is True (a train
step). `dtype` is every conv's compute dtype (models.layers).
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F
from torch import nn

from spatialaudiogen_tpu_torch.models.convert import (
    flatten,
    from_flax,
    nest,
    restore_tf_var_dict,
    to_flax,
)
from spatialaudiogen_tpu_torch.models.layers import Conv2D, max_pool_same

STAGES = ("conv2", "conv3", "conv4", "conv5")
FILTERS = (64, 64, 128, 256, 512)


def _conv_bn(in_c, out_c, k, s, relu, dtype):
    return Conv2D(in_c, out_c, (k, k), (s, s), padding="SAME", use_bias=False,
                  use_batch_norm=True, activation=F.relu if relu else None, dtype=dtype)


class ResidualBlock(nn.Module):
    """Identity-shortcut block (resnet.py:233-249)."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv_1 = _conv_bn(channels, channels, 3, 1, True, dtype)
        self.conv_2 = _conv_bn(channels, channels, 3, 1, False, dtype)

    def forward(self, x, batch_stats: bool, update_stats: bool = False):
        y = self.conv_1(x, batch_stats, update_stats)
        y = self.conv_2(y, batch_stats, update_stats)
        return F.relu(y + x)


class DownsampleBlock(nn.Module):
    """Block with a shortcut that matches the new shape (resnet.py:205-231):
    a 1x1 conv when the channels change, else a VALID max-pool."""

    def __init__(self, in_channels: int, features: int, strides: int = 2, dtype=None):
        super().__init__()
        self.strides = strides
        self.shortcut = None
        if in_channels != features:
            self.shortcut = Conv2D(in_channels, features, (1, 1), (strides, strides),
                                   padding="SAME", use_bias=False, dtype=dtype)
        self.conv_1 = _conv_bn(in_channels, features, 3, strides, True, dtype)
        self.conv_2 = _conv_bn(features, features, 3, 1, False, dtype)

    def forward(self, x, batch_stats: bool, update_stats: bool = False):
        if self.shortcut is not None:
            shortcut = self.shortcut(x)
        elif self.strides == 1:
            shortcut = x
        else:
            shortcut = F.max_pool2d(x, self.strides, self.strides)
        y = self.conv_1(x, batch_stats, update_stats)
        y = self.conv_2(y, batch_stats, update_stats)
        return F.relu(y + shortcut)


class ResNet18(nn.Module):
    """(N, C, H, W) frames -> conv5_2 features (N, 512, ceil(H/32), ceil(W/32))."""

    def __init__(self, in_channels: int = 3, dtype=None):
        super().__init__()
        self.conv1 = _conv_bn(in_channels, FILTERS[0], 7, 2, True, dtype)
        self.blocks = []
        for stage_idx, stage in enumerate(STAGES):
            prev, feats = FILTERS[stage_idx], FILTERS[stage_idx + 1]
            first = (DownsampleBlock(prev, feats, 2, dtype) if stage != "conv2"
                     else ResidualBlock(feats, dtype))
            for name, block in ((f"{stage}_1", first),
                                (f"{stage}_2", ResidualBlock(feats, dtype))):
                self.add_module(name, block)
                self.blocks.append(name)

    def forward(self, x, batch_stats: bool, update_stats: bool = False):
        y = max_pool_same(self.conv1(x, batch_stats, update_stats), 3, 2)
        for name in self.blocks:
            y = getattr(self, name)(y, batch_stats, update_stats)
        return y


def load_npy_blob(npy_or_dict) -> dict:
    """A resnet18.npy path (a pickled dict) or the dict itself -> the dict."""
    if isinstance(npy_or_dict, dict):
        return npy_or_dict
    raw = np.load(npy_or_dict, allow_pickle=True)
    return raw.item() if hasattr(raw, "item") else dict(raw)


def load_npy_weights(npy_or_dict, state_dict: dict, in_channels: int = 3,
                     prefix: str = ""):
    """A reference-style resnet18.npy (flat TF variable names, reference
    resnet.py:238-249) into a copy of `state_dict`, the port's counterpart
    of spatialaudiogen_tpu.models.resnet.load_npy_weights: names prefixed
    with `prefix` (the encoder's scope, e.g. "video_encoder"), matched
    through models.convert.restore_tf_var_dict, conv1 kernels cut to their
    first `in_channels` input channels (reference resnet.py:49).
    -> (new state_dict, {unmatched npy name: shape})."""
    blob = load_npy_blob(npy_or_dict)
    if prefix:
        blob = {f"{prefix}/{k}": v for k, v in blob.items()}
    variables, unmatched = restore_tf_var_dict(blob, nest(to_flax(state_dict)),
                                               conv1_in_channels=in_channels)
    new = from_flax(flatten(variables))
    return {k: new[k].to(device=v.device, dtype=v.dtype) for k, v in state_dict.items()}, \
        unmatched
