"""ResNets: the ResNet18 visual encoder and ResNet-50/101/152 (port of
spatialaudiogen_tpu.models.resnet; reference
pyutils/tflib/models/image/resnet.py).

ResNet18 (resnet.py:110-249): plain two-conv residual blocks;
channel-changing stages take a 1x1 un-normalised, bias-free shortcut
conv. ResNet-50/101/152 (resnet.py:251-449): 1x1-3x3-1x1 bottleneck
blocks under the caffe names res2a..res5c (`b{i}` inside a stage of more
than 26 blocks), a BN'd 1x1 `branch1` shortcut on each stage's first
block, and the `fc1000` classifier. Both stop early at `truncate_at`; the
full networks end in a global mean and a linear classifier. BN runs on
batch statistics when `batch_stats` is True (the reference quirk, see
models.layers.BatchNorm), and updates its running averages when
`update_stats` is True (a train step). `dtype` is every conv's compute
dtype (models.layers). Tensors are NCHW, and so are the `ends` that
`return_ends=True` returns.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spatialaudiogen_tpu_torch.models.convert import (
    flatten,
    from_flax,
    nest,
    restore_tf_var_dict,
    to_flax,
)
from spatialaudiogen_tpu_torch.models.layers import (
    TRUNC_NORMAL_STD,
    Conv2D,
    init_weights,
    max_pool_same,
)

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


def _truncated(truncate_at: str | None, blocks: list) -> bool:
    """Whether the network built so far (conv1, then `blocks`) ends at
    `truncate_at`."""
    return truncate_at == "conv1" or (bool(blocks) and blocks[-1] == truncate_at)


def _init_head(head: nn.Linear | None, generator: torch.Generator) -> None:
    """flax.linen.Dense's default initialisers: lecun_normal kernel (a
    truncated normal of variance 1/fan_in), zero bias."""
    if head is not None:
        with torch.no_grad():
            std = (1.0 / head.in_features) ** 0.5 / TRUNC_NORMAL_STD
            nn.init.trunc_normal_(head.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            head.bias.zero_()


def _classify(head: nn.Linear, y, ends: dict, name: str):
    y = head(y.float().mean(dim=(2, 3)))
    ends[name] = y
    return y


class ResNet18(nn.Module):
    """(N, C, H, W) frames -> features at `truncate_at` (default conv5_2,
    the model's encoder: (N, 512, ceil(H/32), ceil(W/32))), or with
    truncate_at=None the global mean and the `fc` classifier, (N,
    num_classes). The truncated network holds no `fc`, so its state_dict
    keys are the encoder's alone."""

    def __init__(self, in_channels: int = 3, dtype=None, truncate_at: str | None = "conv5_2",
                 num_classes: int = 1000):
        super().__init__()
        self.truncate_at = truncate_at
        self.conv1 = _conv_bn(in_channels, FILTERS[0], 7, 2, True, dtype)
        self.blocks = []
        for stage_idx, stage in enumerate(STAGES):
            prev, feats = FILTERS[stage_idx], FILTERS[stage_idx + 1]
            for block_idx in (1, 2):
                if _truncated(truncate_at, self.blocks):
                    break
                name = f"{stage}_{block_idx}"
                self.add_module(name, DownsampleBlock(prev, feats, 2, dtype)
                                if block_idx == 1 and stage != "conv2"
                                else ResidualBlock(feats, dtype))
                self.blocks.append(name)
        if truncate_at is None:
            self.fc = nn.Linear(FILTERS[-1], num_classes)
        elif not _truncated(truncate_at, self.blocks):
            raise ValueError(f"unknown truncate_at {truncate_at!r}")

    def init_weights(self, generator: torch.Generator) -> "ResNet18":
        """The reference's conv initialisers (models.layers.init_weights) and
        flax's Dense initialisers for `fc`, from `generator`."""
        init_weights(self, generator)
        _init_head(getattr(self, "fc", None), generator)
        return self

    def forward(self, x, batch_stats: bool = True, update_stats: bool = False,
                return_ends: bool = False):
        ends = {}
        y = max_pool_same(self.conv1(x, batch_stats, update_stats), 3, 2)
        ends["conv1"] = y
        for name in self.blocks:
            y = getattr(self, name)(y, batch_stats, update_stats)
            ends[name] = y
        if hasattr(self, "fc"):
            y = _classify(self.fc, y, ends, "fc")
        return (y, ends) if return_ends else y


class BottleneckBlock(nn.Module):
    """1x1-3x3-1x1 bottleneck (resnet.py:33-41), every conv BN'd: a BN'd
    1x1 `branch1` shortcut when `b1` is given, else the identity; stride 2
    in branch2a and branch1 when `downsample`."""

    def __init__(self, in_channels: int, b2a: int, b2b: int, b2c: int,
                 b1: int | None = None, downsample: bool = False, dtype=None):
        super().__init__()
        s = 2 if downsample else 1
        self.branch1 = (_conv_bn(in_channels, b1, 1, s, False, dtype)
                        if b1 is not None else None)
        self.branch2a = _conv_bn(in_channels, b2a, 1, s, True, dtype)
        self.branch2b = _conv_bn(b2a, b2b, 3, 1, True, dtype)
        self.branch2c = _conv_bn(b2b, b2c, 1, 1, False, dtype)

    def forward(self, x, batch_stats: bool, update_stats: bool = False):
        shortcut = (self.branch1(x, batch_stats, update_stats)
                    if self.branch1 is not None else x)
        y = self.branch2a(x, batch_stats, update_stats)
        y = self.branch2b(y, batch_stats, update_stats)
        y = self.branch2c(y, batch_stats, update_stats)
        return F.relu(y + shortcut)


BOTTLENECK_WIDTHS = ((64, 64, 256), (128, 128, 512), (256, 256, 1024), (512, 512, 2048))


def block_name(stage_idx: int, block_idx: int, n_blocks: int) -> str:
    """Caffe names: res2a..res2c; a stage of more than 26 blocks (ResNet152's
    res4) switches to the msra style res4a, res4b1, res4b2, ..."""
    if n_blocks <= 26:
        letter = chr(ord("a") + block_idx)
    else:
        letter = "a" if block_idx == 0 else f"b{block_idx}"
    return f"res{stage_idx + 2}{letter}"


class ResNetBottleneck(nn.Module):
    """ResNet-50/101/152 (reference resnet.py:251-449): (N, C, H, W) ->
    features at `truncate_at` (a block name, or "conv1"), or with
    truncate_at=None the global mean and `fc1000`, (N, num_classes)."""

    def __init__(self, stage_blocks: tuple = (3, 4, 6, 3), truncate_at: str | None = None,
                 num_classes: int = 1000, in_channels: int = 3, dtype=None):
        super().__init__()
        self.conv1 = _conv_bn(in_channels, 64, 7, 2, True, dtype)
        self.blocks = []
        prev = 64
        for stage_idx, n_blocks in enumerate(stage_blocks):
            b2a, b2b, b2c = BOTTLENECK_WIDTHS[stage_idx]
            for block_idx in range(n_blocks):
                if _truncated(truncate_at, self.blocks):
                    break
                name = block_name(stage_idx, block_idx, n_blocks)
                first = block_idx == 0
                self.add_module(name, BottleneckBlock(
                    prev, b2a, b2b, b2c, b1=b2c if first else None,
                    downsample=first and stage_idx > 0, dtype=dtype))
                self.blocks.append(name)
                prev = b2c
        if truncate_at is None:
            self.fc1000 = nn.Linear(prev, num_classes)
        elif not _truncated(truncate_at, self.blocks):
            raise ValueError(f"unknown truncate_at {truncate_at!r}")

    def init_weights(self, generator: torch.Generator) -> "ResNetBottleneck":
        """The reference's conv initialisers (models.layers.init_weights) and
        flax's Dense initialisers for `fc1000`, from `generator`."""
        init_weights(self, generator)
        _init_head(getattr(self, "fc1000", None), generator)
        return self

    def forward(self, x, batch_stats: bool = True, update_stats: bool = False,
                return_ends: bool = False):
        ends = {}
        y = max_pool_same(self.conv1(x, batch_stats, update_stats), 3, 2)
        ends["conv1"] = y
        for name in self.blocks:
            y = getattr(self, name)(y, batch_stats, update_stats)
            ends[name] = y
        if hasattr(self, "fc1000"):
            y = _classify(self.fc1000, y, ends, "fc1000")
        return (y, ends) if return_ends else y


def ResNet50(**kw) -> ResNetBottleneck:
    return ResNetBottleneck(stage_blocks=(3, 4, 6, 3), **kw)


def ResNet101(**kw) -> ResNetBottleneck:
    return ResNetBottleneck(stage_blocks=(3, 4, 23, 3), **kw)


def ResNet152(**kw) -> ResNetBottleneck:
    return ResNetBottleneck(stage_blocks=(3, 8, 36, 3), **kw)


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
    return _restore_state(blob, state_dict, in_channels)


def _restore_state(tf_vars: dict, state_dict: dict, in_channels: int):
    """TF variable names -> a copy of `state_dict` through
    models.convert.restore_tf_var_dict. -> (state_dict, unmatched)."""
    variables, unmatched = restore_tf_var_dict(tf_vars, nest(to_flax(state_dict)),
                                               conv1_in_channels=in_channels)
    new = from_flax(flatten(variables))
    return {k: new[k].to(device=v.device, dtype=v.dtype) for k, v in state_dict.items()}, \
        unmatched


def load_caffe_style_npy(npy_or_dict, state_dict: dict, in_channels: int = 3):
    """ResNet-50/101/152 npy blobs keyed 'res2a_branch2a' / 'bn2a_branch2a' /
    'conv1' / 'bn_conv1' / 'fc1000' (reference resnet.py:43-106 layout)
    into a copy of a ResNetBottleneck's `state_dict`, the port's
    counterpart of spatialaudiogen_tpu.models.resnet.load_caffe_style_npy:
    the blob's names become TF variable names and go through
    models.convert.restore_tf_var_dict (fc1000's (in, out) kernel lands
    transposed in nn.Linear's (out, in) through models.convert.from_flax).
    -> (new state_dict, {unmatched TF name: shape})."""
    blob = load_npy_blob(npy_or_dict)
    tf_vars = {}
    for key, val in blob.items():
        if not isinstance(val, dict):
            continue
        if key.startswith("res"):
            scope = key.replace("_", "/", 1)              # res2a_branch2a -> res2a/branch2a
            tf_vars[f"{scope}/weights"] = val["weights"]
        elif key.startswith("bn") and key != "bn_conv1":
            scope = "res" + key[2:].replace("_", "/", 1)  # bn2a_branch2a -> res2a/branch2a
            tf_vars.update(_bn_vars(scope, val))
        elif key == "conv1":
            tf_vars["conv1/weights"] = val["weights"]
        elif key == "bn_conv1":
            tf_vars.update(_bn_vars("conv1", val))
        elif key == "fc1000":
            tf_vars["fc1000/weights"] = val["weights"]
            tf_vars["fc1000/biases"] = val["biases"]
    return _restore_state(tf_vars, state_dict, in_channels)


def _bn_vars(scope: str, val: dict) -> dict:
    return {f"{scope}/bn/gamma": val["scale"], f"{scope}/bn/beta": val["offset"],
            f"{scope}/bn/moving_mean": val["mean"],
            f"{scope}/bn/moving_variance": val["variance"]}
