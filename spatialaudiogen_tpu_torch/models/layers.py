"""Layer wrappers with the reference library's conventions (port of
spatialaudiogen_tpu.models.layers).

Each wrapper holds one torch layer under the child name the Flax module
uses (`dense`, `conv`, `bn`, `deconv`), so state_dict keys are the Flax
variable paths with '.' for '/' (models.convert maps between the two).
Tensors are NCHW; the conventions that matter for parity:

  * Conv2D "SAME" is TensorFlow's: at stride 2 the padding is asymmetric
    (more at the end), so it is applied with an explicit F.pad;
  * Deconv2D is the VALID transposed conv, out = in*stride + k - stride
    (core.py:137-140); the JAX kernel is an unflipped lhs-dilated conv,
    so conv_transpose2d gets the spatially flipped kernel (models.convert);
  * BatchNorm has eps 1e-3 and normalises with the biased batch variance
    when running on batch statistics; in a train step it updates its
    running averages with Flax's momentum 0.99 and the biased variance;
  * `l2_regularization` is TF's l2_regularizer sum over kernels only;
  * `dtype` is Flax's: None computes in the input's dtype, torch.bfloat16
    casts the input, kernel and bias to bfloat16 for the product while the
    parameters stay float32; BatchNorm takes its statistics and normalises
    in float32 and returns its input's dtype (layers.py:51-90);
  * under data parallelism (parallel.mesh.shard_model) BatchNorm takes its
    moments over the data group's global batch, and a tensor-parallel Dense
    holds a slice of its output units (see each class).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from spatialaudiogen_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to_group,
    gather_last_dim,
)

# Standard deviation of a unit normal truncated at +-2
TRUNC_NORMAL_STD = 0.87962566103423978


def cast(x: torch.Tensor | None, dtype: torch.dtype | None) -> torch.Tensor | None:
    """x in the compute dtype: unchanged when dtype is None."""
    return x if dtype is None or x is None else x.to(dtype)


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 widened to float32; float32 and float64 unchanged."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow "SAME" (before, after) padding of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    (h0, h1) = same_pads(x.shape[2], kernel[0], strides[0])
    (w0, w1) = same_pads(x.shape[3], kernel[1], strides[1])
    if h0 == h1 == w0 == w1 == 0:
        return x
    return F.pad(x, (w0, w1, h0, h1), value=value)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """nn.max_pool(..., padding="SAME"): pads with -inf."""
    return F.max_pool2d(pad_same(x, (k, k), (s, s), value=float("-inf")), k, s)


class Dense(nn.Module):
    """fully_connected parity: matmul over the last axis, any input rank.

    With `tp_group` set (parallel.mesh.shard_model) the layer holds this
    rank's rows of the weight and bias, a contiguous slice of the output
    units, and runs column parallel: the outputs of the group are gathered
    in rank order, and the input's gradient is summed over the group."""

    def __init__(self, in_features: int, features: int,
                 activation: Callable | None = None, use_bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dense = nn.Linear(in_features, features, bias=use_bias)
        self.activation = activation
        self.dtype = dtype
        self.tp_group = None

    def forward(self, x):
        d = self.dtype
        x = copy_to_group(x, self.tp_group)
        y = F.linear(cast(x, d), cast(self.dense.weight, d), cast(self.dense.bias, d))
        y = gather_last_dim(y, self.tp_group)
        return self.activation(y) if self.activation else y


class BatchNorm(nn.Module):
    """BatchNorm with TF-contrib numerics (eps 1e-3, biased batch variance).

    `batch_stats=True` normalises with the statistics of the batch it is
    given, as the reference does in its visual encoders even at eval
    (model.py:388); False uses the stored running averages. With
    `update_stats=True` (a train step) it also moves the running averages
    toward the batch's, as the Flax module does when its batch_stats
    collection is mutable (layers.py:78-90): ra = m*ra + (1-m)*batch with
    m = 0.99 and the biased variance. (F.batch_norm's own update stores the
    unbiased variance and takes the complementary momentum, so it is not
    used.) A bfloat16 input is normalised with float32 statistics and
    parameters and comes back bfloat16, as the Flax module's does.
    """

    def __init__(self, features: int, epsilon: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.group = None

    def _global_moments(self, x):
        """(mean, biased variance) over the group's global batch, float32."""
        xf = at_least_float32(x)
        axes = (0, 2, 3)
        local = torch.cat([xf.sum(dim=axes), xf.new_full((1,), xf.numel() / xf.shape[1])])
        total = all_reduce_sum(local, self.group)
        count = total[-1].detach()
        mean = total[:-1] / count
        centred = xf - mean[None, :, None, None]
        var = all_reduce_sum((centred * centred).sum(dim=axes), self.group) / count
        return mean, var

    def forward(self, x, batch_stats: bool, update_stats: bool = False):
        if batch_stats and self.group is not None:
            mean, var = self._global_moments(x)
            if update_stats:
                with torch.no_grad():
                    self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                    self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
            shape = (1, -1, 1, 1)
            y = ((at_least_float32(x) - mean.view(shape))
                 * torch.rsqrt(var.view(shape) + self.epsilon)
                 * self.scale.view(shape) + self.bias.view(shape))
            return y.to(x.dtype)
        if update_stats:
            if not batch_stats:
                raise ValueError("running averages update from batch statistics")
            with torch.no_grad():
                var, mean = torch.var_mean(at_least_float32(x), dim=(0, 2, 3),
                                           correction=0)
                self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        if batch_stats:
            # training=True with no running buffers: batch statistics,
            # biased variance, nothing updated
            return F.batch_norm(x, None, None, self.scale, self.bias, True,
                                0.0, self.epsilon)
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            False, 0.0, self.epsilon)


class Conv2D(nn.Module):
    """conv_2d parity: VALID/SAME conv, optional BN (then no bias)."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding: str = "VALID",
                 use_bias: bool = True, use_batch_norm: bool = False,
                 activation: Callable | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        assert padding in ("VALID", "SAME"), padding
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.conv = nn.Conv2d(in_channels, features, self.kernel_size, self.strides,
                              bias=use_bias and not use_batch_norm)
        self.bn = BatchNorm(features) if use_batch_norm else None
        self.activation = activation
        self.dtype = dtype

    def forward(self, x, batch_stats: bool = True, update_stats: bool = False):
        if self.padding == "SAME":
            x = pad_same(x, self.kernel_size, self.strides)
        d = self.dtype
        y = F.conv2d(cast(x, d), cast(self.conv.weight, d), cast(self.conv.bias, d),
                     self.strides)
        if self.bn is not None:
            y = self.bn(y, batch_stats, update_stats)
        return self.activation(y) if self.activation else y


class Deconv2D(nn.Module):
    """deconv_2d parity: VALID transposed conv, out = in*stride + k - stride."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1), use_bias: bool = True,
                 activation: Callable | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        k, s = tuple(kernel_size), tuple(strides)
        assert k[0] >= s[0] and k[1] >= s[1], (k, s)
        self.strides = s
        self.deconv = nn.ConvTranspose2d(in_channels, features, k, s, bias=use_bias)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        y = F.conv_transpose2d(cast(x, d), cast(self.deconv.weight, d),
                               cast(self.deconv.bias, d), self.strides)
        return self.activation(y) if self.activation else y


def init_weights(model: nn.Module, generator: torch.Generator,
                 small_init: Sequence[str] = ()) -> nn.Module:
    """The reference's initialisers from an explicit generator: Xavier/
    glorot-uniform kernels, zero biases, unit BN scales (core.py:14,34);
    the Dense layers named in `small_init` get the localization output's
    truncated normal, stddev 1e-3 (model.py:255)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (Dense, Conv2D, Deconv2D)):
                layer = (mod.dense if isinstance(mod, Dense) else
                         mod.conv if isinstance(mod, Conv2D) else mod.deconv)
                if name in small_init:
                    std = 1e-3 / TRUNC_NORMAL_STD   # as flax's truncated_normal(1e-3)
                    nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                else:
                    nn.init.xavier_uniform_(layer.weight, generator=generator)
                if layer.bias is not None:
                    layer.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
    return model


def l2_regularization(model: nn.Module, weight_decay: float = 5e-4,
                      exclude: Sequence[str] = ()) -> torch.Tensor:
    """Sum of wd/2 * ||kernel||^2 over all conv, dense and deconv kernels.

    Matches TF's l2_regularizer(scale) = scale*sum(w^2)/2 collection
    (core.py:47-70) as the JAX package does (layers.py:236-258): biases and
    BN scale/offset are skipped, and `exclude` lists parameter-name
    substrings ('.'-joined) also exempted, e.g. the localization output
    layer (model.py:253-256).

    A tensor-parallel Dense holds a slice of its kernel: its term is the
    sum over the model group (the full kernel's), and its gradient this
    rank's slice's own, as every rank of the group adds the same value."""
    groups = {id(mod.dense): mod.tp_group for mod in model.modules()
              if isinstance(mod, Dense) and mod.tp_group is not None}
    squares = []
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            if not any(pat in f"{name}.weight" for pat in exclude):
                sq = torch.sum(mod.weight.float() ** 2)
                if id(mod) in groups:
                    whole = all_reduce_sum(sq.detach(), groups[id(mod)])
                    sq = sq + (whole - sq.detach())
                squares.append(sq)
    return 0.5 * weight_decay * torch.stack(squares).sum()
