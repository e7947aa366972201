"""Seeded weights on the device, in a few large calls: one uniform draw
over every parameter at once from a torch.Generator on the device,
scaled per tensor to the reference's initialisers (Glorot-uniform
kernels; the localization output layer with the standard deviation 1e-3
of its truncated normal), with small nonzero biases and BN affine terms so
that every term of the model is exercised. BN running averages start at
0 and 1. The same tensors go to the program and to the reference."""

from __future__ import annotations

import math

import torch

from port_bench.reference.model import ModelShape, fan_in_out, param_spec


def make_weights(m: ModelShape, seed: int, device) -> dict:
    spec = param_spec(m)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out = {}
    for (name, shape, role), chunk in zip(spec, flat.split(sizes)):
        t = chunk.view(shape)
        if role == "kernel":
            fan_in, fan_out = fan_in_out(shape)
            t = t * math.sqrt(6.0 / (fan_in + fan_out))
        elif role == "small_kernel":
            t = t * (1e-3 * math.sqrt(3.0))       # uniform of std 1e-3
        elif role == "bias":
            t = t * 0.01
        elif role == "bn_scale":
            t = 1.0 + 0.1 * t
        elif role == "bn_bias":
            t = 0.1 * t
        elif role == "bn_mean":
            t = torch.zeros_like(t)
        elif role == "bn_var":
            t = torch.ones_like(t)
        out[name] = t.contiguous()
    return out
