"""Autograd-aware collectives of the data and tensor parallel paths
(parallel.mesh). Each takes a process group; with None it is the identity
and launches nothing, so single-process code runs unchanged."""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[..., lo: lo + ctx.width], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`, differentiable (the backward sums the gradients
    over the group too); x itself when group is None."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over `group`."""
    return x if group is None else _CopyToGroup.apply(x, group)


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    """The group's shards concatenated on the last axis in rank order; the
    backward keeps this rank's slice of the gradient."""
    return x if group is None else _GatherLastDim.apply(x, group)
