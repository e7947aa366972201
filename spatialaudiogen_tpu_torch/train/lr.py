"""Learning-rate schedule and optimizer matching the reference (port of
spatialaudiogen_tpu.train.lr).

tf.train.exponential_decay(lr, step, decay_steps, decay_rate, staircase=True)
(myutils.py:214-222) with defaults lr=1e-4, decay 0.5 every 250k steps
(train.py:34-38), and Adam with TF's defaults (b1 0.9, b2 0.999, eps 1e-8).
Weight decay is not the optimizer's: the L2 term is in the loss
(models.metrics.training_loss).
"""

from __future__ import annotations

import torch


def staircase_decay(base_lr: float = 1e-4, decay_rate: float = 0.5,
                    decay_steps: int = 250000):
    """step -> learning rate, base * decay_rate ** (step // decay_steps).

    The optimizer reads it at the step count before the update increments
    it, as optax's scheduled Adam does (step 0 takes base_lr)."""
    def schedule(step: int) -> float:
        return base_lr * decay_rate ** (int(step) // decay_steps)
    return schedule


def make_optimizer(params, base_lr: float = 1e-4) -> torch.optim.Adam:
    """Adam b1 0.9, b2 0.999, eps 1e-8, no weight decay; the trainer sets
    each step's learning rate from staircase_decay."""
    return torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float, sharded=(), group=None) -> None:
    """In place, as optax.clip_by_global_norm: when the global L2 norm of
    all gradients reaches max_norm, each becomes g / norm * max_norm.
    (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm, so it differs.)
    Stays on the device: no host sync.

    Under tensor parallelism the entries of `sharded` (indices into grads)
    are this rank's shards: their squares are summed over `group` (the
    model group), so every rank clips by the full model's norm."""
    if group is None or not sharded:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
    else:
        sq = torch.stack([torch.linalg.vector_norm(g) ** 2 for g in grads])
        mask = torch.zeros_like(sq, dtype=torch.bool)
        mask[list(sharded)] = True
        shard_sq = torch.where(mask, sq, 0.0).sum()
        torch.distributed.all_reduce(shard_sq, group=group)
        norm = torch.sqrt(torch.where(mask, 0.0, sq).sum() + shard_sq)
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
