"""The reference training step: the model's train-mode forward, the
training loss, the backward by autograd, and Adam (b1 0.9, b2 0.999, eps
1e-8, bias-corrected, no weight decay in the optimizer: the L2 term is in
the loss), over a dict of float32 tensors."""

from __future__ import annotations

import torch

from port_bench.reference.geometry import Geometry
from port_bench.reference.model import ModelShape, Precision, forward, param_spec, training_loss

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def split(batch: dict, g: Geometry) -> tuple[torch.Tensor, torch.Tensor]:
    """(target Y/Z/X of the centre window, its channel mask)."""
    target = batch["ambix"][:, g.target_ss: g.target_ss + g.snd_dur, 1:]
    return target, batch["audio_mask"][:, 1:]


def trainable(m: ModelShape) -> list:
    return [name for name, _, role in param_spec(m) if role not in ("bn_mean", "bn_var")]


class ReferenceTrainer:
    """Float32 parameters, BN averages and Adam moments, stepped by
    `step(batch, lr)`. `rows` (a slice) keeps only those rows of every
    batch: the fault of a step that leaves part of the batch out."""

    def __init__(self, tensors: dict, m: ModelShape, p: Precision, rows: slice | None = None):
        self.m, self.p, self.rows = m, p, rows
        self.names = trainable(m)
        self.params = {k: v.detach().clone().float() for k, v in tensors.items()}
        self.exp_avg = {k: torch.zeros_like(self.params[k]) for k in self.names}
        self.exp_avg_sq = {k: torch.zeros_like(self.params[k]) for k in self.names}
        self.t = 0
        self.first_grads: dict | None = None

    def loss_and_grads(self, batch: dict) -> tuple[torch.Tensor, dict, dict]:
        if self.rows is not None:
            batch = {k: v[self.rows] for k, v in batch.items()}
        leaves = {k: (self.params[k].detach().requires_grad_(True) if k in self.names
                      else self.params[k]) for k in self.params}
        stats: dict = {}
        pred = forward(leaves, batch, self.m, self.p, stats)
        target, mask = split(batch, self.m.geometry)
        loss = training_loss(leaves, pred, target, mask, self.m)
        grads = torch.autograd.grad(loss, [leaves[k] for k in self.names])
        return loss.detach(), dict(zip(self.names, grads)), stats

    @torch.no_grad()
    def step(self, batch: dict, lr: float) -> float:
        with torch.enable_grad():
            loss, grads, stats = self.loss_and_grads(batch)
        if self.first_grads is None:
            self.first_grads = grads
        self.t += 1
        c1, c2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
        for k in self.names:
            g = grads[k]
            self.exp_avg[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
            self.exp_avg_sq[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            denom = (self.exp_avg_sq[k].sqrt() / c2 ** 0.5).add_(ADAM_EPS)
            self.params[k].addcdiv_(self.exp_avg[k], denom, value=-lr / c1)
        self.params.update(stats)
        return float(loss)
