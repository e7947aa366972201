"""Generic training harness (port of spatialaudiogen_tpu.train.harness; the
reference's dnn.py "framework" layer).

A model-agnostic fit/evaluate/predict loop over any nn.Module and any
(features, labels) batch iterator: the counterpart of
pyutils/tflib/dnn.py's DNN/TrainOp/EvaluateOp, which the main CLIs bypass,
as does the Trainer, but which quick experiments use. Supports gradient
clipping (optax's clip_by_global_norm) and metric callbacks.

The model comes built, its weights made by the caller (from an explicit
torch.Generator), where the JAX harness initialises its flax module from a
seed at the first batch. `fit` runs the model in train mode and
`evaluate`/`predict` in eval mode (module.train()/.eval()), so a model
whose BatchNorm follows `self.training` sees the phase it is in.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from spatialaudiogen_tpu_torch.train.lr import clip_by_global_norm


def adam_1e3(params) -> torch.optim.Optimizer:
    """The default optimiser, as optax.adam(1e-3): Adam with b1 0.9, b2
    0.999, eps 1e-8."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


class GenericHarness:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 metric_fns: dict | None = None, optimizer: Callable | None = None,
                 clip_norm: float | None = None, device="cuda"):
        """loss_fn(logits, labels) -> 0-d tensor; metric_fns: name ->
        fn(logits, labels); optimizer: a callable on the parameters that
        returns a torch optimiser (default adam_1e3). Batches are numpy
        arrays (or tensors), moved to `device` each step."""
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.metric_fns = metric_fns or {}
        self.optimizer = (optimizer or adam_1e3)(
            [p for p in self.model.parameters() if p.requires_grad])
        self.clip_norm = clip_norm

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def step(self, feats, labels) -> dict:
        """One optimiser step on a batch -> {"loss", metric names: 0-d tensors}."""
        self.model.train()
        feats, labels = self._tensor(feats), self._tensor(labels)
        logits = self.model(feats)
        loss = self.loss_fn(logits, labels)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.clip_norm is not None:
            clip_by_global_norm([p.grad for p in self.model.parameters()
                                 if p.grad is not None], self.clip_norm)
        self.optimizer.step()
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            for name, fn in self.metric_fns.items():
                metrics[name] = fn(logits.detach(), labels)
        return metrics

    def fit(self, batches, epochs: int = 1, log_every: int = 0) -> list:
        """batches: iterable (or callable returning one) of (features, labels).
        -> one dict of floats per epoch, its last step's metrics."""
        history = []
        for epoch in range(epochs):
            it = batches() if callable(batches) else batches
            for i, (feats, labels) in enumerate(it):
                metrics = self.step(feats, labels)
                if log_every and i % log_every == 0:
                    print(f"epoch {epoch} step {i}: " +
                          " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()))
            history.append({k: float(v) for k, v in metrics.items()})
        return history

    @torch.no_grad()
    def evaluate(self, batches) -> dict:
        """Loss and metrics over all batches, each batch weighted by its size."""
        self.model.eval()
        totals: dict = {}
        n = 0
        for feats, labels in (batches() if callable(batches) else batches):
            feats, labels = self._tensor(feats), self._tensor(labels)
            logits = self.model(feats)
            b = feats.shape[0]
            totals["loss"] = totals.get("loss", 0) + float(self.loss_fn(logits, labels)) * b
            for name, fn in self.metric_fns.items():
                totals[name] = totals.get(name, 0) + float(fn(logits, labels)) * b
            n += b
        return {k: v / n for k, v in totals.items()}

    @torch.no_grad()
    def predict(self, features) -> np.ndarray:
        """The model's outputs on `features`, as a numpy array."""
        self.model.eval()
        return self.model(self._tensor(features)).cpu().numpy()
