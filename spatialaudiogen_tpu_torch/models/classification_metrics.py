"""Classification metrics (port of
spatialaudiogen_tpu.models.classification_metrics; reference
pyutils/tflib/wrappers/metrics.py)."""

from __future__ import annotations

import torch


def _class_ids(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Labels as class ids: one-hot labels (the logits' rank) -> argmax."""
    return labels.argmax(dim=-1) if labels.dim() == logits.dim() else labels


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean top-1 accuracy; labels may be class ids or one-hot."""
    return (logits.argmax(dim=-1) == _class_ids(logits, labels)).float().mean()


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Share of rows whose label is among the k classes that a stable
    ascending sort puts last, as jnp.argsort(...)[..., -k:] picks them
    (among equal logits, the higher class ids)."""
    topk = torch.argsort(logits, dim=-1, stable=True)[..., -k:]
    return (topk == _class_ids(logits, labels)[..., None]).any(dim=-1).float().mean()
