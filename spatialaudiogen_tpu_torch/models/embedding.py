"""Embedding lookup layer (port of spatialaudiogen_tpu.models.embedding;
reference pyutils/tflib/wrappers/embedding.py)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class Embedding(nn.Module):
    """ids (...) -> (..., features) rows of a (vocab_size, features) table,
    held under `embedding` as the flax module's is."""

    def __init__(self, vocab_size: int, features: int):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, features)

    def forward(self, ids):
        return self.embedding(ids)

    def load_flax(self, params: dict) -> "Embedding":
        """The JAX layer's params ({'embedding': {'embedding': (V, F)}}), in place."""
        table = torch.from_numpy(np.array(params["embedding"]["embedding"], np.float32))
        with torch.no_grad():
            self.embedding.weight.copy_(table)
        return self


def embedding(vocab_size: int, features: int) -> Embedding:
    return Embedding(vocab_size, features)
