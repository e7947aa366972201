"""Recurrent layers (port of spatialaudiogen_tpu.models.recurrent; reference
pyutils/tflib/wrappers/recurrent.py: rnn/lstm/gru and their bidirectional
variants, unused by the SptAudioGen model but part of the reference's NN
library).

Each layer runs one torch.nn.RNN / LSTM / GRU (cuDNN's fused sequence
kernels on the card) over batch-first (B, T, F) input from a zero initial
state. `from_flax_cell` carries the parameters of the JAX package's flax
cells across (flax 0.12 layout):

  SimpleCell         i (kernel + bias), h (kernel)
  OptimizedLSTMCell  ii/if/ig/io (kernels), hi/hf/hg/ho (kernel + bias)
  GRUCell            ir/iz/in (kernel + bias), hr/hz (kernel), hn (kernel + bias)

torch stacks the gates as (i, f, g, o) and (r, z, n) along the rows of
(out, in) matrices and has two biases, b_ih and b_hh: the bridge puts
each flax bias on the side flax has it and zeroes the other. For the GRU,
flax's hn bias sits inside r * (...), where torch's b_hn does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

CELL_TYPES = {"rnn": nn.RNN, "lstm": nn.LSTM, "gru": nn.GRU}
# flax's gate submodules in torch's stacking order: (input side, hidden side)
_GATES = {
    "rnn": (("i",), ("h",)),
    "lstm": (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")),
    "gru": (("ir", "iz", "in"), ("hr", "hz", "hn")),
}


class Recurrent(nn.Module):
    """Unidirectional RNN over (B, T, F) -> (B, T, units); with
    `return_state`, (final state, outputs) as flax's RNN(return_carry=True)
    gives them: h for rnn and gru, (c, h) for lstm, each (B, units)."""

    def __init__(self, in_features: int, units: int, cell_type: str = "lstm",
                 return_state: bool = False):
        super().__init__()
        if cell_type not in CELL_TYPES:
            raise ValueError(f"cell_type must be one of {sorted(CELL_TYPES)}, got {cell_type!r}")
        self.cell_type = cell_type
        self.return_state = return_state
        self.cell = CELL_TYPES[cell_type](in_features, units, batch_first=True)

    def forward(self, x):
        y, state = self.cell(x)
        if not self.return_state:
            return y
        if self.cell_type == "lstm":
            h, c = state
            return (c[0], h[0]), y
        return state[0], y

    def load_flax(self, cell_params: dict) -> "Recurrent":
        """The flax cell's parameters (the `cell` subtree of the JAX layer's
        params) into this layer, in place."""
        self.cell.load_state_dict(from_flax_cell(self.cell_type, cell_params))
        return self


class BidirectionalRecurrent(nn.Module):
    """A forward pass and a pass over the time-flipped sequence, each its own
    layer (`fw`, `bw`), concatenated on features: (B, T, F) -> (B, T,
    2 * units) (reference recurrent.py bidirectional_* parity)."""

    def __init__(self, in_features: int, units: int, cell_type: str = "lstm"):
        super().__init__()
        self.fw = Recurrent(in_features, units, cell_type)
        self.bw = Recurrent(in_features, units, cell_type)

    def forward(self, x):
        bwd = self.bw(x.flip(1))
        return torch.cat([self.fw(x), bwd.flip(1)], dim=-1)

    def load_flax(self, params: dict) -> "BidirectionalRecurrent":
        """The JAX layer's params ({'fw': {'cell': ...}, 'bw': {'cell': ...}})."""
        self.fw.load_flax(params["fw"]["cell"])
        self.bw.load_flax(params["bw"]["cell"])
        return self


def from_flax_cell(cell_type: str, cell: dict) -> dict:
    """A flax cell's parameters {gate: {'kernel': (in, out)[, 'bias']}} ->
    the state_dict of the torch layer (weight_ih_l0, weight_hh_l0,
    bias_ih_l0, bias_hh_l0)."""
    def stack(names, leaf):
        parts = []
        for name in names:
            gate = cell[name]
            if leaf == "kernel":
                parts.append(np.asarray(gate["kernel"]).T)
            else:
                units = np.asarray(gate["kernel"]).shape[1]
                parts.append(np.asarray(gate["bias"]) if "bias" in gate
                             else np.zeros(units, np.float32))
        return torch.from_numpy(np.ascontiguousarray(np.concatenate(parts, axis=0),
                                                     dtype=np.float32))

    in_gates, h_gates = _GATES[cell_type]
    return {"weight_ih_l0": stack(in_gates, "kernel"),
            "weight_hh_l0": stack(h_gates, "kernel"),
            "bias_ih_l0": stack(in_gates, "bias"),
            "bias_hh_l0": stack(h_gates, "bias")}


def rnn(in_features: int, units: int, **kw) -> Recurrent:
    return Recurrent(in_features, units, "rnn", **kw)


def lstm(in_features: int, units: int, **kw) -> Recurrent:
    return Recurrent(in_features, units, "lstm", **kw)


def gru(in_features: int, units: int, **kw) -> Recurrent:
    return Recurrent(in_features, units, "gru", **kw)
