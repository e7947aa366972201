"""Train state: the model, its optimizer and the step count (counterpart of
spatialaudiogen_tpu.train.state; the model holds its params and BN
batch_stats, the optimizer the Adam moments)."""

from __future__ import annotations

import dataclasses

import torch

from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.train.lr import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: SptAudioGen
    optimizer: torch.optim.Adam
    step: int = 0


def create_train_state(cfg: TrainConfig, device, seed: int | None = None) -> TrainState:
    """Model with the reference's initialisers drawn from
    torch.Generator().manual_seed(seed) (cfg.seed by default), moved to
    `device`, and its Adam optimizer. Params are float32 whatever
    cfg.compute_dtype is: bfloat16 is a compute dtype only."""
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    model = SptAudioGen(cfg.model_config(), frame_hw=tuple(cfg.frame_hw))
    model.init_weights(gen)
    model.to(device)
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), cfg.lr))
