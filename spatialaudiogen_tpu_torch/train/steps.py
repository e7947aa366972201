"""The train and eval steps (port of spatialaudiogen_tpu.train.steps).

The batch dict carries the feeder outputs (feeder.py:323-335 names), as
tensors on the model's device:
  ambix      (B, snd_size, num_ambi_channels)   float32
  audio_mask (B, num_ambi_channels)             float32
  video      (B, vid_dur, H, W, 3)              uint8 or float32 [if encoders use it]

Input/target slicing happens inside the step (train.py:107-111): the first
order^2 channels are the model input, channels [order^2:] of the center
prediction window are the target.
"""

from __future__ import annotations

import torch

from spatialaudiogen_tpu_torch.dsp.geometry import ModelGeometry
from spatialaudiogen_tpu_torch.models.metrics import evaluation_metrics, training_loss
from spatialaudiogen_tpu_torch.ops.dft import precision_scope
from spatialaudiogen_tpu_torch.train.lr import clip_by_global_norm
from spatialaudiogen_tpu_torch.train.state import TrainState


def split_batch(batch: dict, g: ModelGeometry):
    """-> (audio_in, video, flow, target, mask), as _split_batch does."""
    n_in = g.num_in_channels
    ambix = batch["ambix"]
    audio_in = ambix[:, :, :n_in]
    target = ambix[:, g.target_ss: g.target_ss + g.snd_dur, n_in:]
    mask = batch["audio_mask"][:, n_in:]
    video, flow = batch.get("video"), batch.get("flow")
    if video is not None and video.dtype == torch.uint8:
        # u8 transport (readers.img_prep_u8): the feeder ships raw frames at
        # a quarter of the f32 bytes and the prep (myutils.py:88-89) runs
        # here, on the device
        video = video.float() / 255.0 - 0.5
    return audio_in, video, flow, target, mask


def train_step(state: TrainState, batch: dict, lr: float,
               weight_decay: float = 5e-4, clip_norm: float | None = None) -> dict:
    """One step in place: forward with train=True (BN running averages
    move), training_loss, backward, the optional global-norm clip, then
    Adam at learning rate `lr`. Returns the metrics as 0-d device tensors.

    A model built with dtype=torch.bfloat16 runs its conv, deconv and FC
    products in bfloat16; its params stay the float32 masters, so their
    gradients and Adam's moments are float32, and the model's output and
    the loss are float32 (the JAX package's compute_dtype="bfloat16")."""
    model = state.model
    cfg = model.cfg
    audio_in, video, flow, target, mask = split_batch(batch, cfg.geometry)
    # the loss DFTs and the backward under the forward's precision
    with precision_scope(cfg.dft_precision):
        pred = model(audio_in, video, flow, train=True)
        total, metrics = training_loss(pred, target, mask, cfg.audio_rate, model=model,
                                       weight_decay=weight_decay,
                                       decay_exclude=model.no_decay_paths())
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
    if clip_norm is not None:
        clip_by_global_norm([p.grad for p in model.parameters() if p.grad is not None],
                            clip_norm)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model, batch: dict):
    """The eval step (make_eval_step's counterpart): forward with
    train=False and the metric battery of models.metrics, both under the
    model's dft_precision. -> (pred, mono, target, metrics, per_sample):
    pred and target (B, snd_dur, n_out), mono (B, snd_dur, n_in), the
    per-sample metrics (B, n_out)."""
    cfg = model.cfg
    g = cfg.geometry
    audio_in, video, flow, target, mask = split_batch(batch, g)
    with precision_scope(cfg.dft_precision):
        pred = model(audio_in, video, flow, train=False)
        metrics, per_sample = evaluation_metrics(pred, target, mask, cfg.audio_rate)
    mono = audio_in[:, g.target_ss: g.target_ss + g.snd_dur]
    return pred, mono, target, metrics, per_sample
