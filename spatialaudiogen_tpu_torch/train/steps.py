"""The train and eval steps (port of spatialaudiogen_tpu.train.steps).

The batch dict carries the feeder outputs (feeder.py:323-335 names), as
tensors on the model's device:
  ambix      (B, snd_size, num_ambi_channels)   float32
  audio_mask (B, num_ambi_channels)             float32
  video      (B, vid_dur, H, W, 3)              uint8 or float32 [if encoders use it]

Input/target slicing happens inside the step (train.py:107-111): the first
order^2 channels are the model input, channels [order^2:] of the center
prediction window are the target.

Under a mesh (`state.mesh`, parallel.mesh) each rank holds its rows of the
global batch. The loss is the global batch's on every rank (models.metrics
with the data group), and the gradients are averaged over the data group
by one explicit all-reduce of the flattened gradients. DDP is not used: its
reducer hooks the backward of `.backward()` only, and the observe step
takes its gradients with torch.autograd.grad, which the reducer never sees;
one explicit all-reduce serves both steps and leaves the module's state
names as they are.
"""

from __future__ import annotations

import torch

from spatialaudiogen_tpu_torch.dsp.geometry import ModelGeometry
from spatialaudiogen_tpu_torch.models.metrics import evaluation_metrics, training_loss
from spatialaudiogen_tpu_torch.ops.dft import deterministic_cudnn, precision_scope
from spatialaudiogen_tpu_torch.parallel.mesh import average_gradients, sharded_names
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


def _loss(state: TrainState, batch: dict, weight_decay: float, update_stats: bool,
          return_ends: bool = False):
    """Forward with train=True and the training loss, under the forward's
    precision scope, which the caller holds open for the backward."""
    model = state.model
    cfg = model.cfg
    audio_in, video, flow, target, mask = split_batch(batch, cfg.geometry)
    out = model(audio_in, video, flow, train=True, return_ends=return_ends,
                update_stats=update_stats)
    pred, ends = out if return_ends else (out, {})
    group = state.mesh.data_group if state.mesh is not None else None
    total, metrics = training_loss(pred, target, mask, cfg.audio_rate, model=model,
                                   weight_decay=weight_decay,
                                   decay_exclude=model.no_decay_paths(), group=group)
    return total, metrics, ends


def train_step(state: TrainState, batch: dict, lr: float,
               weight_decay: float = 5e-4, clip_norm: float | None = None) -> dict:
    """One step in place: forward with train=True (BN running averages
    move), training_loss, backward, the gradients averaged over the data
    group, the optional global-norm clip, then Adam at learning rate `lr`.
    Returns the metrics (the global batch's) as 0-d device tensors.

    A model built with dtype=torch.bfloat16 runs its conv, deconv and FC
    products in bfloat16; its params stay the float32 masters, so their
    gradients and Adam's moments are float32, and the model's output and
    the loss are float32 (the JAX package's compute_dtype="bfloat16")."""
    model = state.model
    # the loss DFTs and the backward under the forward's precision
    with precision_scope(model.cfg.dft_precision):
        total, metrics, _ = _loss(state, batch, weight_decay, update_stats=True)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
    params = [p for p in model.parameters() if p.grad is not None]
    average_gradients([p.grad for p in params], state.mesh)
    if clip_norm is not None:
        clip_grads(state, params, [p.grad for p in params], clip_norm)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def clip_grads(state: TrainState, params: list, grads: list, clip_norm: float) -> None:
    """clip_by_global_norm over the whole model: a tensor-parallel layer's
    shards count once each, summed over the model group."""
    mesh = state.mesh
    sharded = set()
    if mesh is not None and mesh.model_group is not None:
        names = sharded_names(state.model)
        ids = {id(p) for name, p in state.model.named_parameters() if name in names}
        sharded = {i for i, p in enumerate(params) if id(p) in ids}
    clip_by_global_norm(grads, clip_norm, sharded=sharded,
                        group=mesh.model_group if mesh is not None else None)


def observe_step(state: TrainState, batch: dict, with_ends: bool = False,
                 weight_decay: float = 5e-4):
    """The gradients of the training loss on `batch` at the current params,
    and with `with_ends` the model's tapped activations (make_observe_step's
    counterpart, for the TensorBoard histograms, reference dnn.py:692-709).

    It leaves no trace: no Adam update, the BN running averages where they
    were (the forward runs on batch statistics without moving them), and
    nothing in `.grad` (torch.autograd.grad). Under a mesh the gradients
    are averaged over the data group, as the train step's are. -> ({param
    name: gradient}, {end name: tensor})."""
    model = state.model
    names, params = zip(*[(n, p) for n, p in model.named_parameters() if p.requires_grad])
    with precision_scope(model.cfg.dft_precision):
        total, _, ends = _loss(state, batch, weight_decay, update_stats=False,
                               return_ends=with_ends)
        grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    average_gradients(grads, state.mesh)
    return dict(zip(names, grads)), {k: v.detach() for k, v in ends.items()}


@torch.no_grad()
@deterministic_cudnn()
def eval_step(model, batch: dict):
    """The eval step (make_eval_step's counterpart): forward with
    train=False and the metric battery of models.metrics, both under the
    model's dft_precision and cuDNN's deterministic algorithms (the U-Net's
    transposed convolutions otherwise differ from run to run in the last
    bit, where the JAX package gives one answer). -> (pred, mono, target,
    metrics, per_sample):
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
