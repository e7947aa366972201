"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel.py):

    python tests/torch_dist_worker.py SPEC.json RANK

SPEC.json: {"port": free localhost port, "world": ranks, "inputs": npz
path, "out": output dir, "tasks": [...]}. Every rank joins a gloo group
through parallel.distributed.initialize and runs the tasks in order, each
writing `<out>/<task>.<rank>.npz`:

  bn     a BatchNorm over this rank's half of `bn_x` with the data group:
         output, input gradient, parameter gradients, running averages;
  loss   the reduced model's training loss and gradients over this rank's
         half of the batch `loss_*` (the data group normalises);
  dp/tp  two train steps on a (2, 1) / (1, 2) mesh from the flat JAX
         variables `init/...` over the global batches `step{i}_*`: the
         losses, and rank 0's full params (flat JAX layout); tp also a
         checkpoint under `<out>/tp_ckpt`; tp_clip the (1, 2) steps with
         clip_by_global_norm at CLIP_NORM.

Imports torch and the port only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spatialaudiogen_tpu_torch.config import TrainConfig  # noqa: E402
from spatialaudiogen_tpu_torch.models.convert import from_flax, to_flax  # noqa: E402
from spatialaudiogen_tpu_torch.models.layers import BatchNorm  # noqa: E402
from spatialaudiogen_tpu_torch.models.metrics import training_loss  # noqa: E402
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen  # noqa: E402
from spatialaudiogen_tpu_torch.parallel.distributed import initialize, shutdown  # noqa: E402
from spatialaudiogen_tpu_torch.parallel.mesh import (  # noqa: E402
    average_gradients,
    gather_full,
    make_mesh,
    shard_model,
)
from spatialaudiogen_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from spatialaudiogen_tpu_torch.train.lr import make_optimizer  # noqa: E402
from spatialaudiogen_tpu_torch.train.state import TrainState  # noqa: E402
from spatialaudiogen_tpu_torch.train.steps import split_batch, train_step  # noqa: E402

# the reduced flagship of the slice tests
CFG = dict(encoders=("audio", "video"), separation="unet_mask", num_sep_tracks=8,
           frame_hw=(64, 128))
LR = 1e-4
CLIP_NORM = 1.0      # below the reduced model's gradient norm: the clip acts


def rows(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    n = x.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * n: (rank + 1) * n]))


def model_from(flat: dict, batch_size: int) -> SptAudioGen:
    cfg = TrainConfig(batch_size=batch_size, **CFG)
    model = SptAudioGen(cfg.model_config(), frame_hw=CFG["frame_hw"])
    model.load_state_dict(from_flax(flat), strict=True)
    return model


def task_bn(inputs, rank, world) -> dict:
    mesh = make_mesh(world, 1)
    bn = BatchNorm(inputs["bn_x"].shape[1])
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(inputs["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn_bias"]))
    bn.group = mesh.data_group
    x = rows(inputs["bn_x"], rank, world).requires_grad_()
    y = bn(x, batch_stats=True, update_stats=True)
    (y * rows(inputs["bn_w"], rank, world)).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dscale": bn.scale.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "mean": bn.mean.numpy(), "var": bn.var.numpy()}


def task_loss(inputs, rank, world) -> dict:
    mesh = make_mesh(world, 1)
    flat = {k[len("init/"):]: inputs[k] for k in inputs.files if k.startswith("init/")}
    model = shard_model(model_from(flat, inputs["loss_ambix"].shape[0]), mesh)
    batch = {k: rows(inputs[f"loss_{k}"], rank, world) for k in ("ambix", "audio_mask", "video")}
    audio, video, _, target, mask = split_batch(batch, model.cfg.geometry)
    pred = model(audio, video, train=True)
    total, metrics = training_loss(pred, target, mask, model.cfg.audio_rate, model=model,
                                   decay_exclude=model.no_decay_paths(),
                                   group=mesh.data_group)
    total.backward()
    named = [(n, p) for n, p in model.named_parameters()]
    average_gradients([p.grad for _, p in named], mesh)
    out = {f"grad/{k}": v for k, v in to_flax({n: p.grad for n, p in named}).items()}
    out.update({f"metric/{k}": float(v) for k, v in metrics.items()})
    return out


def task_steps(inputs, rank, world, n_data, n_model, out_dir, name,
               clip_norm=None) -> dict:
    mesh = make_mesh(n_data, n_model)
    flat = {k[len("init/"):]: inputs[k] for k in inputs.files if k.startswith("init/")}
    steps = sorted({k.split("_")[0] for k in inputs.files if k.startswith("step")})
    global_rows = inputs[f"{steps[0]}_ambix"].shape[0]
    model = shard_model(model_from(flat, global_rows), mesh)
    state = TrainState(model, make_optimizer(model.parameters(), LR), mesh=mesh)
    losses = []
    for step in steps:
        batch = {k: rows(inputs[f"{step}_{k}"], mesh.data_rank, n_data)
                 for k in ("ambix", "audio_mask", "video")}
        losses.append(float(train_step(state, batch, LR, clip_norm=clip_norm)["total_loss"]))
    full = gather_full(model.state_dict(), model, mesh)
    if name == "tp":
        save_checkpoint(os.path.join(out_dir, f"{name}_ckpt"), state)
    out = {"losses": np.array(losses)}
    if rank == 0:
        out.update({f"final/{k}": v for k, v in to_flax(full).items()})
    return out


def main(spec_fn: str, rank: int) -> None:
    spec = json.load(open(spec_fn))
    world = spec["world"]
    torch.set_num_threads(1)
    initialize(f"localhost:{spec['port']}", world, rank, "cpu", timeout_s=120)
    inputs = np.load(spec["inputs"])
    try:
        for task in spec["tasks"]:
            if task == "bn":
                out = task_bn(inputs, rank, world)
            elif task == "loss":
                out = task_loss(inputs, rank, world)
            else:
                n_data, n_model = (world, 1) if task == "dp" else (1, world)
                out = task_steps(inputs, rank, world, n_data, n_model, spec["out"], task,
                                 CLIP_NORM if task == "tp_clip" else None)
            np.savez(os.path.join(spec["out"], f"{task}.{rank}.npz"), **out)
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
