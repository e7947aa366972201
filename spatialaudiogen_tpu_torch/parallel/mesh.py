"""The ('data', 'model') process grid and the sharding rules (counterpart of
spatialaudiogen_tpu.parallel.mesh, over torch.distributed).

Rank r sits at (d, m) = (r // n_model, r % n_model), the JAX package's
grid order (mesh.py:33-38).

  * 'data': each data rank trains on batch_size / n_data rows. The ranks
    that share m form a data group: gradients are averaged over it, and
    BatchNorm moments and the loss's normalisation are taken over it
    (models.layers.BatchNorm, models.metrics), so a step equals one step
    over the global batch, as the JAX package's GSPMD program does.
  * 'model': tensor parallelism of the wide dense layers. The ranks that
    share d form a model group; they see the same rows and hold the same
    values except for the sharded layers, whose output units are split
    over the group (column parallel: the input's gradient is summed over
    the group, the output gathered; the gather's backward takes this rank's
    slice, since every rank of the group computes the same loss).

With one process every group is None and nothing is launched.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from spatialaudiogen_tpu_torch.models.layers import BatchNorm, Dense
from spatialaudiogen_tpu_torch.parallel.distributed import collective_backend, is_distributed

MIN_TP_WIDTH = 1024


@dataclasses.dataclass
class Mesh:
    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    data_group: object = None       # None when n_data == 1
    model_group: object = None      # None when n_model == 1

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def model_src(self) -> int:
        """Global rank of this rank's model group's first rank (its feeder)."""
        return self.data_rank * self.n_model

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def make_mesh(n_data: int | None = None, n_model: int = 1, device="cpu") -> Mesh:
    """The grid over the ranks of the run (one process: a 1x1 mesh), its
    groups on NCCL when every rank's `device` is a card of its own, else on
    gloo. Every rank creates every group, in the same order, as new_group
    requires."""
    world = dist.get_world_size() if is_distributed() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"n_data x n_model = {n_data} x {n_model} must equal the "
                         f"number of processes, {world}")
    mesh = Mesh(n_data, n_model, dist.get_rank() if world > 1 else 0)
    if world == 1:
        return mesh
    backend = collective_backend(device)
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        group = dist.new_group(ranks, backend=backend)
        if mesh.rank in ranks and n_data > 1:
            mesh.data_group = group
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        group = dist.new_group(ranks, backend=backend)
        if mesh.rank in ranks and n_model > 1:
            mesh.model_group = group
    return mesh


# --- sharding rules ---------------------------------------------------------

def param_sharding_specs(model: torch.nn.Module, n_model: int) -> dict:
    """{parameter name: sharded axis or None}. The JAX rule (mesh.py:47-71):
    a dense kernel with at least MIN_TP_WIDTH outputs, divisible by the
    model axis, is split over its outputs, and so is its bias; everything
    else is replicated. The port's weight is (out, in), so its axis 0."""
    specs = {name: None for name, _ in model.named_parameters()}
    if n_model > 1:
        for name, mod in model.named_modules():
            if isinstance(mod, Dense):
                out = mod.dense.weight.shape[0]
                if out >= MIN_TP_WIDTH and out % n_model == 0:
                    for leaf, _ in mod.dense.named_parameters():
                        specs[f"{name}.dense.{leaf}"] = 0
    return specs


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """In place: BatchNorm moments over the data group, and each dense layer
    that param_sharding_specs splits cut to this rank's rows. Call on the
    full model, before its optimizer is made."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group = mesh.data_group
    specs = param_sharding_specs(model, mesh.n_model)
    for name, mod in model.named_modules():
        if isinstance(mod, Dense) and specs.get(f"{name}.dense.weight") == 0:
            for leaf, p in list(mod.dense.named_parameters()):
                part = p.chunk(mesh.n_model, dim=0)[mesh.model_rank].clone()
                setattr(mod.dense, leaf, torch.nn.Parameter(part))
            mod.tp_group = mesh.model_group
    return model


def sharded_names(model: torch.nn.Module) -> set:
    """state_dict names of the parameters this rank holds a shard of."""
    return {f"{name}.dense.{leaf}" for name, mod in model.named_modules()
            if isinstance(mod, Dense) and mod.tp_group is not None
            for leaf, _ in mod.dense.named_parameters()}


def gather_full(tensors: dict, model: torch.nn.Module, mesh: Mesh | None) -> dict:
    """{name: tensor} with each sharded entry gathered over the model group
    into the full tensor (every rank of the group must call)."""
    if mesh is None or mesh.model_group is None:
        return tensors
    out = dict(tensors)
    for name in sorted(sharded_names(model) & set(tensors)):   # one order on every rank
        t = tensors[name].detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
        dist.all_gather(parts, t, group=mesh.model_group)
        out[name] = torch.cat(parts, dim=0)
    return out


def slice_local(tensors: dict, model: torch.nn.Module, mesh: Mesh | None) -> dict:
    """{name: full tensor} with each sharded entry cut to this rank's rows."""
    if mesh is None or mesh.model_group is None:
        return tensors
    out = dict(tensors)
    for name in sharded_names(model) & set(tensors):
        out[name] = tensors[name].chunk(mesh.n_model, dim=0)[mesh.model_rank].clone()
    return out


@torch.no_grad()
def average_gradients(grads: list, mesh: Mesh | None) -> None:
    """In place: each gradient averaged over the data group, in one
    all-reduce of the flattened gradients."""
    if mesh is None or mesh.data_group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.n_data
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
