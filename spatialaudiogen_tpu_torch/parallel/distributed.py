"""Multi-process runtime over torch.distributed (counterpart of
spatialaudiogen_tpu.parallel.distributed).

  * `initialize(...)` joins a run of `n_processes` ranks through the
    coordinator's TCP store (`--coordinator/--n_processes/--process_id`).
    At one process it is a no-op. The default group is gloo; the groups
    that carry the training collectives (parallel.mesh.make_mesh) use NCCL
    when every rank has a card of its own (`collective_backend`), and gloo
    on the CPU or when ranks share a card (NCCL refuses two ranks on one
    device). Collectives time out after `timeout_s`, so a lost rank fails
    the run instead of hanging it.
  * `global_batch(...)` hands each rank its rows: ranks of one model group
    must see the same rows, and the threaded feeder's order differs from
    process to process, so the group's first rank feeds and broadcasts.
  * `put_like(...)` broadcasts a freshly initialised model's parameters and
    buffers from rank 0, so every rank starts from the same values.
  * `spawn_local(...)` starts every rank of a run on this host, one process
    each, for the CLIs' `--n_data`/`--n_model` form: each rank calls its
    CLI module's `rank_main`, which joins the run (`run_as_rank` for the
    inference CLIs, which take no multi-process flags).
"""

from __future__ import annotations

import datetime
import importlib
import socket

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator: str | None = None, n_processes: int | None = None,
               process_id: int | None = None, device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join a multi-process run; -> this rank's device.

    With n_processes None or 1 nothing is initialised and `device` comes
    back as it is. Otherwise rank `process_id` of `n_processes` joins
    through the TCP store at `coordinator` ("host:port", served by rank 0);
    a CUDA rank takes card process_id % (cards on its host)."""
    dev = torch.device(device)
    if n_processes is None or n_processes <= 1:
        return dev
    if coordinator is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator and --process_id")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is False")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=n_processes, rank=process_id, timeout=timeout)
    return dev


def local_device(device) -> torch.device:
    """`device` with this process's card made explicit ("cuda" -> "cuda:K",
    the card `initialize` set), so ranks can tell whether they share one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def collective_backend(device) -> str:
    """"nccl" when every rank's `device` is a card no other rank uses, else
    "gloo" (one all-gather of each rank's host and device)."""
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, (socket.gethostname(), str(torch.device(device))))
    own_cards = torch.device(device).type == "cuda" and len(set(where)) == len(where)
    return "nccl" if own_cards else "gloo"


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_batch(local: dict | None, mesh, device) -> dict:
    """This rank's rows of the global batch, on `device`.

    `local` is the batch the feeder gave this rank (None on a rank that
    does not feed). Under tensor parallelism the model group's first rank
    feeds and broadcasts its rows to the others of its group; the layout
    (keys, shapes, dtypes) goes first as a small object broadcast."""
    if mesh is None or mesh.n_model == 1:
        return {k: v.to(device, non_blocking=True) for k, v in local.items()}
    src = mesh.model_src
    layout = [None if local is None else
              {k: (tuple(v.shape), v.dtype) for k, v in local.items()}]
    dist.broadcast_object_list(layout, src=src, group=mesh.model_group)
    out = {}
    for key, (shape, dtype) in layout[0].items():
        t = (local[key].to(device) if local is not None
             else torch.empty(shape, dtype=dtype, device=device))
        dist.broadcast(t, src=src, group=mesh.model_group)
        out[key] = t
    return out


@torch.no_grad()
def put_like(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of `module` broadcast from rank 0 (no-op in
    a single process)."""
    if is_distributed():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, module: str, argv: list, coordinator: str, n_ranks: int) -> None:
    importlib.import_module(module).rank_main(argv, coordinator, n_ranks, rank)


def spawn_local(module: str, argv: list, n_ranks: int) -> None:
    """Every rank of a run on this host, one process each (started with
    spawn, so a CUDA rank initialises its own card), over a free localhost
    port: rank r calls `module`'s rank_main(argv, "localhost:PORT",
    n_ranks, r). Raises when a rank exits with an error
    (torch.multiprocessing terminates the others)."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(module, list(argv), f"localhost:{free_port()}",
                                         n_ranks),
                       nprocs=n_ranks, join=True, start_method="spawn")


def run_as_rank(main, argv: list, coordinator: str, n_ranks: int, rank: int,
                device: str):
    """main(argv) as rank `rank` of `n_ranks`: joins the run through the
    store at `coordinator`, calls main, and leaves the run."""
    initialize(coordinator, n_ranks, rank, device)
    try:
        return main(argv)
    finally:
        shutdown()
