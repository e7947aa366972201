"""One rank of the port's sharded-inference CPU tests
(tests/test_torch_sharded.py):

    python tests/torch_infer_worker.py SPEC.json RANK

SPEC.json: {"port": free localhost port, "world": ranks, "tasks": [[name,
kwargs], ...]}. Every rank joins a gloo group through
parallel.distributed.initialize, makes one (world, 1) mesh and runs the
tasks in order:

  deploy   deploy_outputs(**kwargs["args"], mesh): MonoToAmbix(mesh=)'s
           deploy and its host route; rank 0 saves the npz kwargs["out"];
           with kwargs["as_nccl"] the mesh takes the route of ranks with
           a card each (the blocks gathered before the copy back), its
           collectives still on gloo;
  batcher  batcher_outputs(**kwargs["args"], mesh): a StreamBatcher(mesh=)
           over the sessions of an npz; rank 0 saves kwargs["out"];
  cli      kwargs["module"]'s main(kwargs["argv"]): a CLI whose --n_data
           is the world size runs as this rank; rank 0 then copies the
           files kwargs["copy"] names ([[src, dst], ...]).

The tests' one-process side calls deploy_outputs and batcher_outputs with
mesh=None, and start_ranks / wait_ranks run the ranks. Torch runs on one
thread in every rank. Imports torch and the port only.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix  # noqa: E402
from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher  # noqa: E402
from spatialaudiogen_tpu_torch.parallel.distributed import (  # noqa: E402
    free_port,
    initialize,
    shutdown,
)
from spatialaudiogen_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

RANK_TIMEOUT_S = 600


def deploy_outputs(model_dir: str, clip: str, start: float, duration: float, batch: int,
                   mesh=None) -> dict:
    """The f32-fetch deploy over [start, start + duration) of `clip` and its
    host route's (mono, pred); {} on the ranks other than 0."""
    engine = MonoToAmbix(model_dir, batch_size=batch, device="cpu", f16_fetch=False,
                         mesh=mesh)
    ambi = engine.deploy(clip, start, duration)
    mono, pred = engine._predict_span_host(clip, start, duration)
    if ambi is None:
        return {}
    return {"ambi": ambi, "host_mono": mono, "host_pred": pred}


def batcher_outputs(model_dir: str, sessions: str, capacity: int, mesh=None) -> dict:
    """A capacity-`capacity` f32-fetch StreamBatcher over the sessions of
    the npz `sessions` (signals (S, N) float32, frames (K, H, W, 3) uint8
    or empty): one 0.1 s block of every session and frame k per tick, then
    a flush of each. -> {"s{i}": (N', 4) chunks of session i}; {} on the
    ranks other than 0."""
    data = np.load(sessions)
    signals, frames = data["signals"], data["frames"]
    b = StreamBatcher(model_dir, capacity=capacity, f16_fetch=False, device="cpu", mesh=mesh)
    sids = [b.add_session() for _ in signals]
    got = {sid: [] for sid in sids}

    def collect(result):
        for sid, chunks in result.items():
            got[sid].extend(chunks)

    block = b.geometry.snd_dur
    for k in range(0, signals.shape[1] - block + 1, block):
        for i, sid in enumerate(sids):
            frame = frames[k // block] if len(frames) else None
            b.push(sid, signals[i][k: k + block], frame)
        collect(b.tick())
    for sid in sids:
        collect(b.flush(sid))
    if mesh is not None and not mesh.is_primary:
        return {}
    return {f"s{i}": np.concatenate(got[sid], 0) for i, sid in enumerate(sids)}


TASKS = {"deploy": deploy_outputs, "batcher": batcher_outputs}


def main(spec_fn: str, rank: int) -> None:
    spec = json.load(open(spec_fn))
    world = spec["world"]
    torch.set_num_threads(1)
    initialize(f"localhost:{spec['port']}", world, rank, "cpu", timeout_s=120)
    try:
        mesh = make_mesh(world, 1, "cpu")
        for name, kw in spec["tasks"]:
            if name == "cli":
                importlib.import_module(kw["module"]).main(kw["argv"])
                if rank == 0:
                    for src, dst in kw.get("copy", []):
                        shutil.copy(src, dst)
                continue
            mesh.backend = "nccl" if kw.get("as_nccl") else "gloo"
            out = TASKS[name](mesh=mesh, **kw["args"])
            if rank == 0:
                np.savez(kw["out"], **out)
    finally:
        shutdown()


# --- the tests' side ----------------------------------------------------------

def start_ranks(tmp: str, tasks: list, world: int = 2) -> list:
    """Start `world` ranks of this worker over `tasks` in the background."""
    spec = os.path.join(tmp, "spec.json")
    json.dump({"port": free_port(), "world": world, "tasks": tasks}, open(spec, "w"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), spec, str(r)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for r in range(world)]


def wait_ranks(procs: list) -> None:
    """Wait for every rank; AssertionError with its output when one failed."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
