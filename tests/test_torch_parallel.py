"""The port's multi-device training on the CPU: two gloo ranks
(tests/torch_dist_worker.py, one subprocess each) against one process, and
against the JAX package's sharded step on its CPU mesh.

Reduced flagship (audio + video, unet_mask with 8 tracks, 64x128 frames),
weights from the JAX package's initialisation (models.convert.from_flax),
global batches of 4 rows: rank 0's two rows are WXY clips (Z masked),
rank 1's WXYZ, so the shards' channel counts differ and only a global
normalisation gives the one-process loss.

  * BatchNorm with the data group over half batches = one BatchNorm over
    the whole batch: output, input and parameter gradients, running
    averages, to 1e-6;
  * the training loss, every metric and every gradient (averaged over the
    group) = one process on the whole batch: loss rtol 1e-5, gradients
    relative L2 1e-4 per leaf (the train step's tolerance,
    tests/test_torch_train_step.py);
  * two train steps of the port's 2-rank data parallel and 2-rank tensor
    parallel runs against the JAX package's jit_sharded step on a (2, 1)
    and a (1, 2) mesh, and against the port's own steps in one process:
    losses rtol 1e-5, every param within steps * 1e-4 + 1e-7 (the bound
    tests/test_multiprocess.py derives: Adam moves a coordinate whose
    gradient is float32 noise by up to lr per step). That test also allows
    1 in 10^5 elements over 1e-5, for an audio-only model without
    separation. This model has batch-statistics BN and the U-Net, whose
    deconv4/5 gradients are built from cancelling terms
    (tests/test_torch_train_step.py): measured 1295 of 24.7M elements over
    1e-5 against the port's one process (held to 1 in 10^4) and up to
    4938 against JAX (held to 1 in 10^3); and each leaf's update within
    relative L2 5e-2 of JAX's (measured at most 1.45e-2), which a wrong
    gradient on a small leaf would break;
  * tensor parallel with clip_by_global_norm (the shards' squares summed
    over the model group) against one process with the same clip;
  * the tensor-parallel run's checkpoint restores in one process, full
    tensors, Adam moments included;
  * the sharding rule is the JAX package's (only dense layers with at
    least 1024 outputs split; audio-fc, 1024 wide, is the one).
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.config import TrainConfig as JaxTrainConfig
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
from spatialaudiogen_tpu.parallel.mesh import param_sharding_specs as jax_specs
from spatialaudiogen_tpu.train.lr import make_optimizer as jax_make_optimizer
from spatialaudiogen_tpu.train.state import create_train_state as jax_create_train_state
from spatialaudiogen_tpu.train.steps import jit_sharded, make_train_step
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.models.convert import from_flax, to_flax
from spatialaudiogen_tpu_torch.models.layers import BatchNorm
from spatialaudiogen_tpu_torch.models.metrics import training_loss
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.parallel.mesh import make_mesh, param_sharding_specs
from spatialaudiogen_tpu_torch.train.checkpoint import restore_checkpoint
from spatialaudiogen_tpu_torch.train.lr import make_optimizer
from spatialaudiogen_tpu_torch.train.state import TrainState, create_train_state
from spatialaudiogen_tpu_torch.train.steps import split_batch, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
CFG = dict(encoders=("audio", "video"), separation="unet_mask", num_sep_tracks=8,
           frame_hw=(64, 128))
ROWS, STEPS, WORLD = 4, 2, 2
CLIP_NORM = 1.0       # as tests/torch_dist_worker.py


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread in this module: its work is many small ops, and
    the other test workers' threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def flat(tree: dict) -> dict:
    return {"/".join(k.key for k in path): np.array(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def global_batches(g) -> list:
    rng = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        b = {"ambix": (0.1 * rng.randn(ROWS, g.snd_size, 4)).astype(np.float32),
             "audio_mask": np.ones((ROWS, 4), np.float32),
             "video": rng.randint(0, 256, (ROWS, 1) + CFG["frame_hw"] + (3,)).astype(np.uint8)}
        b["audio_mask"][: ROWS // WORLD, 2] = 0.0     # rank 0's rows: WXY clips
        out.append(b)
    return out


def run_ranks(tmp, tasks, inputs_fn) -> None:
    spec = os.path.join(tmp, "spec.json")
    json.dump({"port": _free_port(), "world": WORLD, "inputs": inputs_fn, "out": tmp,
               "tasks": tasks}, open(spec, "w"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, spec, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"


def jax_steps(jmodel, state0, batches, n_data, n_model) -> tuple:
    tx = jax_make_optimizer()
    mesh = jax_make_mesh(n_data, n_model)
    step_fn, shardings = jit_sharded(make_train_step(jmodel, tx), state0, tx, mesh,
                                     donate_state=False)
    state = jax.device_put(state0, shardings)
    losses = []
    for b in batches:
        state, metrics = step_fn(state, jax.device_put(b, batch_sharding(mesh)))
        losses.append(float(metrics["total_loss"]))
    return losses, flat({"params": state.params, "batch_stats": state.batch_stats})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torchdist"))
    jcfg = JaxTrainConfig(batch_size=ROWS, **CFG)
    g = jcfg.model_config().geometry
    batches = global_batches(g)
    jmodel = JaxModel(jcfg.model_config())
    state0 = jax_create_train_state(jmodel, jax_make_optimizer(), jax.random.PRNGKey(0),
                                    batches[0])
    v0 = flat({"params": state0.params, "batch_stats": state0.batch_stats})
    rng = np.random.RandomState(5)
    inputs = {f"init/{k}": v for k, v in v0.items()}
    inputs.update({"bn_x": (1.5 + rng.randn(4, 6, 5, 7)).astype(np.float32),
                   "bn_w": rng.randn(4, 6, 5, 7).astype(np.float32),
                   "bn_scale": (1 + 0.1 * rng.randn(6)).astype(np.float32),
                   "bn_bias": (0.1 * rng.randn(6)).astype(np.float32)})
    inputs.update({f"loss_{k}": v for k, v in batches[0].items()})
    for i, b in enumerate(batches):
        inputs.update({f"step{i}_{k}": v for k, v in b.items()})
    inputs_fn = os.path.join(tmp, "inputs.npz")
    np.savez(inputs_fn, **inputs)
    tasks = ["bn", "loss", "dp", "tp", "tp_clip"]
    run_ranks(tmp, tasks, inputs_fn)
    os.remove(inputs_fn)
    ranks = {}
    for task in tasks:
        ranks[task] = []
        for r in range(WORLD):
            fn = os.path.join(tmp, f"{task}.{r}.npz")
            ranks[task].append(dict(np.load(fn)))
            os.remove(fn)
    jax_runs = {"dp": jax_steps(jmodel, state0, batches, 2, 1),
                "tp": jax_steps(jmodel, state0, batches, 1, 2)}
    yield {"tmp": tmp, "inputs": inputs, "v0": v0, "batches": batches, "ranks": ranks,
           "jax": jax_runs, "jparams": state0.params, "single": port_steps(v0, batches),
           "single_clip": port_steps(v0, batches, CLIP_NORM)}
    shutil.rmtree(tmp, ignore_errors=True)    # a checkpoint of this model is 300 MB


def port_steps(v0, batches, clip_norm=None) -> tuple:
    """The port's two steps in one process over the global batches."""
    cfg = TrainConfig(batch_size=ROWS, **CFG)
    model = SptAudioGen(cfg.model_config(), frame_hw=CFG["frame_hw"])
    model.load_state_dict(from_flax(v0), strict=True)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4))
    losses = [float(train_step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                               1e-4, clip_norm=clip_norm)["total_loss"]) for b in batches]
    return losses, to_flax(model.state_dict())


def loose_count(got: dict, want: dict) -> tuple:
    """(params over 1e-5 apart, params): every param within the bound."""
    n_loose = n_total = 0
    for k, ref in want.items():
        if not k.startswith("params/"):
            np.testing.assert_allclose(got[k], ref, atol=1e-5, rtol=1e-5, err_msg=k)
            continue
        diff = np.abs(got[k] - ref)
        assert diff.max() <= STEPS * 1e-4 + 1e-7, (k, float(diff.max()))
        n_loose += int((diff > 1e-5).sum())
        n_total += diff.size
    return n_loose, n_total


def test_batch_norm_takes_global_moments(runs):
    x_all = torch.from_numpy(runs["inputs"]["bn_x"]).requires_grad_()
    bn = BatchNorm(x_all.shape[1])
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(runs["inputs"]["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(runs["inputs"]["bn_bias"]))
    y = bn(x_all, batch_stats=True, update_stats=True)
    (y * torch.from_numpy(runs["inputs"]["bn_w"])).sum().backward()
    got = runs["ranks"]["bn"]
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in got]), y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in got]), x_all.grad.numpy(),
                               **tol)
    for key, want in (("dscale", bn.scale.grad), ("dbias", bn.bias.grad)):
        np.testing.assert_allclose(sum(r[key] for r in got), want.numpy(), rtol=1e-6,
                                   atol=1e-5, err_msg=key)
    for r in got:
        np.testing.assert_allclose(r["mean"], bn.mean.numpy(), **tol)
        np.testing.assert_allclose(r["var"], bn.var.numpy(), **tol)
    np.testing.assert_array_equal(got[0]["mean"], got[1]["mean"])


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_loss_and_gradients_normalise_over_the_global_batch(runs):
    cfg = TrainConfig(batch_size=ROWS, **CFG)
    model = SptAudioGen(cfg.model_config(), frame_hw=CFG["frame_hw"])
    model.load_state_dict(from_flax(runs["v0"]), strict=True)
    batch = {k: torch.from_numpy(v) for k, v in runs["batches"][0].items()}
    audio, video, _, target, mask = split_batch(batch, model.cfg.geometry)
    total, metrics = training_loss(model(audio, video, train=True), target, mask,
                                   model.cfg.audio_rate, model=model,
                                   decay_exclude=model.no_decay_paths())
    total.backward()
    want = to_flax({n: p.grad for n, p in model.named_parameters()})
    for rank in runs["ranks"]["loss"]:
        for k, v in metrics.items():
            assert rank[f"metric/{k}"] == pytest.approx(v.item(), rel=1e-5, abs=1e-6), k
        for k, v in want.items():
            assert _rel_l2(rank[f"grad/{k}"], v) <= 1e-4, (k, _rel_l2(rank[f"grad/{k}"], v))
    # a per-rank normalisation would differ: rank 0 counts one Z clip less
    assert float(mask[:2, 1].sum()) == 0.0 and float(mask[2:, 1].sum()) == 2.0


@pytest.mark.parametrize("mode", ["dp", "tp"], ids=["data_parallel_2x1", "tensor_parallel_1x2"])
def test_two_ranks_match_the_jax_mesh_step(runs, mode):
    jax_losses, jax_values = runs["jax"][mode]
    ranks = runs["ranks"][mode]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jax_losses, rtol=1e-5)
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    got = {k[len("final/"):]: v for k, v in ranks[0].items() if k.startswith("final/")}
    assert set(got) == set(jax_values)
    # against the port in one process (the same program, the collectives'
    # order apart): measured 1295 of 24.7M elements over 1e-5 after data
    # parallel steps, 942 of them in separation/deconv5, whose float32
    # gradients are cancellation noise (tests/test_torch_train_step.py)
    single_losses, single_values = runs["single"]
    np.testing.assert_allclose(ranks[0]["losses"], single_losses, rtol=1e-5)
    n_loose, n_total = loose_count(got, single_values)
    assert n_loose <= n_total // 10000, (n_loose, n_total)
    # against the JAX mesh step: the same bound on every element; the
    # elements over 1e-5 are those whose gradient is float32 noise:
    # measured 1362 (data parallel) and 4938 (tensor parallel) of 24.7M,
    # held to 1 in 10^3
    n_loose, n_total = loose_count(got, jax_values)
    assert n_loose <= n_total // 1000, (n_loose, n_total)
    # and each leaf's update (final - initial) within relative L2 5e-2 of
    # JAX's: Adam's first updates are about lr on nearly every coordinate
    # whatever the gradient, so the element bounds above cannot see a wrong
    # gradient on a small leaf, but its update's direction can; measured at
    # most 1.45e-2 (separation/fc-feats bias, data parallel) and 1.35e-2
    # (video_encoder conv1, tensor parallel)
    v0 = runs["v0"]
    for k, want in jax_values.items():
        if k.startswith("params/"):
            err = _rel_l2(got[k] - v0[k], want - v0[k])
            assert err <= 5e-2, (k, err)


def test_tensor_parallel_clips_by_the_full_models_norm(runs):
    """clip_by_global_norm under tensor parallelism: audio-fc's two shards'
    squares summed over the model group, so the clip equals one process's
    (and differs from the unclipped run: the clip acts)."""
    ranks = runs["ranks"]["tp_clip"]
    single_losses, single_values = runs["single_clip"]
    np.testing.assert_allclose(ranks[0]["losses"], single_losses, rtol=1e-5)
    got = {k[len("final/"):]: v for k, v in ranks[0].items() if k.startswith("final/")}
    n_loose, n_total = loose_count(got, single_values)
    assert n_loose <= n_total // 10000, (n_loose, n_total)
    assert ranks[0]["losses"][1] != runs["ranks"]["tp"][0]["losses"][1]


def test_tensor_parallel_checkpoint_restores_in_one_process(runs):
    cfg = TrainConfig(batch_size=ROWS, **CFG)
    state = create_train_state(cfg, "cpu")
    assert restore_checkpoint(os.path.join(runs["tmp"], "tp_ckpt"), state) == STEPS
    final = {k[len("final/"):]: v for k, v in runs["ranks"]["tp"][0].items()
             if k.startswith("final/")}
    for k, v in to_flax(state.model.state_dict()).items():
        np.testing.assert_array_equal(v, final[k], err_msg=k)
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.optimizer.state_dict()["state"]
    fc = names.index("bottleneck.audio-fc.dense.weight")
    assert opt[fc]["exp_avg"].shape == (1024, state.model.bottleneck.get_submodule(
        "audio-fc").dense.weight.shape[1])
    assert int(opt[fc]["step"]) == STEPS


def test_sharding_rule_is_the_jax_packages(runs):
    cfg = TrainConfig(batch_size=ROWS, **CFG)
    model = SptAudioGen(cfg.model_config(), frame_hw=CFG["frame_hw"])
    got = {k for k, v in param_sharding_specs(model, 2).items() if v == 0}
    assert got == {"bottleneck.audio-fc.dense.weight", "bottleneck.audio-fc.dense.bias"}
    assert not any(v is not None for v in param_sharding_specs(model, 1).values())
    specs = jax_specs(runs["jparams"], jax_make_mesh(1, 2))
    want = {"/".join(k.key for k in path) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
            if spec != jax.sharding.PartitionSpec()}
    assert want == {"bottleneck/audio-fc/dense/kernel", "bottleneck/audio-fc/dense/bias"}


def test_one_process_mesh_launches_nothing():
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.data_group, mesh.model_group) == (1, 1, None, None)
    with pytest.raises(ValueError, match="number of processes"):
        make_mesh(2, 1)
