"""Carrying a JAX run's Adam state into the port: two JAX train steps saved
as an orbax checkpoint, tools/export_torch_weights.py --with_optimizer,
then the port's restore builds train_state.pt from params.npz and
opt_state.npz and takes the third step, held to the JAX package's third
step. With and without clip_norm (make_optimizer then chains
clip_by_global_norm in front of Adam, and the export finds the Adam state
by its type).

Reduced flagship (audio + video, unet_mask with 8 tracks, 64x128 frames,
batch 3). Tolerances are the train step's (tests/test_torch_train_step.py):
the imported moments equal JAX's exactly (layouts aside), the third step's
loss within rtol 1e-5, and its params within atol 2e-6 where the gradient
is not float32 noise (under 1e-7, or more than 2% apart between the two
packages, as that test defines it; under 1% of the entries).
"""

import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.config import TrainConfig as JaxTrainConfig
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from spatialaudiogen_tpu.train.lr import make_optimizer as jax_make_optimizer
from spatialaudiogen_tpu.train.state import create_train_state as jax_create_train_state
from spatialaudiogen_tpu.train.steps import make_observe_step, make_train_step
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.models.convert import from_flax, to_flax
from spatialaudiogen_tpu_torch.train.checkpoint import STATE_FILE, latest_step, restore_checkpoint
from spatialaudiogen_tpu_torch.train.state import create_train_state
from spatialaudiogen_tpu_torch.train.steps import observe_step, train_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from export_torch_weights import adam_state, export  # noqa: E402

CFG = dict(encoders=("audio", "video"), separation="unet_mask", num_sep_tracks=8,
           frame_hw=(64, 128), batch_size=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread in this module: its work is many small ops, and
    the other test workers' threads share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def drop_model_dirs(tmp_path):
    """Each test's model dirs go when it ends: a checkpoint of this model
    is 300 MB."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def flat(tree: dict) -> dict:
    return {"/".join(k.key for k in path): np.array(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def batches(g, n: int) -> list:
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n):
        b = {"ambix": (0.1 * rng.randn(3, g.snd_size, 4)).astype(np.float32),
             "audio_mask": np.ones((3, 4), np.float32),
             "video": rng.randint(0, 256, (3, 1) + CFG["frame_hw"] + (3,)).astype(np.uint8)}
        b["audio_mask"][2, 2] = 0.0
        out.append(b)
    return out


@pytest.fixture(scope="module")
def jax_observe():
    jcfg = JaxTrainConfig(**CFG)
    model = JaxModel(jcfg.model_config())
    fn = jax.jit(make_observe_step(model))
    return lambda state, batch: flat({"params": fn(state.replace(opt_state=()), batch)[0]})


@pytest.mark.parametrize("clip_norm", [None, 1.0], ids=["adam", "clip_then_adam"])
def test_third_step_after_import_matches_jax(tmp_path, jax_observe, clip_norm):
    model_dir = str(tmp_path / "run")
    jcfg = JaxTrainConfig(model_dir=model_dir, clip_norm=clip_norm, **CFG)
    jcfg.save()
    b1, b2, b3 = batches(jcfg.model_config().geometry, 3)
    jmodel = JaxModel(jcfg.model_config())
    tx = jax_make_optimizer(jcfg.lr, jcfg.lr_decay, jcfg.lr_iters, clip_norm)
    step = jax.jit(make_train_step(jmodel, tx))
    state = jax_create_train_state(jmodel, tx, jax.random.PRNGKey(0), b1)
    for b in (b1, b2):
        state, _ = step(state, b)
    jax_save_checkpoint(model_dir, state, 2)
    export(model_dir, with_optimizer=True)
    jax_grads3 = jax_observe(state, b3)
    state3, m3 = step(state, b3)
    want = flat({"params": state3.params, "batch_stats": state3.batch_stats})

    cfg = TrainConfig.load(model_dir)
    assert cfg.clip_norm == clip_norm
    assert latest_step(model_dir) == 2 and not os.path.exists(f"{model_dir}/{STATE_FILE}")
    port = create_train_state(cfg, "cpu")
    assert restore_checkpoint(model_dir, port) == 2 and port.step == 2
    assert os.path.exists(f"{model_dir}/{STATE_FILE}")
    # the imported moments: optax's mu/nu in the port's layouts, step = count
    adam = adam_state(state.opt_state)
    names = [n for n, _ in port.model.named_parameters()]
    opt = port.optimizer.state_dict()["state"]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = from_flax(flat({"params": tree}))
        for i, name in enumerate(names):
            assert torch.equal(opt[i][key], moments[name]), (key, name)
            assert int(opt[i]["step"]) == 2

    batch3 = {k: torch.from_numpy(v) for k, v in b3.items()}
    port_grads3 = to_flax(observe_step(port, batch3)[0])
    m = train_step(port, batch3, cfg.lr, cfg.weight_decay, cfg.clip_norm)
    assert port.step == 3
    assert float(m["total_loss"]) == pytest.approx(float(m3["total_loss"]), rel=1e-5)
    got = to_flax(port.model.state_dict())
    skipped = total = 0
    for k, v in want.items():
        if not k.startswith("params/"):
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-5, err_msg=k)
            continue
        gj, gt = jax_grads3[k], port_grads3[k]
        noise = (np.abs(gj) < 1e-7) | (np.abs(gt - gj) > 0.02 * np.abs(gj))
        skipped += int(noise.sum())
        total += v.size
        diff = np.where(noise, 0.0, np.abs(got[k] - v))
        assert diff.max() <= 2e-6, (k, float(diff.max()))
    assert skipped < 0.01 * total, (skipped, total)
