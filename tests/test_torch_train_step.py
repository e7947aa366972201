"""The port's train step against the JAX package's make_train_step +
create_train_state, and the learning-rate schedule.

Reduced flagship: audio + video encoders, unet_mask head with 8 tracks,
64x128 frames, batch 3, the same JAX-initialised weights in both packages
(through models.convert.from_flax), the same batches (u8 frames, one row
with its Z channel masked as a WXY clip's is). The JAX gradients come out
of the step itself: its optimizer is optax.chain(capture, adam), where
`capture` passes the gradients through unchanged and keeps them as its
state, so the step, the Adam update and the params are the package's own.

Finding: at the second step, the JAX step's float32 gradients of the
separation U-Net's deconv2-5 and fc-feats leaves (norms ~1e-4, built from
large cancelling terms) are 2.5e-3 (relative L2) from a float64 evaluation
of the same loss at the same params; the port's are 2e-6 from it. Step 2's
gradients are therefore held to that float64 run at 1e-4 and to the JAX
step at 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spatialaudiogen_tpu.config import TrainConfig as JaxTrainConfig
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.train.lr import make_optimizer as jax_make_optimizer
from spatialaudiogen_tpu.train.lr import staircase_decay as jax_staircase
from spatialaudiogen_tpu.train.state import create_train_state
from spatialaudiogen_tpu.train.steps import make_train_step
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.models.convert import from_flax, to_flax
from spatialaudiogen_tpu_torch.models.metrics import training_loss
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.train.lr import (
    clip_by_global_norm,
    make_optimizer,
    staircase_decay,
)
from spatialaudiogen_tpu_torch.train.state import TrainState
from spatialaudiogen_tpu_torch.train.steps import split_batch, train_step

CFG = dict(encoders=("audio", "video"), separation="unet_mask", num_sep_tracks=8,
           frame_hw=(64, 128), batch_size=3)
LR = 1e-4


def flat(tree: dict) -> dict:
    return {"/".join(k.key for k in path): np.array(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def capture_grads():
    """Identity gradient transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def batches(g, n: int) -> list:
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        b = {"ambix": (0.1 * rng.randn(3, g.snd_size, 4)).astype(np.float32),
             "audio_mask": np.ones((3, 4), np.float32),
             "video": rng.randint(0, 256, (3, 1) + CFG["frame_hw"] + (3,)).astype(np.uint8)}
        b["audio_mask"][1, 2] = 0.0          # a WXY clip: Z masked
        out.append(b)
    return out


def torch_snapshot(model) -> tuple[dict, dict]:
    """(params and batch_stats, gradients), flat JAX layout, copied."""
    values = {k: v.copy() for k, v in to_flax(model.state_dict()).items()}
    grads = {k: v.copy() for k, v in
             to_flax({n: p.grad for n, p in model.named_parameters()}).items()}
    return values, grads


@pytest.fixture(scope="module")
def runs():
    jcfg = JaxTrainConfig(**CFG)
    g = jcfg.model_config().geometry
    b1, b2 = batches(g, 2)

    jmodel = JaxModel(jcfg.model_config())
    tx = optax.chain(capture_grads(), jax_make_optimizer())
    s0 = create_train_state(jmodel, tx, jax.random.PRNGKey(0), b1)
    step = jax.jit(make_train_step(jmodel, tx))
    s1, m1 = step(s0, b1)
    s2, m2 = step(s1, b2)
    jax_runs = []
    for s, m in ((s1, m1), (s2, m2)):
        jax_runs.append({"loss": float(m["total_loss"]),
                         "values": flat({"params": s.params, "batch_stats": s.batch_stats}),
                         "grads": flat({"params": s.opt_state[0]})})
    v0 = flat({"params": s0.params, "batch_stats": s0.batch_stats})
    v1 = jax_runs[0]["values"]

    model = SptAudioGen(TrainConfig(**CFG).model_config(), frame_hw=CFG["frame_hw"])
    model.load_state_dict(from_flax(v0), strict=True)
    state = TrainState(model, make_optimizer(model.parameters(), LR))
    torch_runs = []
    for i, b in enumerate((b1, b2)):
        if i == 1:
            # the second step starts from the JAX params and batch_stats,
            # with the port's Adam state: it checks Adam at t = 2 (moments,
            # bias correction) without inheriting step 1's ulp differences
            model.load_state_dict(from_flax(v1), strict=True)
        metrics = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()}, LR)
        values, grads = torch_snapshot(model)
        torch_runs.append({"loss": float(metrics["total_loss"]), "values": values,
                           "grads": grads, "metrics": metrics})
    torch_runs[1]["grads64"] = float64_grads(v1, b2)
    return jax_runs, torch_runs, m1


def float64_grads(values: dict, batch: dict) -> dict:
    """The port's loss gradient in float64 at `values` on `batch`."""
    model = SptAudioGen(TrainConfig(**CFG).model_config(), frame_hw=CFG["frame_hw"])
    model.load_state_dict(from_flax(values), strict=True)
    model.double()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    audio, video, _, target, mask = split_batch(b, model.cfg.geometry)
    pred = model(audio.double(), video.double(), train=True)
    total, _ = training_loss(pred, target.double(), mask.double(), model.cfg.audio_rate,
                             model=model, decay_exclude=model.no_decay_paths())
    total.backward()
    return to_flax({n: p.grad for n, p in model.named_parameters()})


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_loss_matches(runs, i):
    jax_runs, torch_runs, _ = runs
    assert torch_runs[i]["loss"] == pytest.approx(jax_runs[i]["loss"], rel=1e-5)


def test_metrics_match(runs):
    """Every metric the JAX step returns, at the loss's tolerance (the pow/
    and snr/ diagnostics included)."""
    jax_runs, torch_runs, m1 = runs
    got = torch_runs[0]["metrics"]
    assert set(got) == set(m1)
    for k, v in m1.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_gradients_match(runs, i):
    """Each gradient leaf at relative L2 <= 1e-4 (float32 reduction order
    through the network, its backward and two DFTs); at step 2 against the
    float64 run, and against the JAX step at 5e-3 (see the finding above)."""
    jax_runs, torch_runs, _ = runs
    want, got = jax_runs[i]["grads"], torch_runs[i]["grads"]
    assert set(want) == set(got)
    for k, v in want.items():
        if i == 0:
            assert _rel_l2(got[k], v) <= 1e-4, (k, _rel_l2(got[k], v))
        else:
            exact = torch_runs[i]["grads64"][k]
            assert _rel_l2(got[k], exact) <= 1e-4, (k, _rel_l2(got[k], exact))
            assert _rel_l2(got[k], v) <= 5e-3, (k, _rel_l2(got[k], v))


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_params_after_adam_match(runs, i):
    """Params after the Adam update at atol 2e-6, skipping entries whose
    gradient is under 1e-7 or, at this step or the one before, differs
    between the packages by more than 2% (float32 noise: batch-statistics
    BN makes most visual-encoder kernel gradients cancel to near zero, and
    Adam's first steps move an entry by about lr whatever its size, so an
    entry whose sign is noise may step either way). Under 1% of the
    entries are skipped."""
    jax_runs, torch_runs, _ = runs
    want, got = jax_runs[i]["values"], torch_runs[i]["values"]
    skipped = total = 0
    for k, v in want.items():
        if not k.startswith("params/"):
            continue
        noise = np.zeros(v.shape, bool)
        for j in range(i + 1):
            gj, gt = jax_runs[j]["grads"][k], torch_runs[j]["grads"][k]
            noise |= (np.abs(gj) < 1e-7) | (np.abs(gt - gj) > 0.02 * np.abs(gj))
        skipped += int(noise.sum())
        total += v.size
        diff = np.where(noise, 0.0, np.abs(got[k] - v))
        assert diff.max() <= 2e-6, (k, float(diff.max()))
    assert skipped < 0.01 * total, (skipped, total)


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_batch_stats_match(runs, i):
    """Running averages moved by the step (momentum 0.99, biased variance):
    atol 1e-5 on values of order one."""
    jax_runs, torch_runs, _ = runs
    want, got = jax_runs[i]["values"], torch_runs[i]["values"]
    keys = [k for k in want if k.startswith("batch_stats/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5, err_msg=k)


def test_staircase_lr_boundary_changes_update_scale():
    """The staircase schedule halves Adam's update at the decay boundary
    (ported from tests/test_trainer.py)."""
    sched = staircase_decay(1e-4, 0.5, 250000)
    jsched = jax_staircase(1e-4, 0.5, 250000)
    for step in (0, 249999, 250000, 500000):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6)
    assert sched(249999) == pytest.approx(1e-4)
    assert sched(250000) == pytest.approx(5e-5)

    w = torch.zeros(4, requires_grad=True)
    opt = make_optimizer([w], 1e-3)
    lr = staircase_decay(1e-3, 0.5, 10)
    deltas = []
    for step in range(20):
        w.grad = torch.ones(4)
        before = w.detach().clone()
        for group in opt.param_groups:
            group["lr"] = lr(step)
        opt.step()
        deltas.append(float((w.detach() - before).abs().max()))
    assert deltas[9] == pytest.approx(deltas[8], rel=0.05)
    assert deltas[10] == pytest.approx(0.5 * deltas[9], rel=0.05)
    assert deltas[19] == pytest.approx(0.5 * deltas[8], rel=0.05)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(1)
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(x) for x in grads], optax.EmptyState())
    got = [torch.from_numpy(x.copy()) for x in grads]
    clip_by_global_norm(got, max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
