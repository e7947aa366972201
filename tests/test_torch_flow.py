"""The reference's default model, audio + flow + video encoders, in the port
against the JAX package: the flow readers (jpg and packed), the feeder's
flow key, the forward and two train steps at the same weights, and the
deploy engine's per-window host path.

Reduced flagship, as the other parity tests: flagship audio geometry,
unet_mask with 8 tracks, 64x128 frames and flow maps, batch 3 (deploy
over 5 windows at batch 3, so its last batch carries a pad lane). At
batch 2 the visual encoders' batch-statistics BatchNorm makes their
first layers' float32 gradients ill-conditioned (2e-3 from float64 in the
port, 1.4e-2 in JAX), so the train steps run at batch 3. Inputs
come from numpy seeds; the JAX side runs on the CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spatialaudiogen_tpu.config import TrainConfig as JaxTrainConfig
from spatialaudiogen_tpu.data import packed as jax_packed
from spatialaudiogen_tpu.data import readers as jax_readers
from spatialaudiogen_tpu.data.pipeline import Feeder as JaxFeeder
from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu.deploy.deploy import MonoToAmbix as JaxMonoToAmbix
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.train.checkpoint import save_checkpoint
from spatialaudiogen_tpu.train.lr import make_optimizer as jax_make_optimizer
from spatialaudiogen_tpu.train.state import create_train_state
from spatialaudiogen_tpu.train.steps import make_train_step
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.data import packed, readers
from spatialaudiogen_tpu_torch.data.pipeline import Feeder
from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
from spatialaudiogen_tpu_torch.models.convert import from_flax, load_params, save_params, to_flax
from spatialaudiogen_tpu_torch.models.metrics import training_loss
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.train.lr import make_optimizer
from spatialaudiogen_tpu_torch.train.state import TrainState
from spatialaudiogen_tpu_torch.train.steps import split_batch, train_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from export_torch_weights import export  # noqa: E402

FRAME_HW = (64, 128)
ENCODERS = ("audio", "flow", "video")
NB = 3   # train batch
CFG = dict(encoders=ENCODERS, separation="unet_mask", num_sep_tracks=8,
           frame_hw=FRAME_HW, batch_size=NB)
LR = 1e-4



def flat(tree: dict) -> dict:
    return {"/".join(k.key for k in path): np.array(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def flowdb(tmp_path_factory):
    """Two 3 s synthetic clips with flow (30 frames each); the second is
    also packed (flow.npy + flow_lims.npy beside the jpgs)."""
    root = str(tmp_path_factory.mktemp("torchflowdb"))
    ids = sorted(make_synthetic_dataset(root, n_videos=2, duration=3.0, frame_hw=FRAME_HW,
                                        with_flow=True, seed=7))
    jax_packed.pack_video(os.path.join(root, ids[1]))
    return root, [os.path.join(root, i) for i in ids]


# ---------------------------------------------------------------------------
# readers and feeder


WINDOWS = [  # start time, frames, rotation
    (1.0, 1, None),
    (2.2, 5, 1.3),       # a rotation rolls the flow pixels along W
    (2.8, 5, -2.0),      # overruns the 30 frames: indices clamped into lims
]


@pytest.mark.parametrize("start, size, rotation", WINDOWS)
def test_flow_readers_match_jax(flowdb, start, size, rotation):
    """FlowFrameReader (jpg) and PackedFlowReader (packed) against the JAX
    readers, bit for bit: float32 (dx, dy, mag) maps."""
    _, (jpg, pk) = flowdb
    flow_dir = os.path.join(jpg, "flow")
    lims = os.path.join(flow_dir, "flow_limits.npy")
    pairs = [(readers.FlowFrameReader(flow_dir, lims, 10),
              jax_readers.FlowFrameReader(flow_dir, lims, 10)),
             (packed.PackedFlowReader(pk, 10), jax_packed.PackedFlowReader(pk, 10))]
    for mine, ref in pairs:
        got = mine.get_by_index(start, size, rotation)
        want = ref.get_by_index(start, size, rotation)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (size,) + FRAME_HW + (3,)
        np.testing.assert_array_equal(got, want)


def test_flow_rotation_rolls_pixels_and_keeps_angles(flowdb):
    """A rotation rolls the flow maps along W and leaves the vectors as they
    are (the reference's behaviour)."""
    _, (_, pk) = flowdb
    reader = packed.PackedFlowReader(pk, 10)
    plain = reader.get_by_index(1.5, 2)
    rolled = reader.get_by_index(1.5, 2, rotation=np.pi / 2)
    shift = -int((np.pi / 2) / (2 * np.pi) * FRAME_HW[1])
    np.testing.assert_array_equal(rolled, np.roll(plain, shift, axis=2))


@pytest.mark.parametrize("clip", [0, 1], ids=["jpg", "packed"])
def test_sample_reader_gives_flow(flowdb, clip):
    """SampleReader(return_flow=True) with random rotations gives the JAX
    reader's chunks: audio, frames and flow, bit for bit."""
    _, folders = flowdb
    kw = dict(return_video=True, return_flow=True, shuffle=True, random_rotations=True)
    mine = readers.SampleReader(folders[clip], img_prep=readers.img_prep_u8,
                                rng=np.random.RandomState(3), **kw)
    ref = jax_readers.SampleReader(folders[clip], img_prep=jax_readers.img_prep_u8,
                                   rng=np.random.RandomState(3), **kw)
    assert type(mine.flow_reader).__name__ == type(ref.flow_reader).__name__
    for _ in range(3):
        a, b = mine.get(), ref.get()
        assert a["id"] == b["id"] and set(a) == set(b)
        assert a["flow"].dtype == np.float32
        for key in ("ambix", "video", "flow"):
            np.testing.assert_array_equal(a[key], b[key])


def test_feeder_stacks_flow(flowdb):
    """The train feeder with flow: batches carry a float32 `flow` key
    stacked as the JAX feeder stacks it."""
    root, _ = flowdb
    kw = dict(batch_size=2, n_workers=1, for_eval=False, seed=5, return_video=True,
              return_flow=True)
    out = []
    for feeder in (Feeder(root, img_prep=readers.img_prep_u8, **kw),
                   JaxFeeder(root, img_prep=jax_readers.img_prep_u8, **kw)):
        feeder.start()
        try:
            out.append(next(feeder.batches()))
        finally:
            feeder.stop()
    mine, ref = out
    assert mine["id"] == ref["id"] and set(mine) == set(ref)
    assert mine["flow"].shape == (2, 1) + FRAME_HW + (3,) and mine["flow"].dtype == np.float32
    for key in ("ambix", "video", "flow", "audio_mask"):
        np.testing.assert_array_equal(mine[key], ref[key])


# ---------------------------------------------------------------------------
# forward and train steps


def capture_grads():
    """Identity gradient transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def batches(g, n: int) -> list:
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        out.append({
            "ambix": (0.1 * rng.randn(NB, g.snd_size, 4)).astype(np.float32),
            "audio_mask": np.ones((NB, 4), np.float32),
            "video": rng.randint(0, 256, (NB, 1) + FRAME_HW + (3,)).astype(np.uint8),
            "flow": rng.randn(NB, 1, *FRAME_HW, 3).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def runs():
    """The JAX train step twice from its own init, and the port's step at
    the same weights on the same batches; the port's forward in eval mode
    against JAX's apply; the port's step-2 gradients in float64."""
    jcfg = JaxTrainConfig(**CFG)
    g = jcfg.model_config().geometry
    b1, b2 = batches(g, 2)
    jmodel = JaxModel(jcfg.model_config())
    tx = optax.chain(capture_grads(), jax_make_optimizer())
    s0 = create_train_state(jmodel, tx, jax.random.PRNGKey(0), b1)
    v0 = flat({"params": s0.params, "batch_stats": s0.batch_stats})
    video = b1["video"].astype(np.float32) / 255.0 - 0.5
    audio = b1["ambix"][:, :, :1]
    fwd = np.asarray(jmodel.apply({"params": s0.params, "batch_stats": s0.batch_stats},
                                  audio, video, b1["flow"], train=False))
    step = jax.jit(make_train_step(jmodel, tx))
    s1, m1 = step(s0, b1)
    s2, m2 = step(s1, b2)
    jax_runs = [{"loss": float(m["total_loss"]), "grads": flat({"params": s.opt_state[0]}),
                 "values": flat({"params": s.params, "batch_stats": s.batch_stats})}
                for s, m in ((s1, m1), (s2, m2))]

    model = SptAudioGen(TrainConfig(**CFG).model_config(), frame_hw=FRAME_HW)
    model.load_state_dict(from_flax(v0), strict=True)
    with torch.no_grad():
        got_fwd = model(*(torch.from_numpy(x) for x in (audio, video, b1["flow"]))).numpy()
    state = TrainState(model, make_optimizer(model.parameters(), LR))
    torch_runs = []
    for i, b in enumerate((b1, b2)):
        if i == 1:   # step 2 from JAX's step-1 values, as test_torch_train_step
            model.load_state_dict(from_flax(jax_runs[0]["values"]), strict=True)
        metrics = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()}, LR)
        torch_runs.append({"loss": float(metrics["total_loss"]), "grads": {
            k: v.copy() for k, v in
            to_flax({n: p.grad for n, p in model.named_parameters()}).items()}})
    for run, values, b in zip(torch_runs, (v0, jax_runs[0]["values"]), (b1, b2)):
        run["grads64"] = float64_grads(values, b)
    return {"v0": v0, "fwd": (fwd, got_fwd), "jax": jax_runs, "torch": torch_runs}


def float64_grads(values: dict, batch: dict) -> dict:
    model = SptAudioGen(TrainConfig(**CFG).model_config(), frame_hw=FRAME_HW)
    model.load_state_dict(from_flax(values), strict=True)
    model.double()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    audio, video, flow, target, mask = split_batch(b, model.cfg.geometry)
    pred = model(audio.double(), video.double(), flow.double(), train=True)
    total, _ = training_loss(pred, target.double(), mask.double(), model.cfg.audio_rate,
                             model=model, decay_exclude=model.no_decay_paths())
    total.backward()
    return to_flax({n: p.grad for n, p in model.named_parameters()})


def test_flow_encoder_weights_carry_across(runs, tmp_path):
    """The flow encoder is its own ResNet18: its JAX weights land on
    flow_encoder.*, apart from video_encoder.*, and survive save_params /
    load_params with no key collision."""
    v0 = runs["v0"]
    sd = from_flax(v0)
    flow_keys = {k[len("flow_encoder."):] for k in sd if k.startswith("flow_encoder.")}
    video_keys = {k[len("video_encoder."):] for k in sd if k.startswith("video_encoder.")}
    assert flow_keys and flow_keys == video_keys
    assert any(not torch.equal(sd["flow_encoder." + k], sd["video_encoder." + k])
               for k in flow_keys if k.endswith("weight"))
    save_params(str(tmp_path), sd)
    back = load_params(str(tmp_path))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    assert set(to_flax(back)) == set(v0)


def test_default_model_forward_matches_jax(runs):
    """audio + flow + video forward at the JAX init: relative L2 <= 1e-4
    (float32 reduction order, as tests/test_torch_model.py)."""
    want, got = runs["fwd"]
    assert got.shape == want.shape == (NB, 4800, 3) and np.isfinite(got).all()
    assert rel_l2(got, want) <= 1e-4, rel_l2(got, want)


def _flat(grads: dict) -> np.ndarray:
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_default_model_train_steps_match_jax(runs, i):
    """Two train steps: the loss at 1e-5 of JAX's, and the gradients against
    a float64 run of the same loss at the same params and against the JAX
    step.

    Step 1: each leaf (flow encoder included) at relative L2 1e-4 of the
    float64 run and 1e-2 of JAX's: the JAX step's own float32 gradients of
    the small separation U-Net leaves (deconv3-5, fc-feats) are up to
    7.6e-3 from the float64 run, the port's 2.7e-6.
    Step 2 (from JAX's step-1 params): the visual encoders' leaves are
    sensitive to float32 rounding in both packages, 1-2% from the float64
    run in the port (video and flow encoders) and in JAX (flow encoder), and
    the whole gradient is 1.7e-3 (port) and 1.7e-3 (JAX) from it. So every
    leaf outside the visual encoders at 1e-4 of the float64 run, and the
    whole gradient at 5e-3 of the float64 run and of JAX's."""
    jax_run, torch_run = runs["jax"][i], runs["torch"][i]
    assert torch_run["loss"] == pytest.approx(jax_run["loss"], rel=1e-5)
    want, got, exact = jax_run["grads"], torch_run["grads"], torch_run["grads64"]
    assert set(want) == set(got) == set(exact)
    assert any(k.startswith("params/flow_encoder/") for k in got)
    visual = ("params/video_encoder/", "params/flow_encoder/")
    for k, v in want.items():
        if i == 0 or not k.startswith(visual):
            assert rel_l2(got[k], exact[k]) <= 1e-4, (k, rel_l2(got[k], exact[k]))
        if i == 0:
            assert rel_l2(got[k], v) <= 1e-2, (k, rel_l2(got[k], v))
    if i == 1:
        errs = (rel_l2(_flat(got), _flat(exact)), rel_l2(_flat(got), _flat(want)))
        assert max(errs) <= 5e-3, errs


# ---------------------------------------------------------------------------
# deploy: per-window host assembly

START, DURATION, BATCH = 0.5, 0.5, 3


@pytest.fixture(scope="module")
def deployed(flowdb, tmp_path_factory):
    """A JAX audio+flow+video model dir, exported; the JAX engine (its host
    path, which flow configs take) and the port deploy the packed clip over
    5 windows at batch 3, and the port once more in float64."""
    _, (_, clip) = flowdb
    model_dir = str(tmp_path_factory.mktemp("torchflowmodel"))
    cfg = JaxTrainConfig(model_dir=model_dir, n_data=1, **CFG)
    cfg.save()
    g = cfg.model_config().geometry
    example = {"ambix": np.zeros((1, g.snd_size, 4), np.float32),
               "audio_mask": np.ones((1, 4), np.float32),
               "video": np.zeros((1, g.vid_dur) + FRAME_HW + (3,), np.float32),
               "flow": np.zeros((1, g.vid_dur) + FRAME_HW + (3,), np.float32)}
    state = create_train_state(JaxModel(cfg.model_config()), jax_make_optimizer(),
                               jax.random.PRNGKey(3), example)
    save_checkpoint(model_dir, state, 1)
    export(model_dir)
    ref = JaxMonoToAmbix(model_dir, batch_size=BATCH, f16_fetch=False).deploy(
        clip, START, DURATION)
    got = MonoToAmbix(model_dir, batch_size=BATCH, device="cpu").deploy(clip, START, DURATION)
    exact = MonoToAmbix(model_dir, batch_size=BATCH, device="cpu")
    exact.model.double()
    return ref, got, exact.deploy(clip, START, DURATION), model_dir, clip


def test_flow_deploy_matches_jax_host_path(deployed):
    """The W passthrough bit for bit; predictions within 2e-5 of the port's
    float64 run and within 2.5e-4 of the JAX engine (whose own float32
    error against the float64 run is of that order through the visual
    encoders' batch-statistics BatchNorm; tests/test_torch_deploy.py). The
    last batch holds 2 real windows and 1 zero pad lane, kept in the
    forward as the JAX engine keeps it."""
    ref, got, f64, _, _ = deployed
    assert got.shape == ref.shape == f64.shape == (int(DURATION * 48000), 4)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    errs = {"port-f64": rel_l2(got[:, 1:], f64[:, 1:]),
            "jax-f64": rel_l2(ref[:, 1:], f64[:, 1:]),
            "port-jax": rel_l2(got[:, 1:], ref[:, 1:])}
    assert errs["port-f64"] <= 2e-5, errs
    assert errs["jax-f64"] <= 2.5e-4 and errs["port-jax"] <= 2.5e-4, errs


def test_flow_deploy_pads_the_last_batch(deployed):
    """The partial last batch is padded, not shrunk: its real windows see
    the pad lane through the batch statistics, so they differ from the same
    windows run as a batch of their own."""
    _, got, _, model_dir, clip = deployed
    engine = MonoToAmbix(model_dir, batch_size=BATCH, device="cpu")
    reader = engine._reader(clip, START, DURATION)
    n, audio, video, flow, _ = list(engine._window_batches(reader))[-1]
    assert (n, audio.shape[0]) == (2, BATCH)
    assert not audio[n:].any() and not video[n:].any() and not flow[n:].any()
    with torch.no_grad():
        padded = engine.model(*(torch.from_numpy(x) for x in (audio, video, flow)))[:n]
        alone = engine.model(*(torch.from_numpy(x[:n]) for x in (audio, video, flow)))
    tail = got[-n * 4800:, 1:]
    np.testing.assert_array_equal(padded.reshape(-1, 3).numpy(), tail)
    assert rel_l2(alone.reshape(-1, 3).numpy(), tail) > 1e-6
