"""The port's model ends and observe step against the JAX package's
return_ends and make_observe_step, the TensorBoard histogram tags the
trainer writes, and the eval step's deterministic cuDNN.

Reduced flagship (audio + video, unet_mask with 8 tracks, 64x128 frames,
batch 3), JAX-initialised weights in both packages, one batch with a WXY
row (Z masked):

  * return_ends: JAX's keys, each value within relative L2 1e-4 of JAX's
    (the forward's tolerance, tests/test_torch_model.py);
  * observe_step's gradients within relative L2 1e-4 per leaf of a
    float64 evaluation of the same loss, and of make_observe_step's within
    1e-4 plus the JAX leaf's own distance from that float64 run (as
    tests/test_torch_train_step.py holds the train step: on this batch the
    float32 JAX gradient of separation/deconv5's bias, built from
    cancelling terms, is 6.5e-3 from the port's);
  * it leaves no trace: a train step after an observe step equals one
    without it bit for bit, the BN running averages and .grad untouched;
  * the trainer's histogram names (to_flax paths under params/, grads/,
    acts/) are the tags the JAX trainer writes for the same trees, and
    decode through the JAX package's decoder with the same counts;
  * the eval step convolves with cudnn.deterministic on at every
    convolution, and restores the switch.
"""

import glob

import jax
import numpy as np
import optax
import pytest
import torch

from spatialaudiogen_tpu.config import TrainConfig as JaxTrainConfig
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.train.state import create_train_state as jax_create_train_state
from spatialaudiogen_tpu.train.steps import make_observe_step
from spatialaudiogen_tpu.utils.logging import MetricLogger as JaxLogger
from spatialaudiogen_tpu.utils.tensorboard import decode_histograms
from spatialaudiogen_tpu_torch.config import TrainConfig
from spatialaudiogen_tpu_torch.models.convert import from_flax, to_flax
from spatialaudiogen_tpu_torch.models.metrics import training_loss
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.train.lr import make_optimizer
from spatialaudiogen_tpu_torch.train.state import TrainState
from spatialaudiogen_tpu_torch.train.steps import (
    eval_step,
    observe_step,
    split_batch,
    train_step,
)
from spatialaudiogen_tpu_torch.train.trainer import jax_names
from spatialaudiogen_tpu_torch.utils.logging import MetricLogger

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


def flat(tree: dict) -> dict:
    return {"/".join(k.key for k in path): np.array(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_batch(g) -> dict:
    rng = np.random.RandomState(11)
    b = {"ambix": (0.1 * rng.randn(3, g.snd_size, 4)).astype(np.float32),
         "audio_mask": np.ones((3, 4), np.float32),
         "video": rng.randint(0, 256, (3, 1) + CFG["frame_hw"] + (3,)).astype(np.uint8)}
    b["audio_mask"][0, 2] = 0.0
    return b


def port_state(v0) -> TrainState:
    model = SptAudioGen(TrainConfig(**CFG).model_config(), frame_hw=CFG["frame_hw"])
    model.load_state_dict(from_flax(v0), strict=True)
    return TrainState(model, make_optimizer(model.parameters(), 1e-4))


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxTrainConfig(**CFG)
    batch = make_batch(jcfg.model_config().geometry)
    jmodel = JaxModel(jcfg.model_config())
    state = jax_create_train_state(jmodel, optax.adam(1e-4), jax.random.PRNGKey(0), batch)
    grads, ends = jax.jit(make_observe_step(jmodel, with_ends=True))(state, batch)
    v0 = flat({"params": state.params, "batch_stats": state.batch_stats})
    return {"batch": batch, "v0": v0, "jax_grads": jax.device_get(grads),
            "jax_ends": {k: np.asarray(v) for k, v in ends.items()}}


@pytest.fixture(scope="module")
def observed(setup):
    state = port_state(setup["v0"])
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    grads, ends = observe_step(state, batch, with_ends=True)
    return state, before, grads, ends


def test_ends_match_jax(setup, observed):
    _, _, _, ends = observed
    assert set(ends) == set(setup["jax_ends"])
    for k, want in setup["jax_ends"].items():
        got = ends[k].numpy()
        assert got.shape == want.shape, (k, got.shape, want.shape)
        assert rel_l2(got, want) <= 1e-4, (k, rel_l2(got, want))


def test_ends_of_a_plain_forward(setup):
    """return_ends on the forward alone: the same output as without it."""
    state = port_state(setup["v0"])
    audio = torch.from_numpy(setup["batch"]["ambix"][:, :, :1])
    video = torch.from_numpy(setup["batch"]["video"]).float() / 255.0 - 0.5
    with torch.no_grad():
        out, ends = state.model(audio, video, return_ends=True)
        plain = state.model(audio, video)
    assert torch.equal(out, plain) and torch.equal(ends["decoder/ambix"], out)


def float64_grads(v0, batch: dict) -> dict:
    """The port's training-loss gradient in float64 at `v0` on `batch`."""
    state = port_state(v0)
    state.model.double()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    audio, video, _, target, mask = split_batch(b, state.model.cfg.geometry)
    pred = state.model(audio.double(), video.double(), train=True, update_stats=False)
    total, _ = training_loss(pred, target.double(), mask.double(),
                             state.model.cfg.audio_rate, model=state.model,
                             decay_exclude=state.model.no_decay_paths())
    total.backward()
    return to_flax({n: p.grad for n, p in state.model.named_parameters()})


def test_observe_gradients_match_jax(setup, observed):
    _, _, grads, _ = observed
    want = flat({"params": setup["jax_grads"]})
    exact = float64_grads(setup["v0"], setup["batch"])
    got = to_flax(grads)
    assert set(got) == set(want)
    for k, v in want.items():
        assert rel_l2(got[k], exact[k]) <= 1e-4, (k, rel_l2(got[k], exact[k]))
        assert rel_l2(got[k], v) <= 1e-4 + rel_l2(v, exact[k]), (k, rel_l2(got[k], v))


def test_observe_leaves_no_trace(setup, observed):
    state, before, _, _ = observed
    after = state.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before), "state moved"
    assert all(p.grad is None for p in state.model.parameters())
    assert not state.optimizer.state and state.step == 0

    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    plain = port_state(setup["v0"])
    m_plain = train_step(plain, batch, 1e-4)
    m_obs = train_step(state, batch, 1e-4)
    assert float(m_obs["total_loss"]) == float(m_plain["total_loss"])
    for (k, a), b in zip(plain.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_histogram_tags_are_the_jax_trainers(setup, observed, tmp_path):
    """The trainer's histograms (params, observe grads, acts) decode through
    the JAX package's decoder to the tags the JAX MetricLogger writes for
    the JAX trees, with the same element counts."""
    _, _, grads, ends = observed
    state = port_state(setup["v0"])
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    logger = MetricLogger(str(port_dir))
    logger.log_histograms(0, jax_names(dict(state.model.named_parameters())), "params")
    logger.log_histograms(0, jax_names(grads), "grads")
    logger.log_histograms(0, ends, "acts")
    logger.close()
    params = {k.split("/", 1)[1]: v for k, v in setup["v0"].items()
              if k.startswith("params/")}
    jlogger = JaxLogger(str(jax_dir))
    jlogger.log_histograms(0, jax.tree_util.tree_map(np.asarray, _nest(params)))
    jlogger.log_histograms(0, setup["jax_grads"], prefix="grads")
    jlogger.log_histograms(0, setup["jax_ends"], prefix="acts")
    jlogger.close()

    def decoded(d):
        return {tag: (num, mn, mx) for tag, mn, mx, num, _ in
                decode_histograms(glob.glob(str(d / "events.out.tfevents.*"))[0])}

    got, want = decoded(port_dir), decoded(jax_dir)
    assert set(got) == set(want)
    for tag, (num, mn, mx) in want.items():
        assert got[tag][0] == num, tag
        if tag.startswith("params/"):
            assert (got[tag][1], got[tag][2]) == (mn, mx), tag


def _nest(flat_params: dict) -> dict:
    tree: dict = {}
    for key, val in flat_params.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


class _CudnnLog(torch.overrides.TorchFunctionMode):
    """Records torch.backends.cudnn.deterministic at every convolution."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("conv2d", "conv_transpose2d"):
            self.seen.append((func.__name__, torch.backends.cudnn.deterministic))
        return func(*args, **(kwargs or {}))


def test_eval_step_runs_deterministic_cudnn(setup):
    """The eval step's forward convolves, its U-Net's transposed
    convolutions included, with cudnn.deterministic on, and restores the
    switch it found (cuDNN's default algorithms differ run to run in the
    last bit on the card)."""
    state = port_state(setup["v0"])
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    log = _CudnnLog()
    with log:
        eval_step(state.model, batch)
    assert not torch.backends.cudnn.deterministic
    assert {kind for kind, _ in log.seen} == {"conv2d", "conv_transpose2d"}
    assert all(on for _, on in log.seen), log.seen[:3]
