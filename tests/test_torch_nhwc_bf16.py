"""The slice of the NHWC-mask configuration and bf16 compute: the port's
model against the JAX package's at the same weights (through the weight
bridge) and the same inputs.

Reduced flagship, as tests/test_torch_model.py: audio + video encoders,
unet_mask head with 8 tracks, 64x128 frames, batch 3.

  * pallas_nhwc=True: the port runs the separation U-Net channels_last and
    K3's plain version on CPU tensors; the JAX model runs use_pallas="on",
    pallas_nhwc=True with masked_istft_nhwc_pallas in interpret mode, as
    tests/test_model.py:140-171 does.
  * dtype bfloat16: the forward and one train step against the JAX model
    and make_train_step with dtype=jnp.bfloat16, each also held to its own
    float32 run, as tests/test_higher_order.py:69-80 and
    tests/test_trainer.py:137-155 hold the JAX bf16 mode to float32 masters
    and finite results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import spatialaudiogen_tpu.models.sptaudiogen as jax_model_module
import spatialaudiogen_tpu.ops.pallas_kernels as jax_kernels
from spatialaudiogen_tpu.config import TrainConfig as JaxTrainConfig
from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.models import SptAudioGenConfig as JaxConfig
from spatialaudiogen_tpu.train.lr import make_optimizer as jax_make_optimizer
from spatialaudiogen_tpu.train.state import create_train_state
from spatialaudiogen_tpu.train.steps import make_train_step
from spatialaudiogen_tpu_torch.config import SptAudioGenConfig, TrainConfig
from spatialaudiogen_tpu_torch.models.convert import from_flax, to_flax
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.train.lr import make_optimizer
from spatialaudiogen_tpu_torch.train.state import TrainState
from spatialaudiogen_tpu_torch.train.steps import train_step

FRAME_HW = (64, 128)
TRACKS = 8
BATCH = 3
LR = 1e-4


def flat(tree) -> dict:
    return {"/".join(k.key for k in path): np.array(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def inputs():
    cfg = JaxConfig(encoders=("audio", "video"), separation="unet_mask",
                    sep_num_tracks=TRACKS)
    g = cfg.geometry
    rng = np.random.RandomState(0)
    audio = (rng.randn(BATCH, g.snd_size, 1) * 0.1).astype(np.float32)
    video = (rng.rand(BATCH, g.vid_dur, *FRAME_HW, 3) - 0.5).astype(np.float32)
    variables = JaxModel(cfg).init(jax.random.PRNGKey(0), audio[:1], video[:1], train=False)
    return audio, video, variables


def _port(variables, **cfg):
    model = SptAudioGen(SptAudioGenConfig(sep_num_tracks=TRACKS, **cfg), frame_hw=FRAME_HW)
    model.load_state_dict(from_flax(flat(variables)), strict=True)
    return model


def _jax(audio, video, variables, **cfg):
    model = JaxModel(JaxConfig(encoders=("audio", "video"), separation="unet_mask",
                               sep_num_tracks=TRACKS, **cfg))
    out, state = model.apply(variables, audio, video, train=False, mutable=["intermediates"])
    return np.asarray(out), np.asarray(state["intermediates"]["separation"]["mask"][0])


@pytest.fixture(scope="module")
def nhwc(inputs):
    audio, video, variables = inputs
    orig = jax_kernels.masked_istft_nhwc_pallas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model_module, "_pallas_enabled", lambda mode: mode != "off")
        mp.setattr(jax_kernels, "masked_istft_nhwc_pallas",
                   lambda re, im, m, n, _i, _p: orig(re, im, m, n, True, "highest"))
        ref = _jax(audio, video, variables, use_pallas="on", pallas_nhwc=True)
    got = {}
    for name, cfg in (("nhwc", {"pallas_nhwc": True}), ("nchw", {})):
        taps = {}
        with torch.no_grad():
            out = _port(variables, **cfg)(torch.from_numpy(audio), torch.from_numpy(video),
                                          taps=taps)
        got[name] = out.numpy(), taps["mask"]
    return ref, got


def test_nhwc_forward_matches_jax(nhwc):
    """Output at tests/test_pallas.py's forward tolerance (2e-4 / 1e-4),
    the mask tap at tests/test_model.py's 1e-6."""
    (ref_out, ref_mask), got = nhwc
    out, mask = got["nhwc"]
    assert out.shape == ref_out.shape == (BATCH, 4800, 3)
    np.testing.assert_allclose(out, ref_out, atol=2e-4, rtol=1e-4)
    assert mask.shape == ref_mask.shape
    np.testing.assert_allclose(mask.numpy(), ref_mask, atol=1e-6)


def test_nhwc_branch_reads_the_channels_last_mask(nhwc):
    """The port's pallas_nhwc forward went through the NHWC branch (the
    tracks are the innermost axis of the mask in memory) and agrees with
    its default NCHW forward up to float32 reduction order (the
    channels_last convolutions sum in another order): mask at 1e-6,
    output at 1e-5 relative L2."""
    _, got = nhwc
    mask_nhwc, mask_nchw = got["nhwc"][1], got["nchw"][1]
    assert mask_nhwc.stride(2) == 1 and mask_nchw.stride(-1) == 1
    torch.testing.assert_close(mask_nhwc, mask_nchw, atol=1e-6, rtol=0)
    assert rel_l2(got["nhwc"][0], got["nchw"][0]) <= 1e-5


def test_compute_dtype_is_checked():
    """bfloat16 is the one compute dtype besides float32, as in the JAX
    TrainConfig: float16 is refused by both configs."""
    assert TrainConfig(compute_dtype="bfloat16").model_config().dtype == torch.bfloat16
    assert TrainConfig().model_config().dtype is None
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainConfig(compute_dtype="float16").model_config()
    with pytest.raises(ValueError, match="dtype"):
        SptAudioGenConfig(dtype=torch.float16)


@pytest.fixture(scope="module")
def bf16_forward(inputs):
    audio, video, variables = inputs
    ref = {name: _jax(audio, video, variables, **cfg)[0]
           for name, cfg in (("f32", {}), ("bf16", {"dtype": jnp.bfloat16}))}
    got = {}
    for name, cfg in (("f32", {}), ("bf16", {"dtype": torch.bfloat16}),
                      ("bf16 nhwc", {"dtype": torch.bfloat16, "pallas_nhwc": True})):
        taps = {}
        with torch.no_grad():
            out = _port(variables, **cfg)(torch.from_numpy(audio), torch.from_numpy(video),
                                          taps=taps)
        got[name] = out, taps["mask"]
    return ref, got


def test_bf16_forward_matches_jax(bf16_forward):
    """bf16 rounds the conv, deconv and FC products (8-bit mantissa) in
    both packages, in different places: the port's bf16 output is 1.4e-2
    (relative L2) from the JAX one; the port's bf16 output is 2.5e-2 from
    its float32 one, the JAX one 3.0e-2. Limits: 2e-2 between the
    packages, 6e-2 against float32. The port must also move as far from
    float32 as JAX does, at least half of JAX's gap: a port that ran the
    products in float32 and rounded only the mask lands 4.5e-5 from its
    float32 output and 3.0e-2 from the JAX bf16 one."""
    ref, got = bf16_forward
    out, mask = got["bf16"]
    assert out.dtype == torch.float32 and mask.dtype == torch.bfloat16
    assert np.isfinite(out.numpy()).all()
    errs = {"port-jax": rel_l2(out, ref["bf16"]),
            "port-f32": rel_l2(out, got["f32"][0]),
            "jax-f32": rel_l2(ref["bf16"], ref["f32"])}
    assert errs["port-jax"] <= 2e-2, errs
    assert errs["port-f32"] <= 6e-2 and errs["jax-f32"] <= 6e-2, errs
    assert errs["port-f32"] >= 0.5 * errs["jax-f32"], errs
    # the NHWC branch's channels_last bf16 convolutions may round in other
    # places than the NCHW ones: a mask entry may move by one bf16 step
    # (4e-3 at 0.5). Here on the CPU both give the same mask, and outputs
    # 2e-8 apart.
    torch.testing.assert_close(got["bf16 nhwc"][1].float(), mask.float(), atol=4e-3, rtol=0)
    assert rel_l2(got["bf16 nhwc"][0], out) <= 1e-2


def capture_grads():
    """Identity gradient transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def bf16_steps():
    """One train step of each package from the same JAX-initialised
    weights and batch, float32 and bf16 compute."""
    cfg = dict(encoders=("audio", "video"), separation="unet_mask",
               num_sep_tracks=TRACKS, frame_hw=FRAME_HW, batch_size=BATCH)
    g = JaxTrainConfig(**cfg).model_config().geometry
    rng = np.random.RandomState(0)
    batch = {"ambix": (0.1 * rng.randn(BATCH, g.snd_size, 4)).astype(np.float32),
             "audio_mask": np.ones((BATCH, 4), np.float32),
             "video": rng.randint(0, 256, (BATCH, 1) + FRAME_HW + (3,)).astype(np.uint8)}
    runs = {}
    for dtype in ("float32", "bfloat16"):
        jmodel = JaxModel(JaxTrainConfig(compute_dtype=dtype, **cfg).model_config())
        tx = optax.chain(capture_grads(), jax_make_optimizer())
        s0 = create_train_state(jmodel, tx, jax.random.PRNGKey(0), batch)
        s1, m1 = jax.jit(make_train_step(jmodel, tx))(s0, batch)
        jgrads = flat({"params": s1.opt_state[0]})

        model = SptAudioGen(TrainConfig(compute_dtype=dtype, **cfg).model_config(),
                            frame_hw=FRAME_HW)
        model.load_state_dict(from_flax(flat({"params": s0.params,
                                              "batch_stats": s0.batch_stats})), strict=True)
        state = TrainState(model, make_optimizer(model.parameters(), LR))
        metrics = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, LR)
        tgrads = to_flax({n: p.grad for n, p in model.named_parameters()})
        names = sorted(jgrads)
        runs[dtype] = {
            "jax_loss": float(m1["total_loss"]), "port_loss": float(metrics["total_loss"]),
            "jax_grad": np.concatenate([jgrads[n].ravel() for n in names]),
            "port_grad": np.concatenate([tgrads[n].ravel() for n in names]),
            "jax_params": jax.tree_util.tree_leaves(s1.params),
            "port_state": state}
    return runs


def test_bf16_train_step_matches_jax(bf16_steps):
    """Params, gradients and Adam moments stay float32 in both packages
    (f32 masters); the loss is float32. The port's bf16 loss is 8e-5
    (relative) from the JAX bf16 loss and 3.5e-4 from its float32 loss
    (JAX: 2.7e-4): the STFT-MSE loss averages bf16 rounding over 4800x3
    samples. Limit 2e-3, and the port's bf16 loss must sit nearer the JAX
    bf16 loss than half of JAX's own bf16-float32 gap. The flattened
    gradient carries the rounding of every bf16 layer: the port's is 0.096
    (relative L2) from the JAX bf16 one and 0.092 from its float32 one
    (JAX: 0.077). Limit 0.2, and each package's bf16 run must move at
    least half as far from its float32 run as the other's does. A port
    that ran the products in float32 and rounded only the mask fails all
    three: its bf16 loss is its float32 loss, 2.7e-4 from the JAX bf16
    loss, and its gradient moves 6.7e-6. The float32 losses agree to
    1e-4, as tests/test_torch_train_step.py holds them."""
    f32, bf16 = bf16_steps["float32"], bf16_steps["bfloat16"]
    state = bf16["port_state"]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v) and v.dim())
    assert all(leaf.dtype == jnp.float32 for leaf in bf16["jax_params"])
    assert np.isfinite(bf16["port_loss"]) and np.isfinite(bf16["port_grad"]).all()
    for run in (f32, bf16):
        assert run["port_grad"].shape == run["jax_grad"].shape

    def rel(a, b):
        return abs(a - b) / abs(b)

    errs = {"loss port-jax": rel(bf16["port_loss"], bf16["jax_loss"]),
            "loss port-f32": rel(bf16["port_loss"], f32["port_loss"]),
            "loss jax-f32": rel(bf16["jax_loss"], f32["jax_loss"]),
            "grad port-jax": rel_l2(bf16["port_grad"], bf16["jax_grad"]),
            "grad port-f32": rel_l2(bf16["port_grad"], f32["port_grad"]),
            "grad jax-f32": rel_l2(bf16["jax_grad"], f32["jax_grad"]),
            "f32 loss port-jax": rel(f32["port_loss"], f32["jax_loss"])}
    assert all(errs[k] <= 2e-3 for k in ("loss port-jax", "loss port-f32", "loss jax-f32")), errs
    assert all(errs[k] <= 0.2 for k in ("grad port-jax", "grad port-f32", "grad jax-f32")), errs
    assert errs["loss port-jax"] <= 0.5 * errs["loss jax-f32"], errs
    assert 0.5 <= errs["grad port-f32"] / errs["grad jax-f32"] <= 2, errs
    assert errs["f32 loss port-jax"] <= 1e-4, errs
