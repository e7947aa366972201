"""The PyTorch SptAudioGen forward against the JAX SptAudioGen.apply at the
same weights (through the weight bridge) and the same inputs.

Reduced configuration, as __graft_entry__.dryrun_multichip uses: flagship
audio geometry, audio+video encoders, unet_mask head with 8 tracks, 64x128
frames, batch 3. The JAX side runs its own CPU route (the XLA masked
ISTFT); the port runs the kernel's plain version on CPU tensors.
"""

import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.models import SptAudioGen, SptAudioGenConfig
from spatialaudiogen_tpu_torch.config import SptAudioGenConfig as TorchConfig
from spatialaudiogen_tpu_torch.models.convert import from_flax
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen as TorchModel

FRAME_HW = (64, 128)
TRACKS = 8
BATCH = 3


def flat_variables(variables) -> dict:
    return {"/".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(variables)[0]}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def both():
    cfg = SptAudioGenConfig(encoders=("audio", "video"), separation="unet_mask",
                            sep_num_tracks=TRACKS)
    g = cfg.geometry
    rng = np.random.RandomState(0)
    audio = (rng.randn(BATCH, g.snd_size, 1) * 0.1).astype(np.float32)
    video = (rng.rand(BATCH, g.vid_dur, *FRAME_HW, 3) - 0.5).astype(np.float32)
    model = SptAudioGen(cfg)
    variables = model.init(jax.random.PRNGKey(0), audio[:1], video[:1], train=False)
    out, state = model.apply(variables, audio, video, train=False,
                             mutable=["intermediates"])
    inter = state["intermediates"]
    ref = {"out": np.asarray(out),
           "stft_mag": np.asarray(inter["stft_mag"][0]),
           "mask": np.asarray(inter["separation"]["mask"][0])}

    tmodel = TorchModel(TorchConfig(sep_num_tracks=TRACKS), frame_hw=FRAME_HW)
    tmodel.load_state_dict(from_flax(flat_variables(variables)), strict=True)
    taps = {}
    with torch.no_grad():
        got = tmodel(torch.from_numpy(audio), torch.from_numpy(video), taps=taps)
    got = {"out": got.numpy(), "stft_mag": taps["stft_mag"].numpy(),
           "mask": taps["mask"].numpy()}
    return ref, got


@pytest.mark.parametrize("name", ["out", "stft_mag", "mask"])
def test_forward_matches_jax(both, name):
    """Relative L2 error <= 1e-4 (float32 reduction-order noise through ~20
    layers and two 1024-point DFTs)."""
    ref, got = both
    assert got[name].shape == ref[name].shape
    assert np.isfinite(got[name]).all()
    assert rel_l2(got[name], ref[name]) <= 1e-4, rel_l2(got[name], ref[name])
