"""The weight bridge (spatialaudiogen_tpu_torch.models.convert) over the
full flagship variable tree: audio + video encoders, unet_mask with 32
tracks, 224x448 frames. Shapes come from jax.eval_shape (nothing is
computed); values are numpy noise from a seed."""

import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.models import SptAudioGen, SptAudioGenConfig
from spatialaudiogen_tpu_torch.config import SptAudioGenConfig as TorchConfig
from spatialaudiogen_tpu_torch.models import convert
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen as TorchModel

FRAME_HW = (224, 448)


@pytest.fixture(scope="module")
def flagship_tree() -> dict:
    cfg = SptAudioGenConfig(encoders=("audio", "video"), separation="unet_mask",
                            sep_num_tracks=32)
    g = cfg.geometry
    audio = jax.ShapeDtypeStruct((1, g.snd_size, 1), np.float32)
    video = jax.ShapeDtypeStruct((1, g.vid_dur) + FRAME_HW + (3,), np.float32)
    shapes = jax.eval_shape(lambda a, v: SptAudioGen(cfg).init(
        jax.random.PRNGKey(0), a, v, train=False), audio, video)
    rng = np.random.RandomState(0)
    return {"/".join(k.key for k in path): rng.randn(*s.shape).astype(np.float32)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def test_roundtrip_is_bitwise(flagship_tree):
    back = convert.to_flax(convert.from_flax(flagship_tree))
    assert back.keys() == flagship_tree.keys()
    for key, val in flagship_tree.items():
        assert back[key].dtype == val.dtype and back[key].shape == val.shape, key
        np.testing.assert_array_equal(back[key], val, err_msg=key)


def test_flagship_tree_loads_into_the_port_model(flagship_tree):
    """Every JAX variable has a port parameter or buffer of the bridged
    shape, and nothing is left over (strict load)."""
    model = TorchModel(TorchConfig(sep_num_tracks=32), frame_hw=FRAME_HW)
    state = convert.from_flax(flagship_tree)
    model.load_state_dict(state, strict=True)
    kernels = [k for k in flagship_tree if k.endswith("/kernel")]
    # audio convs, ResNet18 convs + 1x1 shortcuts, bottleneck FCs,
    # localization FCs, separation fc-feats + deconvs
    assert len(kernels) == 5 + 20 + 3 + 3 + 6, len(kernels)
    key = "params/separation/deconv1/deconv/kernel"
    jw = flagship_tree[key]                               # HWIO, unflipped
    tw = model.state_dict()["separation.deconv1.deconv.weight"]
    assert tuple(tw.shape) == (jw.shape[2], jw.shape[3], jw.shape[0], jw.shape[1])
    assert torch.equal(tw[:, :, 0, 0], torch.from_numpy(jw[-1, -1]))


def test_params_npz_roundtrip(tmp_path, flagship_tree):
    state = convert.from_flax(flagship_tree)
    fn = convert.save_params(str(tmp_path), state)
    assert fn.endswith(convert.PARAMS_FILE)
    back = convert.load_params(str(tmp_path))
    assert back.keys() == state.keys()
    for key in state:
        assert torch.equal(back[key], state[key]), key
