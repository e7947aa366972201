"""The port on a CUDA card: K1 against its plain version, and the reduced
flagship forward on the card against the same model on the CPU.

Every test here carries the `cuda` marker and skips without a card. The
file imports no JAX, so it runs on a card host that has none:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(`--noconftest`: tests/conftest.py sets up JAX's CPU mesh.)
"""

import pytest
import torch

from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.ops import masked_istft as k1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest tests/test_torch_cuda.py "
                    "--noconftest -m cuda)")
    # full float32 products on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("b, tracks, t, wind, mask_dtype, tol", [
    (2, 32, 28, 1024, torch.float32, (2e-4, 1e-4)),     # flagship track count and T
    (3, 5, 30, 1024, torch.float32, (2e-4, 1e-4)),      # ragged: TR 5, T % 4 == 2
    (2, 32, 28, 1024, torch.bfloat16, (2e-2, 2e-2)),
])
def test_kernel_matches_plain(b, tracks, t, wind, mask_dtype, tol):
    """Tolerances of tests/test_pallas.py: float32 reduction order for f32
    masks, 2e-2 for bf16 masks."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    re = torch.randn((b, 1, t, wind), generator=gen, device="cuda")
    im = torch.randn((b, 1, t, wind), generator=gen, device="cuda")
    mask = torch.rand((b, 1, tracks, t, wind), generator=gen, device="cuda").to(mask_dtype)
    count = k1.launch_count
    got = k1.masked_istft(re, im, mask)
    torch.cuda.synchronize()
    assert k1.launch_count == count + 1
    want = k1.masked_istft_plain(re, im, mask)
    torch.testing.assert_close(got, want, atol=tol[0], rtol=tol[1])


@pytest.mark.cuda
def test_kernel_refuses_inputs_that_need_gradients():
    """No backward kernel yet: a CUDA call that would need one raises."""
    _need_card()
    re = torch.zeros((1, 1, 8, 128), device="cuda", requires_grad=True)
    mask = torch.zeros((1, 1, 2, 8, 128), device="cuda")
    with pytest.raises(ValueError, match="no backward"):
        k1.masked_istft(re, re.detach(), mask)


@pytest.mark.cuda
def test_reduced_flagship_forward_card_matches_cpu():
    """Audio + video, unet_mask with 8 tracks, 64x128 frames, batch 3: the
    card (through K1) against the CPU (through the plain version), relative
    L2 <= 1e-4 (float32 reduction order in cuDNN, cuBLAS and K1)."""
    _need_card()
    cfg = SptAudioGenConfig(sep_num_tracks=8)
    g = cfg.geometry
    model = SptAudioGen(cfg, frame_hw=(64, 128)).init_weights(
        torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    audio = 0.1 * torch.randn((3, g.snd_size, 1), generator=gen)
    video = torch.rand((3, g.vid_dur, 64, 128, 3), generator=gen) - 0.5
    with torch.no_grad():
        want = model(audio, video)
        model.to("cuda")
        count = k1.launch_count
        got = model(audio.cuda(), video.cuda()).cpu()
    assert k1.launch_count == count + 1
    assert got.shape == want.shape == (3, g.snd_dur, 3)
    err = float((got - want).norm() / want.norm())
    assert err <= 1e-4, err
