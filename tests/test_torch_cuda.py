"""The port on a CUDA card: K1, K2 and K3 against their plain versions, and
the reduced flagship forward and train step (NCHW and NHWC mask) on the
card against the same model on the CPU.

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


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("b, tracks, t, wind, mask_dtype, tol", [
    (2, 32, 28, 1024, torch.float32, (2e-4, 1e-4)),     # flagship track count and T
    (3, 5, 30, 1024, torch.float32, (2e-4, 1e-4)),      # ragged: TR 5, T % 4 == 2
    (2, 32, 28, 1024, torch.bfloat16, (2e-4, 1e-4)),
    # the shapes the CLIs' flags reach (F, mask frames), and partial tiles
    (2, 8, 58, 128, torch.float32, (2e-4, 1e-4)),      # one track per 64-row tile
    (2, 8, 58, 64, torch.float32, (2e-4, 1e-4)),       # F = 64: 16 residues a block
    (2, 4, 108, 64, torch.bfloat16, (2e-4, 1e-4)),     # one track spans both tiles
    (1, 3, 140, 1024, torch.float32, (2e-4, 1e-4)),    # T > 128: overlapping chunks
    (1, 2, 390, 1024, torch.float32, (2e-4, 1e-4)),    # four chunks
    (2, 4, 19, 2048, torch.float32, (2e-4, 1e-4)),     # F = 2048, 16 of 19 frames used
    (2, 3, 30, 160, torch.float32, (2e-4, 1e-4)),      # F = 160: partial residue tile
])
def test_kernel_matches_plain(b, tracks, t, wind, mask_dtype, tol, precision):
    """Each route against the plain version at its precision: "highest"
    (3xTF32) against the float32 function, "default" (bf16 operands)
    against the plain version that rounds the same operands; both differ
    only in float32 summation order (tests/test_pallas.py's f32
    tolerance), for both mask dtypes, since both routes read the same bf16
    mask values. "default" also lies 1e-4 to 1e-2 (relative L2) from the
    float32 function: bf16 ran."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    re = torch.randn((b, 1, t, wind), generator=gen, device="cuda")
    im = torch.randn((b, 1, t, wind), generator=gen, device="cuda")
    mask = torch.rand((b, 1, tracks, t, wind), generator=gen, device="cuda").to(mask_dtype)
    count = k1.launch_count
    got = k1.masked_istft(re, im, mask, 4, precision)
    torch.cuda.synchronize()
    assert k1.launch_count == count + 1
    want = k1.masked_istft_plain(re, im, mask, 4, precision)
    torch.testing.assert_close(got, want, atol=tol[0], rtol=tol[1])
    if precision == "default":
        err = _rel_l2(got, k1.masked_istft_plain(re, im, mask, 4, "highest"))
        assert 1e-4 <= err <= 1e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("b, tracks, t, wind, mask_dtype, tol", [
    (2, 32, 28, 1024, torch.float32, (5e-4, 1e-4)),     # flagship track count and T
    (3, 5, 30, 1024, torch.float32, (5e-4, 1e-4)),      # ragged: TR 5, T % 4 == 2
    (1, 3, 160, 256, torch.float32, (5e-4, 1e-4)),      # T > 128: frames chunked per track
    (2, 32, 28, 1024, torch.bfloat16, (1e-3, 1e-2)),   # d_mask rounded to bf16 by both
    (2, 8, 58, 128, torch.float32, (5e-4, 1e-4)),      # F = 128: one frequency tile
    (2, 8, 58, 64, torch.float32, (5e-4, 1e-4)),       # F = 64: half a tile
    (2, 4, 108, 64, torch.bfloat16, (1e-3, 1e-2)),
    (1, 3, 140, 1024, torch.float32, (5e-4, 1e-4)),
    (2, 4, 19, 2048, torch.float32, (5e-4, 1e-4)),
    (2, 3, 30, 160, torch.float32, (5e-4, 1e-4)),      # F = 160: a partial last tile
])
def test_bwd_kernel_matches_plain(b, tracks, t, wind, mask_dtype, tol, precision):
    """K2 against masked_istft_bwd_plain at the same precision; tolerances
    of tests/test_pallas.py:142-159 (f32) for both routes (summation order
    only). A bf16 d_mask may round to the neighbouring bf16 value (at most
    2^-7 relative): rtol 1e-2. "default" also lies 1e-4 to 1e-2 (relative
    L2) from the float32 gradients."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    re = torch.randn((b, 1, t, wind), generator=gen, device="cuda")
    im = torch.randn((b, 1, t, wind), generator=gen, device="cuda")
    mask = torch.rand((b, 1, tracks, t, wind), generator=gen, device="cuda").to(mask_dtype)
    out_len = (t // 4) * wind - 3 * wind // 4
    g = torch.randn((b, 1, tracks, out_len), generator=gen, device="cuda")
    count = k1.bwd_launch_count
    got = k1.masked_istft_bwd(re, im, mask, g, 4, precision)
    torch.cuda.synchronize()
    assert k1.bwd_launch_count == count + 1
    want = k1.masked_istft_bwd_plain(re, im, mask, g, 4, precision)
    assert got[2].dtype == mask_dtype
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), atol=tol[0], rtol=tol[1])
    if t % 4:
        assert float(got[2][..., (t // 4) * 4:, :].abs().max()) == 0.0
    if precision == "default":
        for a, w in zip(got, k1.masked_istft_bwd_plain(re, im, mask, g, 4, "highest")):
            err = _rel_l2(a, w)
            assert 1e-4 <= err <= 1e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_autograd_goes_through_both_kernels(precision):
    """masked_istft on CUDA tensors that need gradients: K1 forward, K2
    backward, the gradients of the plain version's autograd at the same
    precision. With "default" the gradient is the bf16 plain one and lies
    1e-4 to 1e-2 from the float32 one: the precision reached K2."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    re = torch.randn((2, 1, 28, 1024), generator=gen, device="cuda")
    im = torch.randn((2, 1, 28, 1024), generator=gen, device="cuda")
    mask = torch.rand((2, 1, 4, 28, 1024), generator=gen, device="cuda", requires_grad=True)
    counts = k1.launch_count, k1.bwd_launch_count
    out = k1.masked_istft(re, im, mask, 4, precision)
    w = torch.randn(out.shape, generator=gen, device="cuda")
    (out * w).sum().backward()
    assert (k1.launch_count, k1.bwd_launch_count) == (counts[0] + 1, counts[1] + 1)
    want = k1.masked_istft_bwd_plain(re, im, mask.detach(), w, 4, precision)[2]
    torch.testing.assert_close(mask.grad, want, atol=5e-4, rtol=1e-4)
    if precision == "default":
        f32 = k1.masked_istft_bwd_plain(re, im, mask.detach(), w, 4, "highest")[2]
        assert 1e-4 <= _rel_l2(mask.grad, f32) <= 1e-2


def _nhwc_mask(gen, b, tracks, t, wind, dtype):
    """The model's mask layout: a frame crop of a channels_last
    (B, TR, T + 6, F) tensor, viewed (B, T, F, TR)."""
    full = torch.rand((b, tracks, t + 6, wind), generator=gen, device="cuda")
    full = full.to(dtype).contiguous(memory_format=torch.channels_last)
    return full[:, :, 2:2 + t].permute(0, 2, 3, 1)


NHWC_CASES = [  # b, tracks, t, wind, mask dtype, K3's vector route
    (2, 32, 28, 1024, torch.float32, True),      # flagship: 4-track vector loads
    (3, 5, 30, 1024, torch.float32, False),      # ragged: TR 5 (scalar loads), T % 4
    (2, 32, 28, 1024, torch.bfloat16, True),     # bf16 4-track vector loads
    (3, 5, 30, 1024, torch.bfloat16, False),     # bf16 scalar loads
    (2, 32, 28, 64, torch.float32, True),        # F = 64: 4 steps of staging
    (2, 8, 58, 128, torch.float32, False),       # one track per 64-row tile
    (2, 4, 108, 64, torch.bfloat16, False),      # one track spans both tiles
    (1, 4, 140, 1024, torch.float32, False),     # T > 128: overlapping chunks
    (2, 8, 19, 2048, torch.bfloat16, True),      # F = 2048, 16 of 19 frames used
]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("b, tracks, t, wind, mask_dtype, vector", NHWC_CASES)
def test_nhwc_kernel_matches_plain(b, tracks, t, wind, mask_dtype, vector, precision):
    """K3 against masked_istft_nhwc_plain at the same precision on a
    strided NHWC view, read in place, on both of its routes (vector and
    scalar mask loads): "highest" (3xTF32) against the float32 function,
    "default" (bf16 operands) against the plain version that rounds the same
    operands; both differ only in float32 summation order
    (tests/test_pallas.py's f32 forward tolerance, 2e-4 / 1e-4), for both
    mask dtypes, since both read the same bf16 mask values. "default" also
    lies 1e-4 to 1e-2 (relative L2) from the float32 function: bf16 ran."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    re = torch.randn((b, t, wind), generator=gen, device="cuda")
    im = torch.randn((b, t, wind), generator=gen, device="cuda")
    mask = _nhwc_mask(gen, b, tracks, t, wind, mask_dtype)
    assert k1.nhwc_vector_route(mask, (t // 4) * 4) is vector
    count = k1.nhwc_launch_count
    got = k1.masked_istft_nhwc(re, im, mask, 4, precision)
    torch.cuda.synchronize()
    assert k1.nhwc_launch_count == count + 1
    want = k1.masked_istft_nhwc_plain(re, im, mask, 4, precision)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)
    if precision == "default":
        err = _rel_l2(got, k1.masked_istft_nhwc_plain(re, im, mask, 4, "highest"))
        assert 1e-4 <= err <= 1e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("b, tracks, t, wind, mask_dtype, vector", NHWC_CASES)
def test_nhwc_kernel_matches_k1(b, tracks, t, wind, mask_dtype, vector, precision):
    """K3 on the NHWC view against K1 on the same mask made track-major and
    contiguous, at the same precision: K3 keeps K1's rows, k order, bases
    and epilogue, so only the mask's path differs; max abs <= 1e-6."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    re = torch.randn((b, t, wind), generator=gen, device="cuda")
    im = torch.randn((b, t, wind), generator=gen, device="cuda")
    mask = _nhwc_mask(gen, b, tracks, t, wind, mask_dtype)
    got = k1.masked_istft_nhwc(re, im, mask, 4, precision)
    want = k1.masked_istft(re[:, None], im[:, None],
                           mask.permute(0, 3, 1, 2)[:, None].contiguous(), 4, precision)[:, 0]
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_nhwc_autograd_goes_through_k3_and_k2(precision):
    """masked_istft_nhwc on CUDA tensors that need gradients: K3 forward and
    K2 backward on the mask made track-major, both at `precision`; the
    forward against the plain version at that precision (2e-4 / 1e-4), the
    gradients in all three inputs against the plain ones at that precision
    (K2's tolerance, 5e-4 / 1e-4); with "default" the output and the
    gradients lie 1e-4 to 1e-2 from the float32 ones."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    re = torch.randn((2, 30, 1024), generator=gen, device="cuda", requires_grad=True)
    im = torch.randn((2, 30, 1024), generator=gen, device="cuda", requires_grad=True)
    mask = _nhwc_mask(gen, 2, 8, 30, 1024, torch.float32).requires_grad_()
    counts = k1.nhwc_launch_count, k1.bwd_launch_count
    out = k1.masked_istft_nhwc(re, im, mask, 4, precision)
    w = torch.randn(out.shape, generator=gen, device="cuda")
    (out * w).sum().backward()
    assert (k1.nhwc_launch_count, k1.bwd_launch_count) == (counts[0] + 1, counts[1] + 1)
    assert mask.grad.shape == mask.shape
    assert float(mask.grad[:, 28:].abs().max()) == 0.0
    refs = [x.detach() for x in (re, im)] + [mask.detach().permute(0, 3, 1, 2)[:, None]]
    for prec in {precision, "highest"}:
        fwd = k1.masked_istft_nhwc_plain(refs[0], refs[1], mask.detach(), 4, prec)
        want = k1.masked_istft_bwd_plain(refs[0][:, None], refs[1][:, None], refs[2],
                                         w[:, None], 4, prec)
        want = (want[0][:, 0], want[1][:, 0], want[2][:, 0].permute(0, 2, 3, 1))
        if prec == precision:
            torch.testing.assert_close(out.detach(), fwd, atol=2e-4, rtol=1e-4)
        else:
            assert 1e-4 <= _rel_l2(out.detach(), fwd) <= 1e-2
        for x, ref in zip((re, im, mask), want):
            if prec == precision:
                torch.testing.assert_close(x.grad, ref, atol=5e-4, rtol=1e-4)
            else:
                assert 1e-4 <= _rel_l2(x.grad, ref) <= 1e-2


@pytest.mark.cuda
def test_reduced_nhwc_forward_card_matches_cpu():
    """pallas_nhwc=True, reduced flagship (8 tracks, 64x128 frames, batch
    3): the card (K3, channels_last U-Net) against the CPU (K3's plain
    version), relative L2 <= 1e-4; K1 is not launched."""
    _need_card()
    cfg = SptAudioGenConfig(sep_num_tracks=8, pallas_nhwc=True, pallas_precision="highest")
    g = cfg.geometry
    model = SptAudioGen(cfg, frame_hw=(64, 128)).init_weights(
        torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    audio = 0.1 * torch.randn((3, g.snd_size, 1), generator=gen)
    video = torch.rand((3, g.vid_dur, 64, 128, 3), generator=gen) - 0.5
    with torch.no_grad():
        want = model(audio, video)
        model.to("cuda")
        counts = k1.launch_count, k1.nhwc_launch_count
        got = model(audio.cuda(), video.cuda()).cpu()
    assert (k1.launch_count, k1.nhwc_launch_count) == (counts[0], counts[1] + 1)
    err = float((got - want).norm() / want.norm())
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_reduced_flagship_forward_card_matches_cpu():
    """Audio + video, unet_mask with 8 tracks, 64x128 frames, batch 3: the
    card (through K1's 3xTF32 route, pallas_precision="highest") against
    the CPU (through the plain version), relative L2 <= 1e-4 (float32
    reduction order in cuDNN, cuBLAS and K1)."""
    _need_card()
    cfg = SptAudioGenConfig(sep_num_tracks=8, pallas_precision="highest")
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


@pytest.mark.cuda
def test_reduced_flagship_train_step_card_matches_cpu():
    """One train step of the reduced flagship (8 tracks, 64x128 frames,
    batch 3) on the card (K1 and K2, pallas_precision="highest": 3xTF32)
    and on the CPU from the same weights: loss and flattened gradient at
    relative 1e-4."""
    _need_card()
    from spatialaudiogen_tpu_torch.train.lr import make_optimizer
    from spatialaudiogen_tpu_torch.train.state import TrainState
    from spatialaudiogen_tpu_torch.train.steps import train_step

    cfg = SptAudioGenConfig(sep_num_tracks=8, pallas_precision="highest")
    g = cfg.geometry
    gen = torch.Generator().manual_seed(3)
    batch = {"ambix": 0.1 * torch.randn((3, g.snd_size, 4), generator=gen),
             "audio_mask": torch.ones((3, 4)),
             "video": torch.randint(0, 256, (3, 1, 64, 128, 3), generator=gen,
                                    dtype=torch.uint8)}
    results = {}
    for dev in ("cpu", "cuda"):
        model = SptAudioGen(cfg, frame_hw=(64, 128)).init_weights(
            torch.Generator().manual_seed(0)).to(dev)
        state = TrainState(model, make_optimizer(model.parameters()))
        counts = k1.launch_count, k1.bwd_launch_count
        metrics = train_step(state, {k: v.to(dev) for k, v in batch.items()}, 1e-4)
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()])
        results[dev] = float(metrics["total_loss"]), grads
        if dev == "cuda":
            assert k1.launch_count == counts[0] + 1 and k1.bwd_launch_count == counts[1] + 1
    (loss_c, g_c), (loss_g, g_g) = results["cpu"], results["cuda"]
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    assert float((g_g - g_c).norm() / g_c.norm()) <= 1e-4


def _order2_model_inputs():
    """The reduced order-2 model (ambi_order=2: n_in = 4; 8 tracks, 64x128
    frames) on the card, and the spectra and mask its forward hands
    masked_istft at batch 3, in the layout it hands them (the mask a
    frame-cropped view)."""
    import spatialaudiogen_tpu_torch.models.sptaudiogen as sptaudiogen

    cfg = SptAudioGenConfig(ambi_order=2, sep_num_tracks=8, pallas_precision="highest")
    g = cfg.geometry
    model = SptAudioGen(cfg, frame_hw=(64, 128)).init_weights(
        torch.Generator().manual_seed(0)).eval().to("cuda")
    gen = torch.Generator().manual_seed(2)
    audio = 0.1 * torch.randn((3, g.snd_size, 4), generator=gen).cuda()
    video = (torch.rand((3, g.vid_dur, 64, 128, 3), generator=gen) - 0.5).cuda()
    seen = []
    original = sptaudiogen.masked_istft
    sptaudiogen.masked_istft = lambda re, im, mask, *a: seen.append((re, im, mask)) or \
        original(re, im, mask, *a)
    try:
        with torch.no_grad():
            model(audio, video)
    finally:
        sptaudiogen.masked_istft = original
    return seen[0]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_kernels_at_n_in_4_on_the_order2_model_layout(precision):
    """K1 and K2 on the spectra and (cropped, strided) mask the order-2
    model makes, n_in = 4, against their plain versions at the same
    precision, with the tolerances of test_kernel_matches_plain and
    test_bwd_kernel_matches_plain (float32 summation order only)."""
    _need_card()
    re, im, mask = _order2_model_inputs()
    assert re.shape[1] == mask.shape[1] == 4 and not mask.is_contiguous()
    count = k1.launch_count, k1.bwd_launch_count
    got = k1.masked_istft(re, im, mask, 4, precision)
    g = torch.randn(got.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda")
    got_bwd = k1.masked_istft_bwd(re, im, mask, g, 4, precision)
    torch.cuda.synchronize()
    assert (k1.launch_count, k1.bwd_launch_count) == (count[0] + 1, count[1] + 1)
    torch.testing.assert_close(got, k1.masked_istft_plain(re, im, mask, 4, precision),
                               atol=2e-4, rtol=1e-4)
    for a, w in zip(got_bwd, k1.masked_istft_bwd_plain(re, im, mask, g, 4, precision)):
        torch.testing.assert_close(a, w, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
def test_order2_train_step_card_matches_cpu():
    """One train step of the reduced order-2 model (9-channel batch, n_in =
    4 into K1 and K2, pallas_precision="highest") on the card and on the
    CPU from the same weights: loss and flattened gradient at relative
    1e-4, as test_reduced_flagship_train_step_card_matches_cpu holds order 1."""
    _need_card()
    from spatialaudiogen_tpu_torch.train.lr import make_optimizer
    from spatialaudiogen_tpu_torch.train.state import TrainState
    from spatialaudiogen_tpu_torch.train.steps import train_step

    cfg = SptAudioGenConfig(ambi_order=2, sep_num_tracks=8, pallas_precision="highest")
    g = cfg.geometry
    gen = torch.Generator().manual_seed(3)
    batch = {"ambix": 0.1 * torch.randn((3, g.snd_size, 9), generator=gen),
             "audio_mask": torch.ones((3, 9)),
             "video": torch.randint(0, 256, (3, 1, 64, 128, 3), generator=gen,
                                    dtype=torch.uint8)}
    batch["audio_mask"][1, 4:] = 0.0     # a first-order clip among second-order ones
    results = {}
    for dev in ("cpu", "cuda"):
        model = SptAudioGen(cfg, frame_hw=(64, 128)).init_weights(
            torch.Generator().manual_seed(0)).to(dev)
        state = TrainState(model, make_optimizer(model.parameters()))
        counts = k1.launch_count, k1.bwd_launch_count
        metrics = train_step(state, {k: v.to(dev) for k, v in batch.items()}, 1e-4)
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()])
        results[dev] = float(metrics["total_loss"]), grads
        if dev == "cuda":
            assert k1.launch_count == counts[0] + 1 and k1.bwd_launch_count == counts[1] + 1
    (loss_c, g_c), (loss_g, g_g) = results["cpu"], results["cuda"]
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    assert float((g_g - g_c).norm() / g_c.norm()) <= 1e-4


def _packed_clip(folder, seconds=2, hw=(64, 128), seed=0):
    """A packed clip (data/packed.py layout) with flow, written with numpy
    only (the card host has no Pillow): PCM16 FOA, u8 frames, flow bytes
    and limits, and the audio power index."""
    import json

    import numpy as np

    rng = np.random.RandomState(seed)
    n, rate, frames = seconds * 48000, 48000, seconds * 10
    t = np.arange(n) / rate
    w = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)
    az = np.linspace(-np.pi, np.pi, n)
    foa = np.stack([w, w * np.sin(az), 0.2 * w, w * np.cos(az)], 1)
    pack = folder / "packed"
    pack.mkdir(parents=True)
    np.save(pack / "ambix.npy", np.round(foa * 26000).astype(np.int16))
    np.save(pack / "video.npy", rng.randint(0, 256, (frames,) + hw + (3,)).astype(np.uint8))
    np.save(pack / "flow.npy", rng.randint(0, 256, (frames,) + hw + (3,)).astype(np.uint8))
    lims = np.stack([np.zeros(frames), rng.uniform(1, 3, frames)], 1).astype(np.float32)
    np.save(pack / "flow_lims.npy", lims)
    (pack / "meta.json").write_text(json.dumps({
        "version": 1, "rate": rate, "num_channels": 4, "num_files": seconds,
        "audio_dtype": "int16", "video_frames": frames, "frame_shape": list(hw) + [3],
        "flow_frames": frames, "flow_shape": list(hw) + [3]}))
    (folder / "audio_pow.lst").write_text(
        "".join(f"{i / 10 + 0.5} 0.3\n" for i in range((seconds - 1) * 10)))


@pytest.mark.cuda
def test_default_model_deploy_card_matches_cpu(tmp_path):
    """The default model (audio, flow and video encoders; 8 tracks, 64x128
    frames) deployed by MonoToAmbix's per-window host path at batch 3 over
    5 windows (the last batch padded): the card (K1 at
    pallas_precision="highest") against the CPU, relative L2 <= 1e-4, the
    W passthrough equal, K1 launched once per batch."""
    _need_card()
    import numpy as np

    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.models.convert import save_params

    cfg = TrainConfig(model_dir=str(tmp_path / "model"), encoders=("audio", "flow", "video"),
                      num_sep_tracks=8, frame_hw=(64, 128), pallas_precision="highest")
    cfg.save()
    model = SptAudioGen(cfg.model_config(), frame_hw=(64, 128)).init_weights(
        torch.Generator().manual_seed(0))
    save_params(cfg.model_dir, model.state_dict())
    _packed_clip(tmp_path / "clip")
    out = {}
    for dev in ("cpu", "cuda"):
        count = k1.launch_count
        out[dev] = MonoToAmbix(cfg.model_dir, batch_size=3, device=dev).deploy(
            str(tmp_path / "clip"), 0.5, 0.5)
    assert k1.launch_count == count + 2
    assert out["cuda"].shape == out["cpu"].shape == (24000, 4)
    np.testing.assert_array_equal(out["cuda"][:, 0], out["cpu"][:, 0])
    err = float(np.linalg.norm(out["cuda"][:, 1:] - out["cpu"][:, 1:])
                / np.linalg.norm(out["cpu"][:, 1:]))
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_eval_metrics_on_the_card_run_full_float32_after_a_tf32_forward():
    """A dft_precision="default" model's forward on the card (TF32 allowed
    inside it), then the device mel-LSD and envelope with the process's
    matmul TF32 switch left on: both within 1e-5 of the same functions in
    float64 on the CPU (a TF32 product would put them about 1e-3 off), and
    the switches as found afterwards."""
    _need_card()
    from spatialaudiogen_tpu_torch.ops.eval_metrics import envelope_dist_fn, mel_lsd_batch_fn

    cfg = SptAudioGenConfig(sep_num_tracks=8, dft_precision="default")
    g = cfg.geometry
    model = SptAudioGen(cfg, frame_hw=(64, 128)).init_weights(
        torch.Generator().manual_seed(0)).to("cuda")
    gen = torch.Generator().manual_seed(2)
    audio = 0.1 * torch.randn((3, g.snd_size, 1), generator=gen)
    video = torch.rand((3, g.vid_dur, 64, 128, 3), generator=gen) - 0.5
    pred = 0.1 * torch.randn((4, 4800, 3), generator=gen)
    gt = pred + 0.05 * torch.randn((4, 4800, 3), generator=gen)
    fns = (mel_lsd_batch_fn(48000), envelope_dist_fn(4800))
    try:
        with torch.no_grad():
            model(audio.cuda(), video.cuda())
        assert not torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        for fn in fns:
            got = fn(pred.cuda(), gt.cuda()).cpu().double()
            want = fn(pred.double(), gt.double())
            assert torch.backends.cuda.matmul.allow_tf32
            assert float((got - want).abs().max()) <= 1e-5, (got - want).abs().max()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _serving_setup(tmp_path, encoders=("audio", "video"), precision="default"):
    """A reduced model dir (8 tracks, 64x128 frames, random weights), a
    packed 2 s clip, and its mono (int16/32768) and 10 fps frames."""
    import numpy as np

    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.models.convert import save_params

    cfg = TrainConfig(model_dir=str(tmp_path / "model"), encoders=encoders,
                      num_sep_tracks=8, frame_hw=(64, 128), pallas_precision=precision)
    cfg.save()
    model = SptAudioGen(cfg.model_config(), frame_hw=(64, 128)).init_weights(
        torch.Generator().manual_seed(0))
    save_params(cfg.model_dir, model.state_dict())
    _packed_clip(tmp_path / "clip")
    mono = np.load(tmp_path / "clip" / "packed" / "ambix.npy")[:, 0] / np.float32(32768)
    frames = np.load(tmp_path / "clip" / "packed" / "video.npy")
    return cfg.model_dir, str(tmp_path / "clip"), mono.astype(np.float32), frames


def _serve(stream, mono, frames):
    import numpy as np

    chunks = []
    for i in range(0, len(mono), 4800):
        chunks += stream.push(mono[i: i + 4800], frames[i // 4800])
    return np.concatenate(chunks + stream.flush(), 0)


@pytest.mark.cuda
def test_stream_is_batch1_deploy_on_the_card(tmp_path):
    """On the card, the stream (0.1 s pushes, one frame each, then flush)
    is bit for bit MonoToAmbix(batch_size=1, yuv_frames=False).deploy()
    over the windows the clip holds (deploy stops where the 2 s clip ends
    the context; flush pads it), and launches K1 once per window."""
    _need_card()
    import numpy as np

    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.deploy.stream import StreamingMonoToAmbix

    model_dir, clip, mono, frames = _serving_setup(tmp_path)
    ref = MonoToAmbix(model_dir, batch_size=1, yuv_frames=False).deploy(clip, 0.5, 1.5)
    count = k1.launch_count
    got = _serve(StreamingMonoToAmbix(model_dir), mono, frames)
    assert k1.launch_count - count == 15
    assert got.shape == (72000, 4) and ref.shape == (48000, 4)
    np.testing.assert_array_equal(got[: len(ref)], ref)


@pytest.mark.cuda
def test_stream_card_matches_cpu(tmp_path):
    """The stream on the card (K1 at pallas_precision="highest") against
    the CPU, float32 fetch: relative L2 <= 1e-4, the W passthrough equal."""
    _need_card()
    import numpy as np

    from spatialaudiogen_tpu_torch.deploy.stream import StreamingMonoToAmbix

    model_dir, _, mono, frames = _serving_setup(tmp_path, precision="highest")
    out = {dev: _serve(StreamingMonoToAmbix(model_dir, f16_fetch=False, device=dev), mono,
                       frames) for dev in ("cpu", "cuda")}
    np.testing.assert_array_equal(out["cuda"][:, 0], out["cpu"][:, 0])
    err = float(np.linalg.norm(out["cuda"][:, 1:] - out["cpu"][:, 1:])
                / np.linalg.norm(out["cpu"][:, 1:]))
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_stream_batcher_card_matches_cpu(tmp_path):
    """Four sessions (staggered signals, one frame a block) through a
    capacity-4 batcher on the card (pallas_precision="highest") and on the
    CPU, float32 fetch: relative L2 <= 1e-4 per session; each tick that
    runs a forward launches K1 once."""
    _need_card()
    import numpy as np

    from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher

    model_dir, _, mono, frames = _serving_setup(tmp_path, precision="highest")
    signals = [np.roll(mono, -off) for off in (0, 4800, 20000, 7)]
    out = {}
    for dev in ("cpu", "cuda"):
        b = StreamBatcher(model_dir, capacity=4, f16_fetch=False, device=dev)
        sids = [b.add_session() for _ in signals]
        got = {sid: [] for sid in sids}
        for i in range(0, len(mono), 4800):
            for sid, sig in zip(sids, signals):
                b.push(sid, sig[i: i + 4800], frames[i // 4800])
            count = k1.launch_count
            res = b.tick()
            if dev == "cuda":
                assert k1.launch_count - count == (1 if res else 0)
            for sid, chunks in res.items():
                got[sid] += chunks
        out[dev] = [np.concatenate(got[sid], 0) for sid in sids]
    for cpu, card in zip(out["cpu"], out["cuda"]):
        assert card.shape == cpu.shape == (48000, 4)
        np.testing.assert_array_equal(card[:, 0], cpu[:, 0])
        err = float(np.linalg.norm(card[:, 1:] - cpu[:, 1:]) / np.linalg.norm(cpu[:, 1:]))
        assert err <= 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("fb_occlusion", [False, True], ids=["fb-off", "fb-on"])
def test_flow_pairs_card_matches_cpu(fb_occlusion):
    """ops/flow.py's Horn-Schunck on the card against the same solve on the
    CPU at 48x96 (2 warps, 16 Jacobi steps): within 1e-4 px max abs, as
    the CPU tests hold the port to JAX (the float32 solve there is about
    1e-5 px from float64)."""
    import numpy as np

    from spatialaudiogen_tpu_torch.ops.flow import flow_pairs

    _need_card()
    gen = torch.Generator().manual_seed(0)
    base = torch.nn.functional.avg_pool2d(torch.rand((3, 1, 56, 104), generator=gen), 9, 1)[:, 0]
    i1, i2 = base, torch.roll(base, (1, 2), dims=(1, 2))
    out = {dev: flow_pairs(i1.to(dev), i2.to(dev), n_warps=2, n_iters=16,
                           fb_occlusion=fb_occlusion).cpu().numpy() for dev in ("cpu", "cuda")}
    assert out["cuda"].shape == (3, 48, 96, 2) and np.isfinite(out["cuda"]).all()
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-4
    assert abs(float(np.median(out["cuda"][:, 12:-12, 12:-12, 0])) - 2.0) < 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("cell, bidirectional", [("rnn", False), ("lstm", False),
                                                 ("gru", False), ("gru", True)])
def test_recurrent_card_matches_cpu(cell, bidirectional):
    """models.recurrent on the card (cuDNN's RNN kernels, TF32 off) against
    the same layer on the CPU, (4, 20, 32) -> 32 units: within 1e-5."""
    from spatialaudiogen_tpu_torch.models.recurrent import BidirectionalRecurrent, Recurrent

    _need_card()
    torch.manual_seed(0)
    layer = BidirectionalRecurrent(32, 32, cell) if bidirectional else Recurrent(32, 32, cell)
    x = torch.randn((4, 20, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = layer(x)
        got = layer.to("cuda")(x.to("cuda")).cpu()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_sh_matrix_polar_torch_on_the_card():
    """sh_matrix_polar_torch at order 3 over 10^4 directions on the card:
    float64 within 1e-10 of numpy's scipy path, float32 within 1e-5."""
    import numpy as np

    from spatialaudiogen_tpu_torch.ambisonics.sh import sh_matrix_polar, sh_matrix_polar_torch

    _need_card()
    rng = np.random.RandomState(0)
    phi = rng.uniform(-np.pi, np.pi, 10_000)
    nu = rng.uniform(-np.pi / 2, np.pi / 2, 10_000)
    want = sh_matrix_polar(phi, nu, 3)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        got = sh_matrix_polar_torch(torch.tensor(phi, dtype=dtype, device="cuda"),
                                    torch.tensor(nu, dtype=dtype, device="cuda"), 3)
        assert got.device.type == "cuda"
        assert np.abs(got.cpu().double().numpy() - want).max() <= tol


@pytest.mark.cuda
def test_device_trace_on_the_card(tmp_path):
    """device_trace(device="cuda") writes one trace file holding the card's
    kernels (events of category "kernel")."""
    import json

    from spatialaudiogen_tpu_torch.utils.profiling import device_trace

    _need_card()
    a = torch.randn((256, 256), device="cuda")
    with device_trace(str(tmp_path), device="cuda"):
        torch.mm(a, a)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
def test_device_trace_of_a_deploy_carries_the_tracer_ranges(tmp_path):
    """device_trace over a short deploy on the card: the trace file holds
    the deploy engine's `sag.deploy.*` ranges beside the card's kernels, no
    kernel or copy on the device is named `sag.*`, and the spans it hands
    over name the same call."""
    import json

    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.utils.profiling import TRACER, device_trace

    _need_card()
    model_dir, clip, _, _ = _serving_setup(tmp_path)
    engine = MonoToAmbix(model_dir, batch_size=4)
    engine.deploy(clip, 0.5, 0.5)
    with device_trace(str(tmp_path / "trace"), device="cuda") as held:
        engine.deploy(clip, 0.5, 0.5)
    trace = held.trace
    assert not TRACER.on
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    host = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"sag.deploy.call", "sag.deploy.upload", "sag.deploy.forward",
            "sag.deploy.drain"} <= host
    device = [e["name"] for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                            "gpu_memset")]
    assert device and not [n for n in device if n.startswith("sag.")]
    assert {s.id for s in trace.of("deploy.call")} == {2}
    assert len(trace.of("deploy.forward")) == 2 and trace.counters["deploy.windows"] == 5


@pytest.mark.cuda
def test_device_prefetch_on_the_card_records_the_pin_and_the_copy():
    """On the card each array of a batch is pinned (`train.pin`) and copied
    (`train.h2d`) under the caller's span, and `train.h2d_bytes` is the sum
    of the arrays' bytes."""
    import numpy as np

    from spatialaudiogen_tpu_torch.data.pipeline import device_prefetch
    from spatialaudiogen_tpu_torch.utils.profiling import TRACER, span

    _need_card()
    rng = np.random.default_rng(0)
    batches = [{"ambix": rng.standard_normal((4, 64, 4)).astype(np.float32),
                "video": rng.integers(0, 256, (4, 1, 8, 8, 3), dtype=np.uint8)}
               for _ in range(2)]
    TRACER.start()
    stream = device_prefetch(iter(batches), "cuda")
    with span("train.batch", 0):
        dev, _ = next(stream)
    rest = next(stream)[0]
    torch.cuda.synchronize()
    trace = TRACER.stop()
    for got, want in ((dev, batches[0]), (rest, batches[1])):
        assert all(got[k].is_cuda and np.array_equal(got[k].cpu().numpy(), want[k])
                   for k in want)
    pins, copies = trace.of("train.pin"), trace.of("train.h2d")
    assert len(pins) == len(copies) == 4
    assert {trace.spans[s.parent].name for s in pins + copies} == {"train.batch"}
    assert trace.counters["train.h2d_bytes"] == sum(b[k].nbytes for b in batches for k in b)


@pytest.mark.cuda
def test_hermitian_forward_on_the_card():
    """The reduced flagship with hermitian_dft on, on the card: no K1 launch
    (the configuration's half-spectrum synthesis), within 1e-4 relative L2
    of the same forward on the CPU."""
    _need_card()
    cfg = SptAudioGenConfig(sep_num_tracks=8, hermitian_dft=True)
    model = SptAudioGen(cfg, frame_hw=(64, 128)).init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    audio = 0.1 * torch.randn((2, cfg.geometry.snd_size, 1), generator=gen)
    video = torch.rand((2, 1, 64, 128, 3), generator=gen) - 0.5
    with torch.no_grad():
        want = model(audio, video)
        count = k1.launch_count
        got = model.to("cuda")(audio.to("cuda"), video.to("cuda")).cpu()
    assert k1.launch_count == count
    assert _rel_l2(got, want) <= 1e-4
