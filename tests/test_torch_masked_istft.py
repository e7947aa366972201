"""K1, the fused masked comb-ISTFT: the port's plain version against the
JAX package's Pallas kernel (interpret mode) and its XLA reference, and the
wrapper's routing. The CUDA kernel itself is tested in test_torch_cuda.py.

Tolerances are those of tests/test_pallas.py: atol 2e-4 / rtol 1e-4 for
float32 masks (float32 reduction order), 2e-2 for bfloat16 masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.ops.dft import stft_real as jax_stft_real
from spatialaudiogen_tpu.ops.pallas_kernels import masked_istft_pallas, masked_istft_reference
from spatialaudiogen_tpu_torch.ops import masked_istft as k1
from spatialaudiogen_tpu_torch.ops.dft import basis, mma_basis


def _inputs(b=2, n_in=1, tracks=3, wind=256, seed=0):
    """Spectra of a random signal and a sigmoid mask, as numpy float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n_in, 9 * wind).astype(np.float32)
    re, im = (np.asarray(a) for a in jax_stft_real(x, wind, 4))
    t = re.shape[2]
    mask = 1 / (1 + np.exp(-rng.randn(b, n_in, tracks, t, wind).astype(np.float32)))
    return re, im, mask.astype(np.float32)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("b, n_in, tracks, wind, drop", [
    (2, 1, 3, 256, 0),     # tracks not a multiple of 8
    (1, 2, 10, 128, 0),    # two input channels, one full 8-track tile + 2
    (2, 1, 5, 128, 2),     # T not a multiple of 4: trailing frames dropped
])
def test_plain_matches_pallas_and_reference(b, n_in, tracks, wind, drop):
    re, im, mask = _inputs(b, n_in, tracks, wind)
    if drop:
        re, im, mask = re[:, :, :-drop], im[:, :, :-drop], mask[:, :, :, :-drop]
    pallas = np.asarray(masked_istft_pallas(jnp.asarray(re), jnp.asarray(im),
                                            jnp.asarray(mask), 4, True))
    ref = np.asarray(masked_istft_reference(re, im, mask, 4))
    got = k1.masked_istft_plain(*_torch(re, im, mask), 4).numpy()
    assert got.shape == pallas.shape == ref.shape
    np.testing.assert_allclose(got, pallas, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_plain_bf16_mask_matches_pallas():
    re, im, mask = _inputs(b=1, tracks=2, wind=128, seed=2)
    mask16 = jnp.asarray(mask).astype(jnp.bfloat16)
    pallas = np.asarray(masked_istft_pallas(jnp.asarray(re), jnp.asarray(im), mask16, 4, True))
    tmask = torch.from_numpy(np.array(mask16.astype(jnp.float32))).to(torch.bfloat16)
    got = k1.masked_istft_plain(*_torch(re, im), tmask, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-2, rtol=2e-2)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    re, im, mask = _torch(*_inputs(tracks=4, wind=128, seed=3))
    count = k1.launch_count
    got = k1.masked_istft(re, im, mask, 4, "default")
    assert torch.equal(got, k1.masked_istft_plain(re, im, mask, 4))
    assert k1.launch_count == count, "the CPU route must not count as a kernel launch"


def test_wrapper_rejects_what_no_route_takes():
    re, im, mask = _torch(*_inputs(b=1, tracks=2, wind=128))
    with pytest.raises(ValueError, match="precision"):
        k1.masked_istft(re, im, mask, 4, "high")
    with pytest.raises(ValueError, match="different devices"):
        k1.masked_istft(re, im, mask.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k1.masked_istft(re.to("meta"), im.to("meta"), mask.to("meta"))


def test_library_path_follows_the_source():
    path = k1.library_path()
    assert path.parent == k1.BUILD_DIR and path.suffix == ".so"
    assert path == k1.library_path()


# ---------------------------------------------------------------------------
# precision="default": the plain version of K1's bf16 route


def _jax_bf16_istft(re, im, mask):
    """JAX's masked_istft_reference with its two GEMM operands (the masked
    spectra and the bases) rounded to bf16: exact bf16 products summed in
    float32, then the JAX package's comb overlap-add."""
    from spatialaudiogen_tpu.ops.dft import _basis as jax_basis, _overlap_add as jax_ola

    f = re.shape[-1]
    c, s = (jnp.asarray(x).astype(jnp.bfloat16) for x in jax_basis(f))
    rm = (jnp.asarray(re)[:, :, None] * jnp.asarray(mask)).astype(jnp.bfloat16)
    imm = (jnp.asarray(im)[:, :, None] * jnp.asarray(mask)).astype(jnp.bfloat16)
    x = (jnp.matmul(rm, c, preferred_element_type=jnp.float32)
         + jnp.matmul(imm, s, preferred_element_type=jnp.float32)) / float(f)
    return np.asarray(jax_ola(x, 4))


def test_plain_default_matches_jax_on_bf16_operands():
    """Both round the same float32 products and bases to bf16 and sum exact
    products in float32: only the summation order differs."""
    re, im, mask = _inputs(b=2, tracks=3, wind=256, seed=11)
    want = _jax_bf16_istft(re, im, mask)
    got = k1.masked_istft_plain(*_torch(re, im, mask), 4, "default").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


def test_plain_default_is_bf16_away_from_f32():
    """bf16 operands put the output about 2e-3 (relative L2) from the
    float32 function, the TPU's DEFAULT (53 dB); below 1e-4 nothing was
    rounded, above 1e-2 something else went wrong."""
    args = _torch(*_inputs(b=2, tracks=3, wind=256, seed=12))
    f32 = k1.masked_istft_plain(*args, 4, "highest")
    bf16 = k1.masked_istft_plain(*args, 4, "default")
    err = float((bf16 - f32).norm() / f32.norm())
    assert 1e-4 <= err <= 1e-2, err


def test_cpu_route_ignores_pallas_precision():
    """On the CPU, masked_istft and the model run float32 whatever
    pallas_precision says, as the JAX model's non-Pallas branch does: a
    reduced model's forward is the same bit for bit under both values."""
    from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

    args = _torch(*_inputs(tracks=2, wind=256, seed=13))
    assert torch.equal(k1.masked_istft(*args, 4, "default"),
                       k1.masked_istft_plain(*args, 4, "highest"))
    gen = torch.Generator().manual_seed(1)
    out = {}
    for precision in ("default", "highest"):
        cfg = SptAudioGenConfig(sep_num_tracks=2, pallas_precision=precision)
        g = cfg.geometry
        if not out:
            audio = 0.1 * torch.randn((1, g.snd_size, 1), generator=gen)
            video = torch.rand((1, g.vid_dur, 32, 64, 3), generator=gen) - 0.5
        model = SptAudioGen(cfg, frame_hw=(32, 64)).init_weights(
            torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            out[precision] = model(audio, video)
    assert torch.equal(out["default"], out["highest"])


# ---------------------------------------------------------------------------
# The laid-out bases (ops/dft.py:mma_basis) read the way K1's wgmma reads
# them (ops/csrc/istft_mma.cuh)


def _wgmma_b(image: torch.Tensor, n_wgmmas: int) -> np.ndarray:
    """One step's B tiles, (wgmma, k, column), from its shared-memory image
    read through the kernels' descriptor: K-major, no swizzle, core matrix
    (columns 8 nb.., k chunk kc) at kc * 4096 + nb * 128 bytes, column i of
    the core at i * 16, value e at e * element size."""
    raw = image.contiguous().view(torch.uint8).numpy()
    esize = image.element_size()
    n_e = 16 // esize
    out = np.empty((n_wgmmas, 2 * n_e, 256), np.float32)
    vals = image.float().numpy().reshape(-1)
    for h in range(n_wgmmas):
        for kk in range(2 * n_e):
            kc, e = divmod(kk, n_e)
            n = np.arange(256)
            byte = h * 8192 + kc * 4096 + (n // 8) * 128 + (n % 8) * 16 + e * esize
            out[h, kk] = vals[byte // esize]
    assert raw.size == n_wgmmas * 8192
    return out


def _wgmma_a(values: np.ndarray, n_wgmmas: int) -> np.ndarray:
    """The logical A of each wgmma of a step, (rows, wgmma, k), from the
    values a thread stages, (rows, tig, slot 0..7), packed as the kernels'
    Step<P>::run packs its registers into the wgmma A fragment (bf16 k16:
    k 2 tig + (0, 1) from slots 2h + (0, 1), k 2 tig + 8 + (0, 1) from
    slots 4 + 2h + (0, 1); tf32 k8: k tig from slot h, k tig + 4 from slot
    4 + h)."""
    rows = values.shape[0]
    n_k = 16 if n_wgmmas == 2 else 8
    out = np.empty((rows, n_wgmmas, n_k), values.dtype)
    for h in range(n_wgmmas):
        for kk in range(n_k):
            if n_k == 16:
                half, rest = divmod(kk, 8)
                tig, slot = rest // 2, 4 * half + 2 * h + rest % 2
            else:
                half, tig = divmod(kk, 4)
                slot = 4 * half + h
            out[:, h, kk] = values[:, tig, slot]
    return out


def _k1_layout_gemm(f, t, tile, precision):
    """K1's GEMM emulated step by step from the laid-out bases of residue
    tile `tile` and the A fragments (mask applied as staged), against
    (re*m) @ C + (im*m) @ S at the block's columns {q*hop + 64 tile + rr};
    columns whose residue is past hop must be zero."""
    hop = f // 4
    rng = np.random.RandomState(14)
    re, im, m = (rng.randn(t, f).astype(np.float32) for _ in range(3))
    n_w = 2 if precision == "default" else 4
    step_bytes = n_w * 8192
    hi_t, lo_t = (x.view(-1) for x in mma_basis(f, "cpu", "fwd", precision))
    per_tile = hi_t.numel() // -(-hop // 64)
    acc = np.zeros((t, 256), np.float64)
    for s in range(f // 16):
        freqs = 16 * s + 4 * np.arange(4)[:, None] + np.arange(4)[None]   # (tig, j)
        vals = np.concatenate([re[:, freqs] * m[:, freqs], im[:, freqs] * m[:, freqs]], -1)
        a = _wgmma_a(vals.astype(np.float64), n_w)
        n_el = step_bytes // hi_t.element_size()
        sl = slice(tile * per_tile + s * n_el, tile * per_tile + (s + 1) * n_el)
        b = _wgmma_b(hi_t[sl], n_w)
        if precision == "highest":
            b = b + _wgmma_b(lo_t[sl], n_w)
        acc += np.einsum("rhk,hkn->rn", a, b)
    c, s_ = basis(f, "cpu")
    res = 64 * tile + np.arange(256) % 64
    live = res < hop
    cols = ((np.arange(256) // 64) * hop + res)[live]
    want = (re * m) @ c.numpy()[:, cols] + (im * m) @ s_.numpy()[:, cols]
    tol = 2e-2 if precision == "default" else 1e-5
    np.testing.assert_allclose(acc[:, live], want, atol=tol * np.abs(want).max(), rtol=0)
    assert not acc[:, ~live].any()


def _k2_layout_gemm(f, rows, tile, precision):
    """K2's GEMM emulated the same way: A the scattered cotangent (slot
    (half, tig, j) is sample 32 s + 16 half + 4 tig + j of the frame), B
    the laid-out [C | S] tile of the block's 128 output frequencies
    (columns past F zero)."""
    gx = np.random.RandomState(15).randn(rows, f).astype(np.float32)
    n_w = 2 if precision == "default" else 4
    hi_t, lo_t = (x.view(-1) for x in mma_basis(f, "cpu", "bwd", precision))
    per_tile = hi_t.numel() // -(-f // 128)
    n_el = n_w * 8192 // hi_t.element_size()
    acc = np.zeros((rows, 256), np.float64)
    for s in range(f // 32):
        n = 32 * s + 4 * np.arange(4)[:, None] + np.arange(4)[None]        # (tig, j)
        vals = np.concatenate([gx[:, n], gx[:, n + 16]], -1).astype(np.float64)
        sl = slice(tile * per_tile + s * n_el, tile * per_tile + (s + 1) * n_el)
        b = _wgmma_b(hi_t[sl], n_w)
        if precision == "highest":
            b = b + _wgmma_b(lo_t[sl], n_w)
        acc += np.einsum("rhk,hkn->rn", _wgmma_a(vals, n_w), b)
    c, s_ = basis(f, "cpu")
    freq = 128 * tile + np.arange(128)
    live = np.concatenate([freq < f, freq < f])
    cols = freq[freq < f]
    want = np.concatenate([gx @ c.numpy()[:, cols], gx @ s_.numpy()[:, cols]], -1)
    tol = 2e-2 if precision == "default" else 1e-5
    np.testing.assert_allclose(acc[:, live], want, atol=tol * np.abs(want).max(), rtol=0)
    assert not acc[:, ~live].any()


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_k1_basis_layout_gives_the_gemm(precision):
    """The block's 256 columns {q*hop + 64 tile + rr} at F = 512, tile 1."""
    _k1_layout_gemm(512, 8, 1, precision)


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_k2_basis_layout_gives_the_gemm(precision):
    """The [C | S] tile of the block's 128 output frequencies at F = 512,
    tile 2."""
    _k2_layout_gemm(512, 6, 2, precision)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("f, tile", [
    (64, 0),     # hop 16 < 64: 16 live residues, K2's tile half full
    (128, 0),    # hop 32; K2 one full tile
    (160, 0),    # not a power of two: hop 40; K2's second tile 32 wide
    (160, 1),
    (2048, 7),   # the last of 8 residue tiles, 16 frequency tiles
])
def test_basis_layout_small_and_partial_tiles(f, tile, precision):
    """Small F and partial tiles: the live columns give the GEMM, the
    columns past the bases' edge are zero (K1's residues >= hop, K2's
    frequencies >= F)."""
    if tile < -(-(f // 4) // 64):
        _k1_layout_gemm(f, 6, tile, precision)
    _k2_layout_gemm(f, 6, min(tile, -(-f // 128) - 1), precision)


def test_mma_basis_refuses_f_off_the_step():
    with pytest.raises(ValueError, match="multiple of 32"):
        mma_basis(48, "cpu", "fwd", "default")


# ---------------------------------------------------------------------------
# Shapes beyond the flagship: every (F, mask frames) the CLIs' flags reach

# (F, mask frames) of a few CLI flag sets that PRs 1-5's kernels refused
# (F below 256, more than 128 used frames) or never ran (F = 2048)
NEW_SHAPES = [(64, 58), (128, 58), (1024, 140), (2048, 19)]


def _random_spectra(tracks, t, f, seed):
    """Random (1, 1, T, F) spectra and a sigmoid (1, 1, TR, T, F) mask."""
    rng = np.random.RandomState(seed)
    re, im = (rng.randn(1, 1, t, f).astype(np.float32) for _ in range(2))
    mask = 1 / (1 + np.exp(-rng.randn(1, 1, tracks, t, f)))
    return re, im, mask.astype(np.float32)


@pytest.mark.parametrize("f, t", NEW_SHAPES)
def test_plain_matches_pallas_at_the_new_shapes(f, t):
    """The plain version against masked_istft_pallas in interpret mode at
    small F, long tracks and F = 2048 (2e-4 / 1e-4, as above)."""
    re, im, mask = _random_spectra(2, t, f, seed=f + t)
    want = np.asarray(masked_istft_pallas(jnp.asarray(re), jnp.asarray(im),
                                          jnp.asarray(mask), 4, True))
    got = k1.masked_istft_plain(*_torch(re, im, mask), 4).numpy()
    assert got.shape == want.shape == (1, 1, 2, (t // 4) * f - 3 * f // 4)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


CLI_SHAPES = [  # cli.train flags (deploy fixes sample_dur 0.1), F, mask frames
    ({}, 1024, 28),                                          # the flagship
    ({"audio_rate": 16000, "fft_window": 0.01}, 128, 58),
    ({"audio_rate": 8000, "fft_window": 0.01}, 64, 58),
    ({"audio_rate": 16000, "fft_window": 0.005}, 64, 108),
    ({"sample_duration": 0.7}, 1024, 140),                   # audio-only
    ({"fft_window": 0.05}, 2048, 19),
]


@pytest.mark.parametrize("flags, f, t", CLI_SHAPES)
def test_kernels_take_every_cli_shape(flags, f, t):
    """The wrappers' checks (K1 and K2's _check_inputs, K3's
    _check_nhwc_inputs) take each (F, mask frames) the CLIs reach, called
    on meta tensors, so nothing launches. (The JAX model itself builds
    only for F >= 1024: below that its audio encoder's frequency axis
    shrinks to nothing; its masked-ISTFT kernel takes any F.)"""
    from spatialaudiogen_tpu_torch.dsp.geometry import ModelGeometry

    g = ModelGeometry(**flags)
    assert (g.wind_size, g.n_mask_frames) == (f, t)
    t_use = (t // 4) * 4
    for dtype in (torch.float32, torch.bfloat16):
        re = torch.empty((2, 1, t, f), device="meta")
        mask = torch.empty((2, 1, 32, t, f), dtype=dtype, device="meta")
        assert k1._check_inputs(re, re, mask, 4) == (2, 1, 32, t, t_use, f)
        nhwc = torch.empty((2, 32, t, f), dtype=dtype, device="meta").permute(0, 2, 3, 1)
        assert k1._check_nhwc_inputs(re[:, 0], re[:, 0], nhwc, 4) == (2, 32, t_use, f)


def test_kernels_refuse_what_they_cannot_take():
    """What no route takes still raises: n_overlap other than 4, F off the
    32-step, fewer than 4 frames."""
    re = torch.empty((1, 1, 28, 1024), device="meta")
    mask = torch.empty((1, 1, 2, 28, 1024), device="meta")
    with pytest.raises(ValueError, match="n_overlap"):
        k1._check_inputs(re, re, mask, 2)
    re48, mask48 = torch.empty((1, 1, 28, 48), device="meta"), torch.empty(
        (1, 1, 2, 28, 48), device="meta")
    with pytest.raises(ValueError, match="multiple of 32"):
        k1._check_inputs(re48, re48, mask48, 4)
    with pytest.raises(ValueError, match="at least 4 frames"):
        k1._check_inputs(re[:, :, :3], re[:, :, :3], mask[..., :3, :], 4)
