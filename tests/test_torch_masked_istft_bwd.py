"""K2, the fused backward of the masked comb-ISTFT: the port's plain version
against the JAX package's XLA oracle (_bwd_xla) and its Pallas backward
(interpret mode), and the port's autograd through masked_istft against
jax.grad of masked_istft_reference. The CUDA kernel itself is tested in
test_torch_cuda.py and chip_smoke.py.

Tolerances are those of tests/test_pallas.py: atol 5e-4 / rtol 1e-4
between the backward implementations (:142-159), 5e-3 / 1e-3 for gradients
through the forward (:32-45, :120-135), 5e-2 for bfloat16 masks
(:93-117).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.ops.dft import stft_real as jax_stft_real
from spatialaudiogen_tpu.ops.pallas_kernels import (
    _backward_pallas,
    _bwd_xla,
    masked_istft_reference,
)
from spatialaudiogen_tpu_torch.ops import masked_istft as k


def _inputs(b=2, n_in=1, tracks=3, wind=256, seed=0):
    """Spectra of a random signal and a sigmoid mask, as numpy float32
    (tests/test_pallas.py's _inputs)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n_in, 9 * wind).astype(np.float32)
    re, im = (np.asarray(a) for a in jax_stft_real(x, wind, 4))
    t = re.shape[2]
    mask = 1 / (1 + np.exp(-rng.randn(b, n_in, tracks, t, wind).astype(np.float32)))
    return re, im, mask.astype(np.float32)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def bwd_case():
    """tests/test_pallas.py:142-159: 12 tracks (more than one 8-track tile)."""
    re, im, mask = _inputs(b=2, tracks=12, wind=256, seed=3)
    rng = np.random.RandomState(4)
    t = re.shape[2]
    out_len = (t // 4) * 256 - 3 * 64
    g = rng.randn(2, 1, 12, out_len).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (re, im, mask))
    fused = _backward_pallas(*jargs, jnp.asarray(g), 4, True, "highest")
    oracle = _bwd_xla(4, jargs, jnp.asarray(g))
    got = k.masked_istft_bwd_plain(*_torch(re, im, mask, g), 4)
    return got, fused, oracle


@pytest.mark.parametrize("ref", ["bwd_xla", "backward_pallas"])
@pytest.mark.parametrize("which", [0, 1, 2], ids=["d_re", "d_im", "d_mask"])
def test_plain_matches_jax_backward(bwd_case, ref, which):
    got, fused, oracle = bwd_case
    want = np.asarray((oracle if ref == "bwd_xla" else fused)[which])
    assert got[which].shape == want.shape
    np.testing.assert_allclose(got[which].numpy(), want, atol=5e-4, rtol=1e-4)


def _jax_grads(re, im, mask, seed):
    """jax.grad of sum(w * masked_istft_reference) w.r.t. (re, im, mask),
    with w a fixed random cotangent, and that cotangent."""
    out = masked_istft_reference(re, im, mask, 4)
    w = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)

    def loss(r, i, m):
        return jnp.sum(masked_istft_reference(r, i, m.astype(jnp.float32), 4) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(re), jnp.asarray(im),
                                              jnp.asarray(mask))
    return [np.asarray(x, np.float32) for x in grads], w


@pytest.mark.parametrize("b, tracks, wind, drop", [
    (1, 2, 128, 0),        # tests/test_pallas.py:32-45
    (2, 2, 128, 2),        # T % 4 == 2: trailing frames get zero gradient (:120-135)
])
def test_autograd_matches_jax_grad(b, tracks, wind, drop):
    re, im, mask = _inputs(b=b, tracks=tracks, wind=wind, seed=1)
    if drop:
        re, im, mask = re[:, :, :-drop], im[:, :, :-drop], mask[:, :, :, :-drop]
    want, w = _jax_grads(re, im, mask, seed=5)
    tre, tim, tmask = (x.requires_grad_() for x in _torch(re, im, mask))
    out = k.masked_istft(tre, tim, tmask)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tre.grad, tim.grad, tmask.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-3, rtol=1e-3)
    if drop:
        assert float(tmask.grad[..., -drop:, :].abs().max()) == 0.0
        assert float(tre.grad[..., -drop:, :].abs().max()) == 0.0


def test_autograd_bf16_mask_matches_jax_grad():
    """A bfloat16 mask: its gradient comes back bfloat16 (tests/test_pallas.py
    :93-117), within 5e-2 of the float32 gradient."""
    re, im, mask = _inputs(b=1, tracks=2, wind=128, seed=2)
    mask16 = jnp.asarray(mask).astype(jnp.bfloat16)
    want, w = _jax_grads(re, im, mask16, seed=6)
    tmask = torch.from_numpy(np.array(mask16.astype(jnp.float32))).to(torch.bfloat16)
    tre, tim = (x.requires_grad_() for x in _torch(re, im))
    tmask.requires_grad_()
    out = k.masked_istft(tre, tim, tmask)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(w)).sum().backward()
    assert tmask.grad.dtype == torch.bfloat16
    for got, ref in zip((tre.grad, tim.grad, tmask.grad), want):
        np.testing.assert_allclose(got.float().numpy(), ref, atol=5e-2, rtol=5e-2)


def test_bwd_plain_bf16_mask_matches_bwd_xla():
    re, im, mask = _inputs(b=1, tracks=3, wind=128, seed=7)
    mask16 = jnp.asarray(mask).astype(jnp.bfloat16)
    t = re.shape[2]
    g = np.random.RandomState(8).randn(1, 1, 3, (t // 4) * 128 - 96).astype(np.float32)
    want = _bwd_xla(4, (jnp.asarray(re), jnp.asarray(im), mask16), jnp.asarray(g))
    tmask = torch.from_numpy(np.array(mask16.astype(jnp.float32))).to(torch.bfloat16)
    got = k.masked_istft_bwd_plain(*_torch(re, im), tmask, torch.from_numpy(g))
    assert got[2].dtype == torch.bfloat16
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b_, np.float32),
                                   atol=5e-2, rtol=5e-2)


def test_wrapper_runs_the_plain_backward_on_cpu_tensors():
    re, im, mask = _torch(*_inputs(tracks=4, wind=128, seed=3))
    g = torch.randn(k.masked_istft_plain(re, im, mask).shape)
    count = k.bwd_launch_count
    got = k.masked_istft_bwd(re, im, mask, g)
    for a, b_ in zip(got, k.masked_istft_bwd_plain(re, im, mask, g)):
        assert torch.equal(a, b_)
    assert k.bwd_launch_count == count, "the CPU route must not count as a kernel launch"
    with pytest.raises(ValueError, match="different devices"):
        k.masked_istft_bwd(re, im, mask, g.to("meta"))


def test_library_hash_covers_every_source(tmp_path, monkeypatch):
    """Every .cu file and the header they include feed the library's
    name: editing any one rebuilds."""
    assert [s.name for s in k.SOURCES] == ["masked_istft.cu", "masked_istft_bwd.cu",
                                           "masked_istft_nhwc.cu"]
    assert [s.name for s in k.HEADERS] == ["istft_mma.cuh"]
    before = k.library_path()
    for attr in ("SOURCES", "HEADERS"):
        for i, src in enumerate(getattr(k, attr)):
            copy = tmp_path / src.name
            copy.write_bytes(src.read_bytes() + b"\n// edited\n")
            files = list(getattr(k, attr))
            files[i] = copy
            monkeypatch.setattr(k, attr, tuple(files))
            assert k.library_path() != before
            monkeypatch.undo()
    assert k.library_path() == before


# ---------------------------------------------------------------------------
# precision="default": the plain version of K2's bf16 route


def _bwd_case(seed, tracks=3, wind=256):
    re, im, mask = _inputs(b=1, tracks=tracks, wind=wind, seed=seed)
    t = re.shape[2]
    g = np.random.RandomState(seed + 1).randn(1, 1, tracks, (t // 4) * wind - 3 * wind // 4)
    return re, im, mask, g.astype(np.float32)


def _jax_bf16_bwd(re, im, mask, g):
    """_bwd_xla with its GEMM operands (the scaled scattered cotangent and
    the bases) rounded to bf16: exact bf16 products summed in float32."""
    from spatialaudiogen_tpu.ops.dft import _basis as jax_basis

    f = re.shape[-1]
    hop, t = f // 4, re.shape[2]
    gp = jnp.pad(jnp.asarray(g) / 4.0, ((0, 0), (0, 0), (0, 0), (3 * hop, t * hop - g.shape[-1])))
    gx = jnp.stack([gp[..., i * hop: i * hop + f] for i in range(t)], -2) / float(f)
    gx = gx.astype(jnp.bfloat16)
    c, s = (jnp.asarray(x).astype(jnp.bfloat16) for x in jax_basis(f))
    g_rm = jnp.matmul(gx, c, preferred_element_type=jnp.float32)
    g_im = jnp.matmul(gx, s, preferred_element_type=jnp.float32)
    d_mask = g_rm * re[:, :, None] + g_im * im[:, :, None]
    return [np.asarray(x) for x in (jnp.sum(g_rm * mask, 2), jnp.sum(g_im * mask, 2), d_mask)]


def test_bwd_plain_default_matches_jax_on_bf16_operands():
    """Both round the same scaled cotangent and bases to bf16 and sum exact
    products in float32: only the summation order differs."""
    re, im, mask, g = _bwd_case(16)
    want = _jax_bf16_bwd(re, im, mask, g)
    got = k.masked_istft_bwd_plain(*_torch(re, im, mask, g), 4, "default")
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w, atol=1e-6, rtol=1e-5)


def test_bwd_plain_default_is_bf16_away_from_f32():
    """Each gradient lies 1e-4 to 1e-2 (relative L2) from the float32 one."""
    args = _torch(*_bwd_case(17))
    f32 = k.masked_istft_bwd_plain(*args, 4, "highest")
    bf16 = k.masked_istft_bwd_plain(*args, 4, "default")
    for a, w in zip(bf16, f32):
        err = float((a - w).norm() / w.norm())
        assert 1e-4 <= err <= 1e-2, err


def test_bwd_cpu_route_ignores_precision():
    """On the CPU the backward runs float32 for both values of precision:
    K2's wrapper and autograd through masked_istft give the float32
    plain gradients bit for bit."""
    re, im, mask, g = _torch(*_bwd_case(18))
    want = k.masked_istft_bwd_plain(re, im, mask, g, 4, "highest")
    for a, w in zip(k.masked_istft_bwd(re, im, mask, g, 4, "default"), want):
        assert torch.equal(a, w)
    grads = {}
    for precision in ("default", "highest"):
        args = [x.clone().requires_grad_() for x in (re, im, mask)]
        (k.masked_istft(*args, 4, precision) * g).sum().backward()
        grads[precision] = [x.grad for x in args]
    for a, b_ in zip(*grads.values()):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("f, t", [(64, 58), (128, 58), (1024, 140), (2048, 19)])
def test_plain_matches_pallas_vjp_at_the_new_shapes(f, t):
    """The plain K2 against the VJP of masked_istft_pallas in interpret
    mode (whose backward is the Pallas _bwd_kernel) at small F, long tracks
    and F = 2048; the backward implementations' tolerance, 5e-4 / 1e-4.
    Frames past the last multiple of 4 get zero gradient in both."""
    from spatialaudiogen_tpu.ops.pallas_kernels import masked_istft_pallas

    rng = np.random.RandomState(f + t)
    re, im = (rng.randn(1, 1, t, f).astype(np.float32) for _ in range(2))
    mask = (1 / (1 + np.exp(-rng.randn(1, 1, 2, t, f)))).astype(np.float32)
    out, vjp = jax.vjp(lambda r, i, m: masked_istft_pallas(r, i, m, 4, True),
                       *(jnp.asarray(a) for a in (re, im, mask)))
    g = rng.randn(*out.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))
    got = k.masked_istft_bwd_plain(*_torch(re, im, mask, g), 4)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-4, rtol=1e-4)
