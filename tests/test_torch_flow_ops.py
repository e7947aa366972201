"""The port's Horn-Schunck flow (spatialaudiogen_tpu_torch.ops.flow) against
the JAX package's (spatialaudiogen_tpu.ops.flow) on the CPU.

The same numpy-seeded inputs go through both. Tolerances:
  * each helper within 1e-6 abs (the stencils, the median and the warp do
    JAX's arithmetic in JAX's order; _upsample_flow's half-pixel
    coordinates round differently at sizes that are not exact doublings);
    _affine_init within 1e-5 (two sums over every pixel, in another order);
  * flow_pairs within 1e-4 px max abs, with fb_occlusion off and on (at
    48x96 the two float32 runs part by about 1e-5 px; both are about as
    far from a float64 run of the port);
  * the port meets the EPE and photometric bounds that
    tests/test_flow_quality.py holds JAX to, on that file's fixture.
The solves run at 48x96 / 64x128 with a reduced budget (2 warps, 16 Jacobi
steps) and batches of at most 4; torch runs on one thread.
"""

import os

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax.numpy as jnp
from spatialaudiogen_tpu.ops import flow as jflow
from spatialaudiogen_tpu_torch.ops import flow as tflow

SMALL = dict(n_warps=2, n_iters=16)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def textures(b, h, w, seed, sigma=2.0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return np.stack([gaussian_filter(rng.rand(h, w), sigma) for _ in range(b)]).astype(np.float32)


def smooth_flow(b, h, w, seed, amp=3.0) -> np.ndarray:
    """A smooth (B, H, W) displacement field of about `amp` px."""
    return (amp * (textures(b, h, w, seed, sigma=6.0) - 0.5) * 8).astype(np.float32)


def shifted_pair(b=3, h=48, w=96, seed=0):
    """(i1, i2): textures and their zoom + pan, as (B, H, W) float32."""
    from scipy.ndimage import map_coordinates

    i1 = textures(b, h, w, seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    i2 = np.stack([map_coordinates(im, [(ys - h / 2) * 1.02 + h / 2 - 0.8,
                                        (xs - w / 2) * 1.02 + w / 2 + 1.5 + k],
                                   order=3, mode="nearest") for k, im in enumerate(i1)])
    return i1, i2.astype(np.float32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("hw", [(48, 96), (45, 90)])
def test_stencils_match_jax(hw):
    """_sep_conv, _downsample, _conv3x3 and _gradients: edge-padded shifted
    sums (F.pad "replicate", no cuDNN), at an even and an odd size."""
    x, y = textures(3, *hw, seed=1), textures(3, *hw, seed=2)
    close(tflow._sep_conv(t(x), tflow._BINOMIAL5), jflow._sep_conv(jnp.asarray(x),
                                                                   jflow._BINOMIAL5), 1e-6)
    close(tflow._downsample(t(x)), jflow._downsample(jnp.asarray(x)), 1e-6)
    close(tflow._conv3x3(t(x), tflow._HS_AVG), jflow._conv3x3(jnp.asarray(x), jflow._HS_AVG),
          1e-6)
    for got, want in zip(tflow._gradients(t(x), t(y)),
                         jflow._gradients(jnp.asarray(x), jnp.asarray(y))):
        close(got, want, 1e-6)


def test_warp_matches_map_coordinates_out_of_frame():
    """_warp is JAX's map_coordinates(order=1, mode="nearest"): corner
    indices clamped, weights from the unclamped coordinate; flows that send
    samples up to 8 px outside every edge."""
    b, h, w = 3, 48, 96
    img = textures(b, h, w, seed=3)
    u = smooth_flow(b, h, w, seed=4, amp=2.0)
    v = smooth_flow(b, h, w, seed=5, amp=2.0)
    u[0, :, :6], v[0, :, :6] = -8.0, 0.0      # left edge
    u[0, :, -6:] = 8.0          # right edge
    v[1, :5] = -7.5             # top
    v[1, -5:] = 8.0             # bottom
    u[2] += 0.5                 # exact half-pixel weights
    got = tflow._warp(t(img), t(u), t(v))
    close(got, jflow._warp(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)), 1e-6)
    # a sample 8 px left of the frame is the edge pixel of its row
    np.testing.assert_array_equal(got[0, :, 0].numpy(), img[0, :, 0])


def test_median3_matches_jax():
    """torch.median over the nine views is jnp.median's: nine is odd."""
    x = textures(3, 48, 96, seed=6) * 10
    x[0, 10, 10] = 100.0                                  # an outlier the median drops
    got = tflow._median3(t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jflow._median3(jnp.asarray(x))))
    assert got[0, 10, 10] < 20
    stacked = tflow._median3(t(np.stack([x, 2 * x])))     # the solver's (2, B, H, W)
    np.testing.assert_array_equal(stacked[1].numpy(), tflow._median3(t(2 * x)).numpy())


@pytest.mark.parametrize("fine", [(48, 96), (64, 128), (45, 90)])
def test_upsample_flow_matches_jax_resize(fine):
    """_upsample_flow against jax.image.resize("bilinear") on a smooth flow,
    at exact doublings and at 45x90, whose coarse level (23x45) is not a
    half: half-pixel centres on both sides; at the edges JAX renormalises
    the kernel where torch clamps the coordinate."""
    coarse = ((fine[0] + 1) // 2, (fine[1] + 1) // 2)
    u = smooth_flow(2, *coarse, seed=7)
    v = smooth_flow(2, *coarse, seed=8)
    for got, want in zip(tflow._upsample_flow(t(u), t(v), fine),
                         jflow._upsample_flow(jnp.asarray(u), jnp.asarray(v), fine)):
        assert got.shape == (2,) + fine
        close(got, want, 1e-6)


def test_affine_init_matches_jax():
    """The batched 6x6 Gauss-Newton: within 1e-5 px of JAX (two sums over
    every pixel, in another order), and it recovers most of a zoom + pan."""
    i1, i2 = shifted_pair(seed=9)
    got = tflow._affine_init(t(i1), t(i2))
    want = jflow._affine_init(jnp.asarray(i1), jnp.asarray(i2))
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    assert abs(float(got[0][0].mean()) + 1.5) < 0.3
    flat = np.full((2, 24, 32), 0.5, np.float32)          # degenerate: zero gradients
    for g in tflow._affine_init(t(flat), t(flat)):
        assert torch.isfinite(g).all() and float(g.abs().max()) == 0.0


def test_occlusion_weight_matches_jax():
    b, h, w = 2, 48, 96
    u_f, v_f = smooth_flow(b, h, w, seed=10), smooth_flow(b, h, w, seed=11)
    u_b, v_b = -u_f * 0.9, -v_f
    u_b[0, 10:20, 10:30] += 6.0                            # inconsistent: occluded
    got = tflow._occlusion_weight(*map(t, (u_f, v_f, u_b, v_b)))
    want = jflow._occlusion_weight(*map(jnp.asarray, (u_f, v_f, u_b, v_b)))
    close(got, want, 1e-6)
    assert float(got.min()) < 0.5 and float(got.max()) == 1.0


@pytest.mark.parametrize("fb_occlusion", [False, True], ids=["fb-off", "fb-on"])
def test_flow_pairs_matches_jax(fb_occlusion):
    """The whole pyramid (affine init, warps, Jacobi, medians; and with
    fb_occlusion the 2B pass and the gated refine) within 1e-4 px of JAX;
    the port is as near a float64 run of itself as JAX is."""
    i1, i2 = shifted_pair(b=2, seed=12)
    got = tflow.flow_pairs(t(i1), t(i2), fb_occlusion=fb_occlusion, **SMALL).numpy()
    want = np.asarray(jflow.flow_pairs(jnp.asarray(i1), jnp.asarray(i2),
                                       fb_occlusion=fb_occlusion, **SMALL))
    f64 = tflow.flow_pairs(t(i1).double(), t(i2).double(), fb_occlusion=fb_occlusion,
                           **SMALL).numpy()
    assert got.shape == want.shape == (2, 48, 96, 2)
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(got - f64).max() <= 1e-4 and np.abs(want - f64).max() <= 1e-4
    assert abs(float(np.median(got[0, 12:-12, 12:-12, 0])) + 1.5) < 0.3


def test_horn_schunck_flow_batching_dtype_and_short_clips():
    """Pair batching is invisible (the zero-padded tail included), uint8 and
    float frames give one flow, the last frame repeats the one before, and
    fewer than two frames give zeros."""
    gray = textures(5, 48, 64, seed=13, sigma=1.5)
    frames = np.repeat(gray[..., None], 3, axis=-1)
    a = tflow.horn_schunck_flow(frames, pair_batch=2, device="cpu", **SMALL)
    b = tflow.horn_schunck_flow(frames, pair_batch=8, device="cpu", **SMALL)
    assert a.shape == (5, 48, 64, 2) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[-1], a[-2])
    np.testing.assert_allclose(
        a, np.asarray(jflow.horn_schunck_flow(frames, pair_batch=8, **SMALL)), rtol=0,
        atol=1e-4)

    u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tflow.horn_schunck_flow(u8, pair_batch=4, device="cpu",
                                                          **SMALL),
                                  tflow.horn_schunck_flow(u8.astype(np.float32), pair_batch=4,
                                                          device="cpu", **SMALL))
    for n in (0, 1):
        z = tflow.horn_schunck_flow(frames[:n], device="cpu")
        assert z.shape == (n, 48, 64, 2) and not z.any()


def test_epe_and_photometric_bounds_of_the_quality_fixture():
    """tests/test_flow_quality.py's zoom + pan fixture at the defaults: the
    port's EPE under 0.15 px, its photometric error under a tenth of no
    flow's and within 1.1x Farneback's, the bounds JAX is held to."""
    from test_flow_quality import _epe, _photometric, _rgb, _warp_pair

    from spatialaudiogen_tpu_torch.etl.flow import farneback_flow

    epes, photos, photo_fb, photo_zero = [], [], [], []
    for seed, (scale, tx, ty) in enumerate([(1.02, 1.5, -0.8), (0.985, -2.0, 1.2),
                                            (1.0, 2.5, 2.0)]):
        i0, i1, gt = _warp_pair(scale=scale, tx=tx, ty=ty, seed=seed)
        frames = np.stack([_rgb(i0), _rgb(i1)])
        hs = tflow.horn_schunck_flow(frames, device="cpu")[0]
        epes.append(_epe(hs, gt))
        photos.append(_photometric(i0, i1, hs))
        photo_fb.append(_photometric(i0, i1, farneback_flow(frames)[0]))
        photo_zero.append(_photometric(i0, i1, np.zeros_like(gt)))
    assert np.mean(epes) < 0.15, epes
    assert np.mean(photos) < 0.1 * np.mean(photo_zero)
    assert np.mean(photos) < 1.1 * np.mean(photo_fb)


def test_cli_flow_matches_jax(tmp_path, monkeypatch, capsys):
    """cli.flow --method tpu --device cpu over a jpg frames dir writes the
    flow_limits.npy JAX's cli.flow writes (within 1e-4), the port's
    FlowFrameReader reads its maps back, and a second run skips."""
    from PIL import Image

    from spatialaudiogen_tpu.cli.flow import main as jax_flow_main
    from spatialaudiogen_tpu.utils import jax_setup
    from spatialaudiogen_tpu_torch.cli.flow import main as flow_main
    from spatialaudiogen_tpu_torch.data.readers import FlowFrameReader

    monkeypatch.setattr(jax_setup, "enable_compile_cache", lambda *a, **k: None)
    gray = textures(4, 48, 64, seed=14, sigma=1.5)
    gray[1:] = np.roll(gray[:1], (1, 2), axis=(1, 2)) * 0.5 + gray[1:] * 0.5
    frames = (np.repeat(gray[..., None], 3, -1) / gray.max() * 255).astype(np.uint8)
    lims = {}
    for who, main in (("port", flow_main), ("jax", jax_flow_main)):
        root = tmp_path / who
        video = root / "vid" / "video"
        video.mkdir(parents=True)
        for i, frame in enumerate(frames):
            Image.fromarray(frame).save(video / f"{i:06d}.jpg")
        db = root / "db.lst"
        db.write_text("vid\nmissing\n")
        argv = [str(db), "--frames_dir", str(root), "--method", "tpu"]
        main(argv + (["--device", "cpu"] if who == "port" else []))
        assert "1 computed, 1 skipped" in capsys.readouterr().out
        lims[who] = np.load(root / "vid" / "flow" / "flow_limits.npy")
    assert lims["port"].shape == (4, 2)
    np.testing.assert_allclose(lims["port"], lims["jax"], rtol=0, atol=1e-4)

    flow_dir = str(tmp_path / "port" / "vid" / "flow")
    chunk = FlowFrameReader(flow_dir, os.path.join(flow_dir, "flow_limits.npy"),
                            rate=10).get_by_index(0, 2)
    assert chunk.shape == (2, 48, 64, 3) and np.isfinite(chunk).all()
    flow_main([str(tmp_path / "port" / "db.lst"), "--frames_dir", str(tmp_path / "port"),
               "--method", "tpu", "--device", "cpu"])
    assert "0 computed, 2 skipped" in capsys.readouterr().out
