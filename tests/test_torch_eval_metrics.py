"""The port's eval metrics against the JAX package's: the translated device
functions (ops/eval_metrics.py, ops/sinkhorn.py, ambisonics/maps.
spherical_power_maps) on the same seeded numpy inputs at stated
tolerances, the copied host modules (ambisonics/emd|maps|decoder,
eval/host_metrics, eval/parse_results) bit for bit, and the port's native
EMD route against the linprog fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.ambisonics import emd as jax_emd
from spatialaudiogen_tpu.ambisonics.maps import mesh_decoder as jax_mesh_decoder
from spatialaudiogen_tpu.ambisonics.maps import spherical_power_maps_jnp
from spatialaudiogen_tpu.eval import host_metrics as jax_host
from spatialaudiogen_tpu.eval import parse_results as jax_parse
from spatialaudiogen_tpu.ops import eval_metrics as jax_metrics
from spatialaudiogen_tpu.ops import sinkhorn as jax_sinkhorn
from spatialaudiogen_tpu_torch.ambisonics import emd
from spatialaudiogen_tpu_torch.ambisonics.maps import (
    mesh_decoder,
    spherical_mesh,
    spherical_power_maps,
)
from spatialaudiogen_tpu_torch.eval import host_metrics, parse_results
from spatialaudiogen_tpu_torch.ops import eval_metrics, sinkhorn

RATE = 48000


@pytest.fixture(scope="module", autouse=True)
def data():
    """Seeded inputs: spectral pairs (B, 4800, 3) with one identical pair,
    ambisonic pairs (B, 4800, 4) with an identical and a near-silent pair,
    histograms over the 30-degree eval mesh (half of them concentrated, the
    realistic power-map shape) and that mesh's ground distances. The module
    runs torch on one thread: Sinkhorn's hundreds of small ops, with every
    thread of every test worker spinning in OpenMP barriers, ran 0.3 s
    alone and 220 s with six workers on eight cores (one thread: 0.7 s
    either way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    pred = rng.randn(4, 4800, 3).astype(np.float32) * 0.1
    gt = pred + rng.randn(4, 4800, 3).astype(np.float32) * 0.05
    gt[1] = pred[1]
    a_pred = rng.randn(6, 4800, 4).astype(np.float32) * 0.1
    a_gt = a_pred + rng.randn(6, 4800, 4).astype(np.float32) * 0.05
    a_gt[3] = a_pred[3]
    a_pred[4] *= 1e-6
    a_gt[4] *= 1e-6
    phi, nu = spherical_mesh(30.0, inclusive_nu=True)
    mesh30 = emd.mesh_ground_distance(phi, nu).astype(np.float32)
    n = mesh30.shape[0]
    p = rng.rand(8, n).astype(np.float32) * 0.02
    q = rng.rand(8, n).astype(np.float32) * 0.02
    for i in range(4):
        p[i] *= 0.001
        q[i] *= 0.001
        p[i, rng.randint(n)] = 0.5
        q[i, rng.randint(n)] = 0.45
    yield {"spectral": (pred, gt), "ambi": (a_pred, a_gt), "hist": (p, q),
           "mesh30": mesh30}
    torch.set_num_threads(threads)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t", [4800, 1000])
def test_mel_lsd_matches_jax(data, t):
    """atol 1e-5 dB: reflect framing (T > 1024) and the constant framing of
    short signals; an identical pair gives 0."""
    pred, gt = (x[:, :t] for x in data["spectral"])
    want = np.asarray(jax.jit(jax_metrics.mel_lsd_batch_fn(RATE))(pred, gt))
    got = eval_metrics.mel_lsd_batch_fn(RATE)(*_t(pred, gt)).numpy()
    assert got.shape == want.shape == (4, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[1] < 1e-6)


def test_envelope_matches_jax(data):
    pred, gt = data["spectral"]
    want = np.asarray(jax.jit(jax_metrics.envelope_dist_fn(4800))(pred, gt))
    got = eval_metrics.envelope_dist_fn(4800)(*_t(pred, gt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("t", [256, 255])
def test_hilbert_kernel_matches_jax(t):
    """Even and odd lengths, atol 1e-6 (the same numpy arithmetic)."""
    np.testing.assert_allclose(eval_metrics._hilbert_kernel(t),
                               jax_metrics._hilbert_kernel(t), atol=1e-6)


def test_dft_mats_and_half_basis_match_jax():
    for got, want in zip(eval_metrics._dft_mats(2048), jax_metrics._dft_mats(2048)):
        np.testing.assert_array_equal(got, want)


def test_spherical_power_maps_matches_jax(data):
    a_pred, _ = data["ambi"]
    sph = np.asarray(mesh_decoder(*spherical_mesh(30.0), 1).sph_mat, np.float32)
    want = np.asarray(spherical_power_maps_jnp(jnp.asarray(a_pred), jnp.asarray(sph), 1200))
    got = spherical_power_maps(*_t(a_pred, sph), 1200).numpy()
    assert got.shape == want.shape == (6, 4, sph.shape[0])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_emd_hat_sinkhorn_matches_jax_and_exact(data):
    """Against the JAX function at rtol 2e-5 / atol 1e-6 (float32 rounding
    of the two log-sum-exp implementations, carried through 200
    iterations: 1.0e-5 relative measured on a concentrated pair), and
    against the exact solver at tests/test_sinkhorn.py's tolerance (rtol
    5e-3, atol 1e-5)."""
    p, q = data["hist"]
    mesh30 = data["mesh30"]
    want = np.asarray(jax.jit(lambda a, c: jax_sinkhorn.emd_hat_sinkhorn(
        a, c, jnp.asarray(mesh30)))(p, q))
    got = sinkhorn.emd_hat_sinkhorn(*_t(p, q, mesh30)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    exact = np.array([emd.emd_hat(p[i], q[i], mesh30.astype(np.float64))
                      for i in range(p.shape[0])])
    np.testing.assert_allclose(got, exact, rtol=5e-3, atol=1e-5)


def test_emd_hat_sinkhorn_degenerate_pairs(data):
    """tests/test_sinkhorn.py's degenerate pairs: an all-zero pair gives 0,
    not NaN (the log floor is a normal float32), an identical pair 0, a
    pure mass mismatch the closed-form penalty."""
    mesh30 = torch.from_numpy(data["mesh30"])
    n = mesh30.shape[0]
    z = torch.zeros((1, n))
    assert float(sinkhorn.emd_hat_sinkhorn(z, z, mesh30)[0]) == 0.0
    p = torch.from_numpy(np.random.RandomState(1).rand(1, n).astype(np.float32))
    assert abs(float(sinkhorn.emd_hat_sinkhorn(p, p, mesh30)[0])) < 1e-6
    exact = emd.emd_hat(2 * p[0].double().numpy(), p[0].double().numpy(),
                        data["mesh30"].astype(np.float64))
    approx = float(sinkhorn.emd_hat_sinkhorn(2 * p, p, mesh30)[0])
    np.testing.assert_allclose(approx, exact, rtol=1e-3)


def test_sinkhorn_numerics():
    """The 1e-30 floor is a normal float32; an all -inf slice gives -inf
    from the log-sum-exp, not NaN; the annealing schedule is float32, 32x
    epsilon down to epsilon over the first half, then flat."""
    floor = torch.tensor(sinkhorn.LOG_FLOOR, dtype=torch.float32)
    assert float(floor) >= torch.finfo(torch.float32).tiny
    x = torch.tensor([[-np.inf, -np.inf, -np.inf], [0.0, -np.inf, 1.0]])
    out = torch.logsumexp(x, dim=1)   # the reduction sinkhorn_cost runs
    assert float(out[0]) == -np.inf
    np.testing.assert_allclose(float(out[1]), np.log(1 + np.e), rtol=1e-6)
    sched = sinkhorn.annealing_schedule(0.02, 200)
    assert sched.dtype == np.float32 and sched.shape == (200,)
    assert sched[0] == np.float32(0.64) and (sched[99:] == np.float32(0.02)).all()
    assert (np.diff(sched[:100]) < 0).all()


def test_ambix_emd_batch_matches_jax_and_host(data):
    """Both EMD variants of a batch against the JAX function and against the
    host's exact ambix_emd: emd/dir at atol 1e-6 (penalty-dominated),
    emd/dir2 at 5e-5 (transport-dominated), the JAX file's tolerances."""
    a_pred, a_gt = data["ambi"]
    want = [np.asarray(x) for x in jax.jit(
        jax_sinkhorn.ambix_emd_batch_fn(RATE, 30.0))(a_pred, a_gt)]
    got = [x.numpy() for x in sinkhorn.ambix_emd_batch_fn(RATE, 30.0)(*_t(a_pred, a_gt))]
    host = np.array([emd.ambix_emd(a_pred[i], a_gt[i], RATE, ang_res=30)
                     for i in range(a_pred.shape[0])])
    for i, atol in enumerate((1e-6, 5e-5)):
        np.testing.assert_allclose(got[i], want[i], atol=atol)
        np.testing.assert_allclose(got[i], host[:, i], atol=atol)


def test_copied_host_modules_match_bit_for_bit(data, tmp_path):
    """The copies give the originals' outputs exactly: ambix_emd, the host
    mel-LSD and envelope, the mesh decoder's SH matrix, and the
    eval-detailed parser and aggregate."""
    pred, gt = data["spectral"]
    a_pred, a_gt = data["ambi"]
    assert emd.ambix_emd(a_pred[0], a_gt[0], RATE, ang_res=30) == jax_emd.ambix_emd(
        a_pred[0], a_gt[0], RATE, ang_res=30)
    np.testing.assert_array_equal(host_metrics.compute_mel_lsd(pred[0], gt[0], RATE),
                                  jax_host.compute_mel_lsd(pred[0], gt[0], RATE))
    np.testing.assert_array_equal(host_metrics.compute_envelope_dist(pred[0], gt[0]),
                                  jax_host.compute_envelope_dist(pred[0], gt[0]))
    for res in (30.0, 5.0):
        mesh = spherical_mesh(res)
        np.testing.assert_array_equal(mesh_decoder(*mesh, 1).sph_mat,
                                      jax_mesh_decoder(*mesh, 1).sph_mat)
    header = "SampleID | mse/avg stft/avg env_mse/avg emd/dir\n"
    rows = [f"vid{v} {t}.5 | {0.1 * v + 0.01 * t} {2.0 + v} {0.02 * v} {0.03 + 0.01 * t}\n"
            for v in range(3) for t in range(4)]
    shards = [tmp_path / "eval-detailed.txt.shard0", tmp_path / "eval-detailed.txt.shard1"]
    shards[0].write_text(header + "".join(rows[:5]))
    shards[1].write_text(header + "".join(rows[5:]))
    fns = [str(s) for s in shards]
    got, want = parse_results.parse_eval_detailed_file(fns), \
        jax_parse.parse_eval_detailed_file(fns)
    assert got[2] == want[2] and sorted(got[0]) == sorted(want[0])
    for yid in want[0]:
        np.testing.assert_array_equal(got[0][yid], want[0][yid])
        np.testing.assert_array_equal(got[1][yid], want[1][yid])
    assert parse_results.aggregate(fns) == jax_parse.aggregate(fns)


def test_ambix_emd_native_route_and_linprog_fallback(data, monkeypatch):
    """The port's loader registers the EMD symbols, ambix_emd solves through
    sag_emd_hat_batch when the library loads, and without the library the
    scipy linprog route gives the same value."""
    from spatialaudiogen_tpu_torch.utils.native import has_symbol, load_native

    lib = load_native()
    assert lib is not None, "native/ did not build or load"
    assert has_symbol(lib, "sag_emd_hat") and has_symbol(lib, "sag_emd_hat_batch")
    calls = []

    class Spy:
        def __getattr__(self, name):
            fn = getattr(lib, name)

            def call(*args):
                calls.append(name)
                return fn(*args)

            return call

    a_pred, a_gt = data["ambi"]
    monkeypatch.setattr(emd, "_load_native", lambda: Spy())
    native = emd.ambix_emd(a_pred[0], a_gt[0], RATE, ang_res=30)
    assert calls == ["sag_emd_hat_batch"] * 2
    monkeypatch.setattr(emd, "_load_native", lambda: None)
    fallback = emd.ambix_emd(a_pred[0], a_gt[0], RATE, ang_res=30)
    np.testing.assert_allclose(fallback, native, rtol=1e-6, atol=1e-9)
