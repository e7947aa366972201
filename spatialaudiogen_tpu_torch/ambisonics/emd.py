"""Spatial EMD metric between ambisonic power maps.

Parity with reference pyutils/ambisonics/distance.py:100-143 (`emd`,
`ambix_emd`) where pyemd (C++ EMD) computed the histogram distance. Here the
exact solver is our own native C++ min-cost-flow library (native/emd/emd.cpp,
pyemd-compatible EMD-hat semantics with extra_mass_penalty=-1), loaded via
ctypes and built on demand; a scipy.linprog fallback keeps the metric exact
when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.maps import SphericalAmbisonicsVisualizer

def _load_native():
    """Load the shared native library (see utils.native); None on failure."""
    from spatialaudiogen_tpu_torch.utils.native import load_native

    return load_native()


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def emd_hat(p: np.ndarray, q: np.ndarray, dist: np.ndarray,
            extra_mass_penalty: float = -1.0) -> float:
    """Exact EMD-hat between histograms p (n,) and q (m,), ground dist (n, m)."""
    p = np.ascontiguousarray(p, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    dist = np.ascontiguousarray(dist, dtype=np.float64)
    lib = _load_native()
    if lib is not None:
        return float(lib.sag_emd_hat(p.size, q.size, _as_c(p), _as_c(q),
                                     _as_c(dist), float(extra_mass_penalty)))
    return _emd_hat_linprog(p, q, dist, extra_mass_penalty)


def _emd_hat_linprog(p, q, dist, extra_mass_penalty=-1.0) -> float:
    """Exact fallback via scipy HiGHS LP (same transportation formulation)."""
    from scipy.optimize import linprog

    n, m = p.size, q.size
    penalty = dist.max() if extra_mass_penalty < 0 else extra_mass_penalty
    target = min(p.sum(), q.sum())
    if target <= 1e-12:
        return abs(p.sum() - q.sum()) * penalty
    # Variables F_ij >= 0; row sums <= p, col sums <= q, total = target.
    a_ub, b_ub = [], []
    for i in range(n):
        row = np.zeros(n * m)
        row[i * m:(i + 1) * m] = 1.0
        a_ub.append(row)
        b_ub.append(p[i])
    for j in range(m):
        col = np.zeros(n * m)
        col[j::m] = 1.0
        a_ub.append(col)
        b_ub.append(q[j])
    a_eq = np.ones((1, n * m))
    res = linprog(dist.reshape(-1), A_ub=np.array(a_ub), b_ub=np.array(b_ub),
                  A_eq=a_eq, b_eq=[target], method="highs")
    assert res.success, res.message
    return float(res.fun) + abs(p.sum() - q.sum()) * penalty


def mesh_ground_distance(phi_mesh: np.ndarray, nu_mesh: np.ndarray) -> np.ndarray:
    """Great-circle (arc-cos) distance between all grid node pairs."""
    x = np.cos(nu_mesh) * np.cos(phi_mesh)
    y = np.cos(nu_mesh) * np.sin(phi_mesh)
    z = np.sin(nu_mesh)
    p = np.stack((x, y, z), 0).reshape((3, -1))
    cosang = np.clip(p.T @ p, -1.0, 1.0)
    return np.arccos(cosang)


def emd(map1: np.ndarray, map2: np.ndarray, phi_mesh: np.ndarray,
        nu_mesh: np.ndarray) -> tuple[float, float]:
    """Per-frame EMD between RMS map stacks; returns (dir_err, power_err).

    Matches reference distance.py:100-126: the first variant divides by the
    node count (mass mismatch penalized at max distance), the second
    normalizes each map to ~unit mass.
    """
    ang_dist = mesh_ground_distance(phi_mesh, nu_mesh)
    if map1.ndim == 2:
        map1 = map1[np.newaxis]
    if map2.ndim == 2:
        map2 = map2[np.newaxis]
    nframes = map1.shape[0]
    m1 = np.ascontiguousarray(map1.reshape(nframes, -1), dtype=np.float64)
    m2 = np.ascontiguousarray(map2.reshape(nframes, -1), dtype=np.float64)
    n_nodes = m1.shape[1]

    lib = _load_native()
    if lib is not None:
        out1 = np.zeros(nframes)
        out2 = np.zeros(nframes)
        a = np.ascontiguousarray(m1 / n_nodes)
        b = np.ascontiguousarray(m2 / n_nodes)
        lib.sag_emd_hat_batch(nframes, n_nodes, n_nodes, _as_c(a), _as_c(b),
                              _as_c(ang_dist), -1.0, _as_c(out1))
        a2 = np.ascontiguousarray(m1 / (m1.sum(axis=1, keepdims=True) + 0.01))
        b2 = np.ascontiguousarray(m2 / (m2.sum(axis=1, keepdims=True) + 0.01))
        lib.sag_emd_hat_batch(nframes, n_nodes, n_nodes, _as_c(a2), _as_c(b2),
                              _as_c(ang_dist), -1.0, _as_c(out2))
        return float(out1.mean()), float(out2.mean())

    d1 = [emd_hat(m1[t] / n_nodes, m2[t] / n_nodes, ang_dist) for t in range(nframes)]
    d2 = [emd_hat(m1[t] / (m1[t].sum() + 0.01), m2[t] / (m2[t].sum() + 0.01), ang_dist)
          for t in range(nframes)]
    return float(np.mean(d1)), float(np.mean(d2))


def ambix_emd(ambi1: np.ndarray, ambi2: np.ndarray, rate: int,
              ang_res: float = 20) -> tuple[float, float]:
    """Headline spatial eval metric (reference distance.py:129-143)."""
    vis1 = SphericalAmbisonicsVisualizer(ambi1, rate, window=0.1, angular_res=ang_res)
    vis2 = SphericalAmbisonicsVisualizer(ambi2, rate, window=0.1, angular_res=ang_res)
    directional, power = [], []
    for rms1, rms2 in zip(vis1.loop_frames(), vis2.loop_frames()):
        derr, perr = emd(rms1, rms2, vis1.phi_mesh, vis1.nu_mesh)
        directional.append(derr)
        power.append(perr)
    return float(np.mean(directional)), float(np.mean(power))
