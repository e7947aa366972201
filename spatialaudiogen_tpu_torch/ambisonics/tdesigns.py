"""Spherical t-designs / loudspeaker layouts for ambisonic decoding (the
port's copy of spatialaudiogen_tpu.ambisonics.tdesigns, numpy and scipy).

The reference parses layouts from a C++ header that is absent from its repo
(pyutils/ambisonics/tdesigns.py:4 imports '../ambisonics/src/tDesigns.hpp',
a missing blob), so layouts here are first-class data instead: exact platonic
solids plus numerically optimized spherical designs.

A point set X is a spherical t-design iff equal-weight quadrature over X
integrates all spherical harmonics up to degree t exactly, i.e.
(4*pi/N) * Y(X)^T Y(X) = I for N3D-normalized SH up to order t — exactly the
condition that makes projection/pseudoinverse ambisonic decoding on X exact.
`make_tdesign` optimizes that residual directly (scipy's L-BFGS-B).
"""

from __future__ import annotations

import functools
from math import sqrt

import numpy as np

# --------------------------------------------------------------------------
# Exact layouts.
# --------------------------------------------------------------------------

_PHI = (1.0 + sqrt(5.0)) / 2.0  # golden ratio


def _unit(rows):
    x = np.asarray(rows, dtype=np.float64)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


TETRAHEDRON = _unit([(1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)])            # 2-design
OCTAHEDRON = _unit([(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)])  # 3-design
CUBE = _unit([(sx, sy, sz) for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)])  # 3-design
ICOSAHEDRON = _unit(
    [(0, s1, s2 * _PHI) for s1 in (1, -1) for s2 in (1, -1)]
    + [(s1, s2 * _PHI, 0) for s1 in (1, -1) for s2 in (1, -1)]
    + [(s2 * _PHI, 0, s1) for s1 in (1, -1) for s2 in (1, -1)]
)  # 5-design
DODECAHEDRON = _unit(
    [(sx, sy, sz) for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)]
    + [(0, s1 / _PHI, s2 * _PHI) for s1 in (1, -1) for s2 in (1, -1)]
    + [(s1 / _PHI, s2 * _PHI, 0) for s1 in (1, -1) for s2 in (1, -1)]
    + [(s2 * _PHI, 0, s1 / _PHI) for s1 in (1, -1) for s2 in (1, -1)]
)  # 5-design


def design_residual(points: np.ndarray, order: int) -> float:
    """|| (4pi/N) Y^T Y - I ||_max for N3D SH up to `order` (0 for a t-design)."""
    from spatialaudiogen_tpu_torch.ambisonics.sh import sh_matrix_polar

    phi = np.arctan2(points[:, 1], points[:, 0])
    nu = np.arcsin(np.clip(points[:, 2], -1, 1))
    y = sh_matrix_polar(phi, nu, order, "ACN", "N3D")
    gram = 4 * np.pi / points.shape[0] * (y.T @ y)
    return float(np.abs(gram - np.eye(gram.shape[0])).max())


@functools.lru_cache(maxsize=None)
def make_tdesign(order: int, n_points: int, n_seeds: int = 3) -> np.ndarray:
    """Numerically optimize an n-point design exact for SH up to `order` (<=3).

    Deterministic (fixed seeds, best-of-n restarts, float64 L-BFGS); returns
    (n_points, 3) unit vectors. Converges to machine-precision designs for
    n_points >= 28 at order 3 (and trivially for lower orders).
    """
    from scipy.optimize import minimize

    from spatialaudiogen_tpu_torch.ambisonics.sh import sh_matrix_polar

    eye = np.eye((order + 1) ** 2)

    def loss(v):
        y = sh_matrix_polar(v[:n_points], v[n_points:], order, "ACN", "N3D")
        gram = 4 * np.pi / n_points * (y.T @ y)
        return np.sum((gram - eye) ** 2)

    best = None
    for seed in range(n_seeds):
        rng = np.random.RandomState(seed)
        x0 = np.concatenate([rng.uniform(-np.pi, np.pi, n_points),
                             np.arcsin(rng.uniform(-1, 1, n_points))])
        res = minimize(loss, x0, method="L-BFGS-B",
                       options={"maxiter": 20000, "ftol": 1e-20, "gtol": 1e-13})
        if best is None or res.fun < best.fun:
            best = res

    phi, nu = best.x[:n_points], best.x[n_points:]
    # nu is unconstrained during optimization; the SH evaluation sees the
    # point through (sin nu, |cos nu|) — reconstruct cartesian the same way.
    z = np.sin(nu)
    c = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([np.cos(phi) * c, np.sin(phi) * c, z], axis=1)


def get_tdesign(order: int, num_speakers: int | None = None) -> np.ndarray:
    """Speaker layout adequate for pseudoinverse decoding at `order`.

    Returns (N, 3) cartesian unit vectors (same contract as the reference's
    get_tDesign, tdesigns.py:28-36, minus its random choice among candidates).
    """
    exact = {
        (1, 4): TETRAHEDRON, (1, 6): OCTAHEDRON, (1, 8): CUBE,
        (1, 12): ICOSAHEDRON, (2, 12): ICOSAHEDRON, (2, 20): DODECAHEDRON,
    }
    if num_speakers is None:
        num_speakers = {1: 6, 2: 12, 3: 32}.get(order, 2 * (order + 1) ** 2)
    if (order, num_speakers) in exact:
        return exact[(order, num_speakers)]
    if order <= 3:
        return make_tdesign(order, num_speakers)
    raise ValueError(f"tDesign not available for order={order}, N={num_speakers}.")
