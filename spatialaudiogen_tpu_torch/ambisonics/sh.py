"""Real spherical harmonics, vectorized (port of
spatialaudiogen_tpu.ambisonics.sh).

Convention matches the reference (pyutils/ambisonics/common.py:151-178):

    Y_n^m(phi, nu) = (-1)^m * N(n, m) * P_n^{|m|}(sin nu)
                     * (cos(|m| phi) if m >= 0 else sin(|m| phi))

where `phi` is azimuth, `nu` elevation, P includes the Condon-Shortley phase
(scipy.special.lpmv), and N is the normalization factor from format.py.
The leading (-1)^m cancels the Condon-Shortley phase.

`spherical_harmonics_matrix` / `sh_matrix_polar` take any order (scipy
lpmv) and serve host DSP (encoding, decoding grids, eval maps).
`sh_matrix_polar_torch` is the closed form for orders 0..3 on tensors of
any device (the counterpart of the JAX package's `sh_matrix_polar_jnp`).
"""

from __future__ import annotations

import numpy as np
import torch

from spatialaudiogen_tpu_torch.ambisonics.format import (
    DEFAULT_NORMALIZATION,
    DEFAULT_ORDERING,
    index_to_degree_order,
    normalization_factor,
)


def _assoc_legendre(m: int, n: int, x: np.ndarray) -> np.ndarray:
    """P_n^m(x) with Condon-Shortley phase (scipy.special.lpmv)."""
    from scipy.special import lpmv

    return lpmv(m, n, x)


def spherical_harmonic_mn(order: int, degree: int, phi, nu,
                          normalization: str = DEFAULT_NORMALIZATION):
    """Single real SH term; `phi`/`nu` may be scalars or arrays."""
    phi = np.asarray(phi, dtype=np.float64)
    nu = np.asarray(nu, dtype=np.float64)
    # Index under ACN only feeds the normalization lookup (n, m invariant).
    from spatialaudiogen_tpu_torch.ambisonics.format import degree_order_to_index

    norm = normalization_factor(degree_order_to_index(order, degree), normalization=normalization)
    am = abs(degree)
    angular = np.cos(am * phi) if degree >= 0 else np.sin(am * phi)
    return (-1.0) ** degree * norm * _assoc_legendre(am, order, np.sin(nu)) * angular


def sh_matrix_polar(phi: np.ndarray, nu: np.ndarray, max_order: int,
                    ordering: str = DEFAULT_ORDERING,
                    normalization: str = DEFAULT_NORMALIZATION) -> np.ndarray:
    """SH matrix for arrays of angles: returns (len(phi), (max_order+1)^2)."""
    phi = np.asarray(phi, dtype=np.float64).reshape(-1)
    nu = np.asarray(nu, dtype=np.float64).reshape(-1)
    num_channels = int((max_order + 1) ** 2)
    Y = np.zeros((phi.size, num_channels), dtype=np.float64)
    for i in range(num_channels):
        n, m = index_to_degree_order(i, ordering)
        Y[:, i] = spherical_harmonic_mn(n, m, phi, nu, normalization)
    return Y


def spherical_harmonics(position, max_order: int,
                        ordering: str = DEFAULT_ORDERING,
                        normalization: str = DEFAULT_NORMALIZATION) -> np.ndarray:
    """SH vector for a single Position (compat with reference common.py:160-168)."""
    return sh_matrix_polar(position.phi, position.nu, max_order, ordering, normalization)[0]


def spherical_harmonics_matrix(positions, max_order: int,
                               ordering: str = DEFAULT_ORDERING,
                               normalization: str = DEFAULT_NORMALIZATION) -> np.ndarray:
    """SH matrix (num_positions, num_channels) from a list of Position objects."""
    phi = np.array([p.phi for p in positions], dtype=np.float64)
    nu = np.array([p.nu for p in positions], dtype=np.float64)
    return sh_matrix_polar(phi, nu, max_order, ordering, normalization)


def sh_matrix_polar_torch(phi: torch.Tensor, nu: torch.Tensor, max_order: int,
                          normalization: str = DEFAULT_NORMALIZATION) -> torch.Tensor:
    """SH matrix in ACN ordering for orders 0..3, on the tensors' device and
    in their dtype.

    phi, nu: tensors of one shape (...,). Returns (..., (order+1)^2). The
    closed forms expand P_n^{|m|}(sin nu) with the Condon-Shortley phase
    multiplied by (-1)^m (the phase-free associated Legendre functions)."""
    if not 0 <= max_order <= 3:
        raise ValueError(f"the closed form covers orders 0..3, got {max_order}")
    s = torch.sin(nu)          # sin(elevation) = z on the unit sphere
    c = torch.cos(nu)          # cos(elevation)

    def norm(n, m):
        return normalization_factor(n * (n + 1) + m, "ACN", normalization)

    cols = [norm(0, 0) * torch.ones_like(s)]
    if max_order >= 1:
        # phase-free P_1^0 = s; P_1^1 = c
        cols += [norm(1, -1) * c * torch.sin(phi), norm(1, 0) * s,
                 norm(1, 1) * c * torch.cos(phi)]
    if max_order >= 2:
        # P_2^0 = (3s^2-1)/2; P_2^1 = 3sc; P_2^2 = 3c^2
        cols += [norm(2, -2) * 3.0 * c * c * torch.sin(2 * phi),
                 norm(2, -1) * 3.0 * s * c * torch.sin(phi),
                 norm(2, 0) * 0.5 * (3.0 * s * s - 1.0),
                 norm(2, 1) * 3.0 * s * c * torch.cos(phi),
                 norm(2, 2) * 3.0 * c * c * torch.cos(2 * phi)]
    if max_order >= 3:
        # P_3^0 = (5s^3-3s)/2; P_3^1 = c(15s^2-3)/2; P_3^2 = 15sc^2; P_3^3 = 15c^3
        cols += [norm(3, -3) * 15.0 * c ** 3 * torch.sin(3 * phi),
                 norm(3, -2) * 15.0 * s * c * c * torch.sin(2 * phi),
                 norm(3, -1) * 0.5 * (15.0 * s * s - 3.0) * c * torch.sin(phi),
                 norm(3, 0) * 0.5 * (5.0 * s ** 3 - 3.0 * s),
                 norm(3, 1) * 0.5 * (15.0 * s * s - 3.0) * c * torch.cos(phi),
                 norm(3, 2) * 15.0 * s * c * c * torch.cos(2 * phi),
                 norm(3, 3) * 15.0 * c ** 3 * torch.cos(3 * phi)]
    return torch.stack(cols, dim=-1)
