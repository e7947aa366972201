"""Real spherical harmonics, vectorized on the host (the port's copy of the
numpy part of spatialaudiogen_tpu.ambisonics.sh).

Convention matches the reference (pyutils/ambisonics/common.py:151-178):

    Y_n^m(phi, nu) = (-1)^m * N(n, m) * P_n^{|m|}(sin nu)
                     * (cos(|m| phi) if m >= 0 else sin(|m| phi))

where `phi` is azimuth, `nu` elevation, P includes the Condon-Shortley phase
(scipy.special.lpmv), and N is the normalization factor from format.py.
The leading (-1)^m cancels the Condon-Shortley phase.

`spherical_harmonics_matrix` / `sh_matrix_polar` take any order (scipy
lpmv) and serve host DSP (encoding, decoding grids, eval maps). The JAX
package's closed-form device path, `sh_matrix_polar_jnp`, which no module
of that package calls, waits for the slice that ports the rest of the
library (ROADMAP item 15g).
"""

from __future__ import annotations

import numpy as np

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
