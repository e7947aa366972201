"""Ambisonic rotations in azimuth used by training augmentation (the port's
copy of spatialaudiogen_tpu.ambisonics.rotation).

The training feeder rotates chunks around the vertical axis; at first order
the matrix matches reference feeder.py:93-101 for ACN ordering [W, Y, Z, X]:

    W' = W
    Y' = X sin(a) + Y cos(a)
    Z' = Z
    X' = X cos(a) - Y sin(a)

`rotate_foa` applies it to (T, 4) chunks; `rotate_ambisonics` rotates any
order.
"""

from __future__ import annotations

import numpy as np


def foa_rotation_matrix(rotation: float) -> np.ndarray:
    """4x4 ACN rotation matrix R (sh_rotation_z at order 1); apply as
    chunk @ R.T."""
    assert -np.pi <= rotation < np.pi
    return sh_rotation_z(1, rotation)


def rotate_foa(chunk, rotation: float):
    """Rotate an ACN/SN3D FOA chunk (..., 4) by `rotation` radians azimuth."""
    return rotate_ambisonics(chunk, rotation, 1)


def sh_rotation_z(order: int, rotation: float) -> np.ndarray:
    """Azimuth rotation matrix for ACN-ordered SH of any order.

    A rotation about the vertical axis mixes only the +/-m pairs within each
    degree: with c = channel (n, m>0), s = channel (n, -m),
        c' = cos(m a) c - sin(m a) s,   s' = sin(m a) c + cos(m a) s,
    and m=0 channels are invariant. Specializes to foa_rotation_matrix at
    order 1. Apply as chunk @ R.T.
    """
    n_ch = (order + 1) ** 2
    rot = np.eye(n_ch)
    for n in range(1, order + 1):
        for m in range(1, n + 1):
            i_cos = n * (n + 1) + m      # ACN index of (n, +m)
            i_sin = n * (n + 1) - m      # ACN index of (n, -m)
            c, s = np.cos(m * rotation), np.sin(m * rotation)
            rot[i_cos, i_cos] = c
            rot[i_cos, i_sin] = -s
            rot[i_sin, i_cos] = s
            rot[i_sin, i_sin] = c
    return rot


def rotate_ambisonics(chunk, rotation: float, order: int | None = None):
    """Rotate an ACN-ordered ambisonic chunk (..., (order+1)^2) in azimuth."""
    if order is None:
        order = int(np.sqrt(chunk.shape[-1])) - 1
    rot = sh_rotation_z(order, rotation)
    if hasattr(chunk, "dtype") and chunk.dtype != rot.dtype:
        rot = rot.astype(chunk.dtype)
    return chunk @ rot.T
