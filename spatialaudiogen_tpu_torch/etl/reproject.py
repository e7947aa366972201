"""Generic 360 reprojection: equirect / cubemap / side-by-side fisheye (the
port's copy of spatialaudiogen_tpu.etl.reproject).

The reference vendors vrProjector for this general surface
(3rd-party/vrProjector/AbstractProjection.py:95-105: per-pixel Python loops,
dest texcoord -> (theta, phi) -> source pixel) but only ever uses the
EAC->equirect path (etl/projections.py here, closed form). This module
completes the generic capability as vectorized numpy: every projection maps
whole (theta, phi) grids at once, and `reproject` is one fancy-indexed
bilinear gather — no per-pixel loop, no thread pool.

Angle conventions follow vrProjector exactly so outputs are comparable:
  * ray(theta, phi) = (cos phi cos theta, cos phi sin theta, sin phi)
    (AbstractProjection.point_on_sphere)
  * equirect: u = 0.5 + theta/(2 pi), v = 0.5 + phi/pi
    (EquirectangularProjection.py:23-42)
  * cubemap: six (H, W) faces keyed front/right/back/left/top/bottom with
    CubemapProjection._pixel_value orientations (shared with
    etl.projections.ray_to_face_uv / face_uv_to_ray)
  * side-by-side fisheye: per-hemisphere orthographic azimuthal halves,
    right hemisphere (theta >= 0) in the right half image
    (SideBySideFisheyeProjection.py:22-71); texcoords outside either
    half's circle are invalid and render black, as the reference does.
"""

from __future__ import annotations

import numpy as np

from spatialaudiogen_tpu_torch.etl.projections import (
    FACES,
    bilinear_sample,
    face_uv_to_ray,
    ray_to_face_uv,
)


def angles_to_ray(theta, phi):
    """(theta, phi) -> unit rays, vrProjector point_on_sphere convention."""
    c = np.cos(phi)
    return np.stack([c * np.cos(theta), c * np.sin(theta), np.sin(phi)],
                    axis=-1)


def ray_to_angles(rays):
    theta = np.arctan2(rays[..., 1], rays[..., 0])
    phi = np.arcsin(np.clip(rays[..., 2], -1.0, 1.0))
    return theta, phi


def _uv_grid(height: int, width: int):
    """Texcoord grid matching the reference loop (u = x/W, v = y/H over
    integer pixel indices, AbstractProjection.reprojectToThis)."""
    u = (np.arange(width) / float(width))[None, :].repeat(height, 0)
    v = (np.arange(height) / float(height))[:, None].repeat(width, 1)
    return u, v


class EquirectangularProjection:
    """Single (H, W[, C]) equirect image."""

    def __init__(self, image: np.ndarray | None = None, shape=None):
        self.image = image
        self.shape = image.shape[:2] if image is not None else tuple(shape)

    def to_angles(self, u, v):
        theta = 2.0 * np.pi * (np.asarray(u) - 0.5)
        phi = np.pi * (np.asarray(v) - 0.5)
        return theta, phi, np.ones(np.shape(theta), bool)

    def sample(self, theta, phi):
        h, w = self.shape
        u = 0.5 + 0.5 * theta / np.pi
        v = 0.5 + phi / np.pi
        return bilinear_sample(self.image, np.clip(v * h, 0, h - 1),
                               np.clip(u * w, 0, w - 1))


class CubemapProjection:
    """Six square faces, dict keyed by etl.projections.FACES names."""

    def __init__(self, faces: dict | None = None, shape=None):
        self.faces = faces
        if faces is not None:
            self.shape = faces["front"].shape[:2]
            assert set(faces) == set(FACES), sorted(faces)
        else:
            self.shape = tuple(shape)

    def to_angles(self, u, v, face: str = "front"):
        """Texcoords of ONE face -> angles (reproject targets iterate faces)."""
        rays = face_uv_to_ray(face, u, v)
        theta, phi = ray_to_angles(rays)
        return theta, phi, np.ones(np.shape(theta), bool)

    def sample(self, theta, phi):
        rays = angles_to_ray(theta, phi)
        face_idx, u, v = ray_to_face_uv(rays)
        h, w = self.shape
        out = None
        for i, name in enumerate(FACES):
            mask = face_idx == i
            if not mask.any():
                continue
            vals = bilinear_sample(self.faces[name],
                                   np.clip(v[mask] * h, 0, h - 1),
                                   np.clip(u[mask] * w, 0, w - 1))
            if out is None:
                out = np.zeros(theta.shape + vals.shape[1:], vals.dtype)
            out[mask] = vals
        return out


class SideBySideFisheyeProjection:
    """Two orthographic-azimuthal hemispheres side by side (vrProjector
    SideBySideFisheyeProjection): left half image = theta < 0 hemisphere,
    right half = theta >= 0."""

    def __init__(self, image: np.ndarray | None = None, shape=None):
        self.image = image
        self.shape = image.shape[:2] if image is not None else tuple(shape)

    def to_angles(self, u, v):
        """Texcoords -> angles; invalid outside each half's circle
        (SideBySideFisheyeProjection.angular_position)."""
        up = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        right = up >= 0.5
        uu = np.where(right, 2.0 * (up - 0.5), 2.0 * up)
        valid = (uu - 0.5) ** 2 + (v - 0.5) ** 2 <= 0.25
        phi = np.arcsin(np.clip(2.0 * (v - 0.5), -1.0, 1.0))
        cosphi = np.cos(phi)
        arg = np.where(valid & (cosphi > 0),
                       np.clip(2.0 * ((1.0 - uu) - 0.5)
                               / np.where(cosphi > 0, cosphi, 1.0), -1, 1),
                       1.0)
        theta = np.arccos(arg)
        theta = np.where(right, theta, theta - np.pi)
        return theta, phi, valid

    def sample(self, theta, phi):
        """(theta, phi) -> pixels (SideBySideFisheyeProjection._pixel_value)."""
        rays = angles_to_ray(theta, phi)
        u = 0.5 + rays[..., 0] * -0.5
        u = np.where(theta >= 0, u * 0.5 + 0.5, (1.0 - u) * 0.5)
        v = 0.5 + rays[..., 2] * 0.5
        h, w = self.shape
        return bilinear_sample(self.image, np.clip(v * h, 0, h - 1),
                               np.clip(u * w, 0, w - 1))


def reproject(source, target_cls, shape, channels: int | None = None):
    """Render `source` into a new projection of class `target_cls` at
    `shape` — the vectorized equivalent of vrProjector's reprojectToThis
    (AbstractProjection.py:95-105). Invalid target texcoords (e.g. fisheye
    corners) render 0, as the reference does. Returns the target projection
    instance with its image(s) filled."""
    h, w = shape
    u, v = _uv_grid(h, w)

    def render(theta, phi, valid):
        vals = source.sample(theta, phi)
        if not valid.all():
            vals = vals * valid[..., None] if vals.ndim == 3 else vals * valid
        return vals

    if target_cls is CubemapProjection:
        tgt = CubemapProjection(shape=shape)
        tgt.faces = {}
        for face in FACES:
            theta, phi, valid = tgt.to_angles(u, v, face)
            tgt.faces[face] = render(theta, phi, valid)
        return tgt
    tgt = target_cls(shape=shape)
    theta, phi, valid = tgt.to_angles(u, v)
    tgt.image = render(theta, phi, valid)
    return tgt
