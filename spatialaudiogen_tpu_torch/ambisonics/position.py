"""Positions and (moving) point sources.

Parity with reference pyutils/ambisonics/position.py: `Position` keeps
cartesian and polar coordinates in sync (phi azimuth, nu elevation, r radius);
`MovingSource` linearly interpolates a polar trajectory at signal rate.
"""

from __future__ import annotations

from math import atan2, cos, sin, sqrt

import numpy as np


class Position:
    def __init__(self, x1, x2, x3, c_type: str):
        assert c_type.lower() in ("cartesian", "polar")
        self.x = self.y = self.z = 0.0
        self.phi = self.nu = self.r = 0.0
        if c_type.lower() == "cartesian":
            self.set_cartesian(x1, x2, x3)
        else:
            self.set_polar(x1, x2, x3)

    def clone(self) -> "Position":
        return Position(self.x, self.y, self.z, "cartesian")

    def set_cartesian(self, x, y, z):
        self.x, self.y, self.z = float(x), float(y), float(z)
        self._calc_polar()
        self._calc_cartesian()

    def set_polar(self, phi, nu, r):
        self.phi, self.nu, self.r = float(phi), float(nu), float(r)
        self._calc_cartesian()
        self._calc_polar()

    def _calc_cartesian(self):
        self.x = self.r * cos(self.phi) * cos(self.nu)
        self.y = self.r * sin(self.phi) * cos(self.nu)
        self.z = self.r * sin(self.nu)

    def _calc_polar(self):
        self.phi = atan2(self.y, self.x)
        self.nu = atan2(self.z, sqrt(self.x ** 2 + self.y ** 2))
        self.r = sqrt(self.x ** 2 + self.y ** 2 + self.z ** 2)

    def rotate(self, rot_matrix: np.ndarray):
        pos = rot_matrix @ np.array([self.x, self.y, self.z])
        self.x, self.y, self.z = float(pos[0]), float(pos[1]), float(pos[2])
        self._calc_polar()
        self._calc_cartesian()

    def set_radius(self, radius: float):
        self.r = float(radius)
        self._calc_cartesian()

    def coords(self, c_type: str) -> np.ndarray:
        if c_type == "cartesian":
            return np.array([self.x, self.y, self.z])
        if c_type == "polar":
            return np.array([self.phi, self.nu, self.r])
        raise ValueError("Unknown coordinate type. Use cartesian or polar.")

    def __repr__(self):
        return (f"Position(xyz=({self.x:.3f},{self.y:.3f},{self.z:.3f}), "
                f"polar=({self.phi:.3f},{self.nu:.3f},{self.r:.3f}))")


class PositionalSource:
    """A mono signal at a fixed position."""

    def __init__(self, signal: np.ndarray, position: Position, sample_rate: int = 44800):
        assert not isinstance(position, list)
        assert signal.ndim == 1
        self.signal = signal
        self.position = position
        self.sample_rate = sample_rate


class MovingSource(PositionalSource):
    """A mono signal whose position follows interpolated polar keypoints.

    `tic()` advances one signal frame, updating `self.position`
    (reference position.py:73-102 semantics, including floor-indexed keypoint
    assignment via linspace).
    """

    def __init__(self, signal: np.ndarray, positions: list, rate: int = 44800):
        super().__init__(signal, Position(0, 0, 0, "polar"), rate)
        duration = signal.shape[0] / float(rate)
        self.pts_p = positions
        self.npts = len(positions)
        self.pts_t = np.linspace(0, duration, self.npts)
        self.nframes = int(duration * rate)
        self.dt = 1.0 / float(rate)
        self.pts_idx = np.floor(np.linspace(0, self.npts - 1, self.nframes)).astype(int)
        self.cur_idx = -1

    def tic(self) -> bool:
        if self.cur_idx >= self.nframes - 1:
            return False
        self.cur_idx += 1
        cur_t = self.cur_idx * self.dt
        idx = self.pts_idx[self.cur_idx]
        if idx == self.npts - 1:
            self.position = self.pts_p[-1]
        else:
            alpha = (cur_t - self.pts_t[idx]) / (self.pts_t[idx + 1] - self.pts_t[idx])
            cur = alpha * self.pts_p[idx + 1].coords("polar") + (1 - alpha) * self.pts_p[idx].coords("polar")
            self.position.set_polar(cur[0], cur[1], cur[2])
        return True

    def trajectory(self) -> np.ndarray:
        """Vectorized variant: full (nframes, 3) polar trajectory in one shot."""
        t = np.arange(self.nframes) * self.dt
        idx = self.pts_idx
        pts = np.stack([p.coords("polar") for p in self.pts_p], axis=0)
        nxt = np.minimum(idx + 1, self.npts - 1)
        denom = self.pts_t[nxt] - self.pts_t[idx]
        denom[denom == 0] = 1.0
        alpha = np.clip((t - self.pts_t[idx]) / denom, 0.0, None)
        out = alpha[:, None] * pts[nxt] + (1 - alpha[:, None]) * pts[idx]
        out[idx == self.npts - 1] = pts[-1]
        return out
