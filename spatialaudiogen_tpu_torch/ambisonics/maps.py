"""Spherical power maps: decode ambisonics on an angular grid, window RMS
(the port's copy of spatialaudiogen_tpu.ambisonics.maps, with its device
function written for torch).

Parity with reference pyutils/ambisonics/distance.py:9-97 and
spherical_maps.py. The decode-grid + windowed-RMS computation is a single
(T, C) @ (C, G) matmul followed by a windowed mean — expressed batched so it
can run as one torch call on the card (`spherical_power_maps`) or vectorized
numpy on host.
"""

from __future__ import annotations

import numpy as np
import torch

from spatialaudiogen_tpu_torch.ambisonics.decoder import AmbiDecoder
from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
from spatialaudiogen_tpu_torch.ambisonics.position import MovingSource


def spherical_mesh(angular_res: float, inclusive_nu: bool = True):
    """(phi_mesh, nu_mesh) grids in radians.

    inclusive_nu=True matches distance.py:9-13 (nu range -90..90 inclusive);
    False matches spherical_maps.py:7-11 (exclusive).
    """
    phi_rg = np.flip(np.arange(-180.0, 180.0, angular_res) / 180.0 * np.pi, 0)
    hi = 90.1 if inclusive_nu else 90.0
    nu_rg = np.arange(-90.0, hi, angular_res) / 180.0 * np.pi
    return np.meshgrid(phi_rg, nu_rg)


def mesh_decoder(phi_mesh: np.ndarray, nu_mesh: np.ndarray, ambi_order: int,
                 rate: int = 22050) -> AmbiDecoder:
    fmt = AmbiFormat(order=int(ambi_order), sample_rate=rate)
    return AmbiDecoder((phi_mesh.reshape(-1), nu_mesh.reshape(-1)), fmt, method="projection")


def windowed_rms_maps(data: np.ndarray, sph_mat: np.ndarray, window_frames: int) -> np.ndarray:
    """All RMS map frames at once: (T, C) signal -> (T//win, H, W) stack.

    Decode to grid then RMS over consecutive windows; output rows flipped
    up-down like the reference visualizer (distance.py:53-55).
    """
    n_frames = data.shape[0] // window_frames
    x = data[: n_frames * window_frames] @ sph_mat.T            # (T, G)
    x = x.reshape(n_frames, window_frames, -1)
    rms = np.sqrt(np.mean(x ** 2, axis=1))                      # (F, G)
    return rms


class SphericalAmbisonicsVisualizer:
    """Windowed RMS power maps over a spherical grid (streaming API parity)."""

    def __init__(self, data: np.ndarray, rate: float = 22050, window: float = 0.1,
                 angular_res: float = 2.0):
        self.window = window
        self.angular_res = angular_res
        self.data = data
        self.phi_mesh, self.nu_mesh = spherical_mesh(angular_res, inclusive_nu=True)
        ambi_order = int(round(np.sqrt(data.shape[1]) - 1))
        self.decoder = mesh_decoder(self.phi_mesh, self.nu_mesh, ambi_order, rate)
        self.window_frames = int(self.window * rate)
        self.n_frames = data.shape[0] // self.window_frames
        self.output_rate = float(rate) / self.window_frames
        self.frame_dims = self.phi_mesh.shape
        self.cur_frame = -1
        # Precompute every frame in one matmul; stream from the stack.
        self._frames = windowed_rms_maps(data, self.decoder.sph_mat, self.window_frames)

    def visualization_rate(self) -> float:
        return self.output_rate

    def mesh(self):
        return self.nu_mesh, self.phi_mesh

    def get_next_frame(self):
        self.cur_frame += 1
        if self.cur_frame >= self.n_frames:
            return None
        rms = self._frames[self.cur_frame].reshape(self.phi_mesh.shape)
        return np.flipud(rms)

    def loop_frames(self):
        while True:
            rms = self.get_next_frame()
            if rms is None:
                break
            yield rms


class SphericalSourceVisualizer:
    """Ground-truth source position maps via nearest grid node (parity with
    distance.py:62-97)."""

    def __init__(self, position_fn: str, duration: float, rate: float = 10.0,
                 angular_res: float = 5):
        from sklearn.neighbors import KDTree

        from spatialaudiogen_tpu_torch.utils.io_position import read_position_file

        phi_mesh, nu_mesh = spherical_mesh(angular_res, inclusive_nu=True)
        x = np.cos(nu_mesh) * np.cos(phi_mesh)
        y = np.cos(nu_mesh) * np.sin(phi_mesh)
        z = np.sin(nu_mesh)
        self.p_mesh = np.stack((x, y, z), 0).reshape((3, -1))
        self.kdtree = KDTree(self.p_mesh.T, leaf_size=2, metric="euclidean")
        self.nframes = int(duration * rate)
        self.frame_dims = phi_mesh.shape

        positions, _, source_ids = read_position_file(position_fn)
        self.sources = [MovingSource(np.zeros((self.nframes,)), positions[sid], rate)
                        for sid in source_ids]
        self.cur_frame = -1

    def get_next_frame(self):
        self.cur_frame += 1
        if any(not src.tic() for src in self.sources):
            return None
        pmap = np.zeros((self.frame_dims[0] * self.frame_dims[1],))
        for src in self.sources:
            p_cart = src.position.coords("cartesian").reshape((1, 3))
            opt = self.kdtree.query(p_cart, return_distance=False)
            pmap[opt] += 1.0 / len(self.sources)
        return pmap.reshape(self.frame_dims)

    def loop_frames(self):
        while True:
            pmap = self.get_next_frame()
            if pmap is None:
                break
            yield pmap


class SphericalMapMachine:
    """Batch RMS map computation (parity with spherical_maps.py:14-43)."""

    def __init__(self, ambi_order: int = 1, window: int | None = None,
                 angular_res: float = 20.0):
        self.angular_res = angular_res
        self.phi_mesh, self.nu_mesh = spherical_mesh(angular_res, inclusive_nu=False)
        self.frame_shape = self.phi_mesh.shape
        self.window = window
        self.decoder = mesh_decoder(self.phi_mesh, self.nu_mesh, ambi_order)

    def compute(self, data: np.ndarray) -> np.ndarray:
        if self.window is not None:
            n_windows = data.shape[0] // self.window
            rms = windowed_rms_maps(data, self.decoder.sph_mat, self.window)
            return rms.reshape((n_windows,) + self.frame_shape)
        decoded = self.decoder.decode(data)
        return np.sqrt(np.mean(decoded ** 2, 0)).reshape(self.frame_shape)


def spherical_power_maps(ambi, sph_mat, window_frames: int):
    """Batched RMS maps on tensors: (B, T, C) x (G, C) -> (B, T//win, G).
    The counterpart of the JAX package's `spherical_power_maps_jnp`, on the
    tensors' device."""
    b, t, c = ambi.shape
    n = t // window_frames
    x = torch.einsum("btc,gc->btg", ambi[:, : n * window_frames], sph_mat)
    x = x.reshape(b, n, window_frames, -1)
    return torch.sqrt(torch.mean(x ** 2, dim=2))
