"""CIPIC HRIR database loader with nearest-direction lookup (the port's copy
of spatialaudiogen_tpu.ambisonics.hrir).

Parity with reference pyutils/ambisonics/hrir.py: loads the 23x50
azimuth/elevation HRIR grid from per-azimuth wav files (columns = elevations)
and answers nearest-neighbour queries on the unit sphere. The JAX package
queries a scikit-learn KDTree; here the 1150 grid directions are searched
exhaustively in numpy (the same nearest point, with no scikit-learn).
"""
from __future__ import annotations

import os
from math import cos, pi, sin, sqrt

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.position import Position
from spatialaudiogen_tpu_torch.utils.io_audio import load_wav

CIPIC_ELEVATIONS = np.array([
    -45, -39, -34, -28, -23, -17, -11, -6, 0, 6, 11, 17, 23, 28, 34, 39, 45, 51,
    56, 62, 68, 73, 79, 84, 90, 96, 101, 107, 113, 118, 124, 129, 135, 141, 146,
    152, 158, 163, 169, 174, 180, 186, 191, 197, 203, 208, 214, 219, 225, 231])
CIPIC_AZIMUTHS = np.array([
    -80, -65, -55, -45, -35, -30, -25, -20, -15, -10, -5, 0, 5, 10, 15, 20, 25,
    30, 35, 45, 55, 65, 80])


class CipicHRIR:
    def __init__(self, dirname: str):
        n_az, n_el = len(CIPIC_AZIMUTHS), len(CIPIC_ELEVATIONS)
        self.right_hrir = np.zeros((200, n_az, n_el))
        self.left_hrir = np.zeros((200, n_az, n_el))
        for i, phi in enumerate(CIPIC_AZIMUTHS):
            stem = ("neg" if phi < 0 else "") + str(abs(phi))
            self.right_hrir[:, i, :] = np.flip(load_wav(os.path.join(dirname, stem + "azright.wav"))[0], axis=0)
            self.left_hrir[:, i, :] = np.flip(load_wav(os.path.join(dirname, stem + "azleft.wav"))[0], axis=0)

        radius = 3.0
        self.hrir_db = []
        for i, az in enumerate(CIPIC_AZIMUTHS):
            for j, elev in enumerate(CIPIC_ELEVATIONS):
                # CIPIC interaural coords -> our head coords (x front, y left).
                xp = radius * cos(elev * pi / 180.0) * sin(az * pi / 180.0)
                yp = radius * cos(elev * pi / 180.0) * cos(az * pi / 180.0)
                zp = radius * sin(elev * pi / 180.0)
                p = Position(yp, -xp, zp, "cartesian")
                self.hrir_db.append((p, self.left_hrir[:, i, j], self.right_hrir[:, i, j]))

        self.directions = np.array([h[0].coords("cartesian")
                                    / np.linalg.norm(h[0].coords("cartesian"))
                                    for h in self.hrir_db])

    def get_closest(self, pos: Position):
        assert isinstance(pos, Position)
        v = np.array([pos.x, pos.y, pos.z]).reshape(1, -1)
        v = v / sqrt(pos.x ** 2 + pos.y ** 2 + pos.z ** 2)
        i = int(np.argmin(((self.directions - v) ** 2).sum(axis=1)))
        return self.hrir_db[i]


# Reference-name alias.
CIPIC_HRIR = CipicHRIR
