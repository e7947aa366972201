"""360 projection math: equirectangular <-> cubemap <-> YouTube EAC (the
port's copy of spatialaudiogen_tpu.etl.projections).

Replaces the reference's vrProjector (per-pixel Python loops over a
multiprocessing pool, 3rd-party/vrProjector) and scraping/utils.py's
triple-interpolation map construction with closed-form vectorized numpy:
each output pixel maps straight through ray -> cube face -> EAC warp ->
source pixel, no intermediate resampling.

Conventions (matching vrProjector so real YouTube-EAC videos remap
identically, CubemapProjection.py:69-135 / EquirectangularProjection.py):
  * equirect pixel (row y, col x) of HxW: theta = 2pi(x/W - 0.5),
    phi = pi(y/H - 0.5); ray = (cos phi cos theta, cos phi sin theta, sin phi)
  * cube faces front(+x) back(-x) right(+y) left(-y) bottom(+z) top(-z) with
    the uv orientations of CubemapProjection._pixel_value
  * EAC warps each face coordinate c in [-0.5, 0.5] as
    eac = arctan(2c) * 2/pi (equi-angular; scraping/utils.py:96-108)
  * EAC 2x3 face layout [left front right / bottom* back* top*] where the
    bottom row is stored rotated (scraping/utils.py:125-131); STEREO frames
    keep only the first eye (left half, rotated).
"""

from __future__ import annotations

import numpy as np

FACES = ("front", "back", "right", "left", "bottom", "top")


def equirect_rays(height: int, width: int):
    """Per-pixel unit rays of an equirect image (vrProjector angles)."""
    x = np.arange(width)[None, :].repeat(height, 0)
    y = np.arange(height)[:, None].repeat(width, 1)
    theta = 2 * np.pi * (x / float(width) - 0.5)
    phi = np.pi * (y / float(height) - 0.5)
    c = np.cos(phi)
    return np.stack([c * np.cos(theta), c * np.sin(theta), np.sin(phi)], axis=-1)


def ray_to_face_uv(rays: np.ndarray):
    """(..., 3) rays -> (face_index, u, v) with u, v in [0, 1].

    Face index order follows FACES; selection mirrors vrProjector's cascade
    (dominant axis wins because the uv bounds check only passes there).
    """
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    face = np.zeros(x.shape, np.int8)
    u = np.zeros_like(x)
    v = np.zeros_like(x)

    def assign(mask, idx, uu, vv):
        face[mask] = idx
        u[mask] = uu[mask]
        v[mask] = vv[mask]

    eps = 1e-12
    m_x = (ax >= ay) & (ax >= az)
    m_y = ~m_x & (ay >= az)
    m_z = ~m_x & ~m_y
    with np.errstate(divide="ignore", invalid="ignore"):
        assign(m_x & (x > 0), 0, 0.5 + 0.5 * y / (ax + eps), 0.5 + 0.5 * z / (ax + eps))
        assign(m_x & (x <= 0), 1, 0.5 - 0.5 * y / (ax + eps), 0.5 + 0.5 * z / (ax + eps))
        assign(m_y & (y > 0), 2, 0.5 - 0.5 * x / (ay + eps), 0.5 + 0.5 * z / (ay + eps))
        assign(m_y & (y <= 0), 3, 0.5 + 0.5 * x / (ay + eps), 0.5 + 0.5 * z / (ay + eps))
        assign(m_z & (z > 0), 4, 0.5 + 0.5 * y / (az + eps), 0.5 - 0.5 * x / (az + eps))
        assign(m_z & (z <= 0), 5, 0.5 + 0.5 * y / (az + eps), 0.5 + 0.5 * x / (az + eps))
    return face, np.clip(u, 0, 1), np.clip(v, 0, 1)


def face_uv_to_ray(face: str, u, v):
    """Inverse of ray_to_face_uv for a named face; u, v in [0, 1]."""
    a = 2.0 * (np.asarray(u) - 0.5)
    b = 2.0 * (np.asarray(v) - 0.5)
    one = np.ones_like(a)
    vecs = {
        "front": (one, a, b),
        "back": (-one, -a, b),
        "right": (-a, one, b),
        "left": (a, -one, b),
        "bottom": (-b, a, one),
        "top": (b, a, -one),
    }[face]
    d = np.stack(vecs, axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def cube_to_eac_coord(c):
    """Cube face coordinate in [-0.5, 0.5] -> EAC coordinate (equi-angular)."""
    return np.arctan(2.0 * np.asarray(c)) * 2.0 / np.pi


def eac_to_cube_coord(e):
    """Inverse warp: EAC coordinate in [-0.5, 0.5] -> cube coordinate."""
    return np.tan(np.asarray(e) * np.pi / 2.0) / 2.0


# --- EAC frame layout -------------------------------------------------------
# Block placement inside the (stereo-cropped) EAC grid, and the rotation that
# the extraction applies to bottom-row blocks (scraping/utils.py:125-131):
#   rot = -1 -> extracted = np.rot90(block, -1); +1 -> np.rot90(block, 1)
_EAC_LAYOUT = {
    "left": (0, 0, 0), "front": (0, 1, 0), "right": (0, 2, 0),
    "bottom": (1, 0, -1), "back": (1, 1, 1), "top": (1, 2, -1),
}


def eac_source_coords(eac_shape, face: str, u, v, stereopsis: str = "MONO"):
    """Map face uv (floats in [0,1]) -> (row, col) pixel coords in the raw
    EAC frame, through the equi-angular warp, block rotation, and optional
    stereo crop."""
    height, width = eac_shape
    if stereopsis == "STEREO":
        grid_h, grid_w = width // 2, height
    else:
        grid_h, grid_w = height, width
    hs, ws = grid_h // 2, grid_w // 3

    # uv -> EAC face-internal coords (extracted-face orientation)
    ex = (cube_to_eac_coord(np.asarray(u) - 0.5) + 0.5)
    ey = (cube_to_eac_coord(np.asarray(v) - 0.5) + 0.5)
    row_idx, col_idx, rot = _EAC_LAYOUT[face]
    bh, bw = hs, ws
    if rot == 0:
        r = ey * (bh - 1)
        c = ex * (bw - 1)
    elif rot == -1:
        # extracted[i, j] = block[bh-1-j, i]; extracted is (bw, bh)-shaped
        i = ey * (bw - 1)
        j = ex * (bh - 1)
        r = (bh - 1) - j
        c = i
    else:  # rot == +1: extracted[i, j] = block[j, bw-1-i]; extracted (bw, bh)
        i = ey * (bw - 1)
        j = ex * (bh - 1)
        r = j
        c = (bw - 1) - i
    row = r + row_idx * hs
    col = c + col_idx * ws

    if stereopsis == "STEREO":
        # grid = rot90(E[:, :width//2], -1): grid[i, j] = E[height-1-j, i]
        erow = (height - 1) - col
        ecol = row
        return erow, ecol
    return row, col


def gen_eac2eqr_maps(eac_shape, eqr_shape, stereopsis: str = "MONO"):
    """ffmpeg-remap coordinate maps: for each equirect output pixel, the
    (xmap, ymap) source pixel in the raw EAC frame (scraping/utils.py:116-144
    capability, closed-form)."""
    rays = equirect_rays(*eqr_shape)
    face_idx, u, v = ray_to_face_uv(rays)
    xmap = np.zeros(eqr_shape, np.float32)
    ymap = np.zeros(eqr_shape, np.float32)
    for i, face in enumerate(FACES):
        mask = face_idx == i
        if not mask.any():
            continue
        row, col = eac_source_coords(eac_shape, face, u[mask], v[mask], stereopsis)
        ymap[mask] = row.astype(np.float32)
        xmap[mask] = col.astype(np.float32)
    return xmap, ymap


def bilinear_sample(image: np.ndarray, row: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Bilinear lookup with edge clamping; image (H, W[, C])."""
    h, w = image.shape[:2]
    r0 = np.clip(np.floor(row).astype(int), 0, h - 1)
    c0 = np.clip(np.floor(col).astype(int), 0, w - 1)
    r1 = np.clip(r0 + 1, 0, h - 1)
    c1 = np.clip(c0 + 1, 0, w - 1)
    fr = np.clip(row - r0, 0, 1)
    fc = np.clip(col - c0, 0, 1)
    if image.ndim == 3:
        fr = fr[..., None]
        fc = fc[..., None]
    img = image.astype(np.float64)
    return (img[r0, c0] * (1 - fr) * (1 - fc) + img[r1, c0] * fr * (1 - fc)
            + img[r0, c1] * (1 - fr) * fc + img[r1, c1] * fr * fc)


def remap(image: np.ndarray, xmap: np.ndarray, ymap: np.ndarray) -> np.ndarray:
    """Apply coordinate maps (ffmpeg `remap` filter equivalent, on host)."""
    return bilinear_sample(image, ymap, xmap)


def equirect_to_eac(eqr: np.ndarray, eac_shape, stereopsis: str = "MONO") -> np.ndarray:
    """Render an EAC frame from an equirect frame (the inverse pipeline;
    used for testing and synthetic EAC generation)."""
    height, width = eac_shape
    out_shape = (height, width) + eqr.shape[2:]
    out = np.zeros(out_shape, np.float64)
    # iterate over output pixels per face by inverting eac_source_coords:
    # build a dense (row, col)->face/uv assignment by rendering each face.
    if stereopsis == "STEREO":
        grid_h, grid_w = width // 2, height
    else:
        grid_h, grid_w = height, width
    hs, ws = grid_h // 2, grid_w // 3
    for face, (row_idx, col_idx, rot) in _EAC_LAYOUT.items():
        bh, bw = hs, ws
        rr = np.arange(bh)[:, None].repeat(bw, 1)
        cc = np.arange(bw)[None, :].repeat(bh, 0)
        if rot == 0:
            ey = rr / (bh - 1.0)
            ex = cc / (bw - 1.0)
        elif rot == -1:
            j = (bh - 1) - rr
            i = cc
            ey = i / (bw - 1.0)
            ex = j / (bh - 1.0)
        else:
            j = rr
            i = (bw - 1) - cc
            ey = i / (bw - 1.0)
            ex = j / (bh - 1.0)
        cu = eac_to_cube_coord(ex - 0.5) + 0.5
        cv = eac_to_cube_coord(ey - 0.5) + 0.5
        rays = face_uv_to_ray(face, cu, cv)
        theta = np.arctan2(rays[..., 1], rays[..., 0])
        phi = np.arcsin(np.clip(rays[..., 2], -1, 1))
        src_col = (theta / (2 * np.pi) + 0.5) * eqr.shape[1]
        src_row = (phi / np.pi + 0.5) * eqr.shape[0]
        block = bilinear_sample(eqr, np.clip(src_row, 0, eqr.shape[0] - 1),
                                np.clip(src_col, 0, eqr.shape[1] - 1))
        r0, c0 = row_idx * hs, col_idx * ws
        if stereopsis == "STEREO":
            # place into the rotated grid, then un-rotate into the raw frame
            grid_rows = rr + r0
            grid_cols = cc + c0
            eac_rows = (height - 1) - grid_cols
            eac_cols = grid_rows
            out[eac_rows, eac_cols] = block
        else:
            out[r0: r0 + bh, c0: c0 + bw] = block
    return out


def save_pgm(fp, coord_map: np.ndarray, max_value: int):
    """16-bit ASCII PGM writer for ffmpeg remap maps (utils.py:146-150)."""
    height, width = coord_map.shape[:2]
    fp.write(f"P2\n{width} {height}\n{max_value}\n")
    for i in range(height):
        fp.write(" ".join(str(int(n)) for n in coord_map[i]) + "\n")
