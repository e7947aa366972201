"""Dense optical flow on a torch device: batched coarse-to-fine Horn-Schunck
(the port of spatialaudiogen_tpu.ops.flow).

The same solver as the JAX module, op for op: a Gaussian pyramid built by
edge-padded 5-tap binomial sums, a global affine pre-alignment by batched
6x6 Gauss-Newton (_affine_init), and per level n_warps rounds of bilinear
warp + Charbonnier-weighted Jacobi relaxation followed by a 3x3 median of
the flow (_median3); fb_occlusion adds a forward-backward consistency pass.
Every frame pair of a batch is solved at once, on (B, H, W) float32
tensors on any device; the entry point horn_schunck_flow runs on the card
unless the caller passes device="cpu". The JAX module holds no Pallas
kernel, and neither does this one: it is plain PyTorch, one launch per
tensor op (a Jacobi step is some twenty launches over the batch), so the
Jacobi loop is launch-bound on the card.

Where the arithmetic follows JAX's rather than torch's shortcut:
  * _warp is JAX's map_coordinates(order=1, mode="nearest"): floor,
    weights from the unclamped coordinate, corner indices clamped, four
    gathers summed in JAX's order; not grid_sample, whose [-1, 1]
    normalisation rounds each coordinate by about 1e-7 * W.
  * The stencils (_sep_conv, _conv3x3, _gradients, _median3) are shifted
    sums over replicate-padded views, as JAX writes them, so no cuDNN
    convolution (and no TF32) enters; _median3 is the median of nine
    views, which is one of them because nine is odd.
  * Division by a constant divides by a float32 tensor: torch turns a
    division by a Python scalar on CUDA into a product by its reciprocal.
  * _affine_init's two contractions run inside precision_scope("highest"),
    so no TF32 reaches them, and its 6x6 solves use linalg.solve_ex, which
    does not stop the stream to check each system (the trace ridge keeps
    them non-singular).
  * flow_pairs' photometric std is the population std (correction=0), as
    jnp.std is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spatialaudiogen_tpu_torch.ops.dft import precision_scope

# 5-tap binomial used for both pyramid smoothing and downsampling
_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
# Horn-Schunck neighbour average (the discrete Laplacian's stencil)
_HS_AVG = np.array([[1 / 12, 1 / 6, 1 / 12],
                    [1 / 6, 0.0, 1 / 6],
                    [1 / 12, 1 / 6, 1 / 12]])
CHARBONNIER_EPS = 0.01  # data-term robustness scale ([0,1] gray units)


def _f32(value: float) -> float:
    """`value` rounded to float32, as JAX casts a constant to the array's
    dtype (torch then casts it to float32 without a second rounding)."""
    return float(np.float32(value))


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor of `value` on `like`'s device (a divisor)."""
    return torch.tensor(_f32(value), dtype=like.dtype, device=like.device)


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """Edge (replicate) padding of the last two dims of (..., H, W)."""
    lead = x.shape[:-2]
    xp = F.pad(x.reshape((-1, 1) + x.shape[-2:]), (left, right, top, bottom),
               mode="replicate")
    return xp.reshape(lead + xp.shape[-2:])


def _shifted_sum(views, weights):
    """sum(view * weight), accumulated in order; zero weights skipped (JAX
    adds their +-0 products, which changes no sum)."""
    out = None
    for view, k in zip(views, weights):
        if k == 0.0:
            continue
        term = view * _f32(k)
        out = term if out is None else out + term
    return out


def _sep_conv(x, k1d):
    """Depthwise separable 2-D filter over (..., H, W), SAME edges."""
    pad = (len(k1d) - 1) // 2
    h, w = x.shape[-2:]
    xp = _pad_edge(x, pad, pad, 0, 0)
    x = _shifted_sum([xp[..., i: i + h, :] for i in range(len(k1d))], k1d)
    xp = _pad_edge(x, 0, 0, pad, pad)
    return _shifted_sum([xp[..., i: i + w] for i in range(len(k1d))], k1d)


def _conv3x3(x, kernel):
    """3x3 stencil over (..., H, W), edge-padded, as nine shifted views."""
    h, w = x.shape[-2:]
    xp = _pad_edge(x, 1, 1, 1, 1)
    return _shifted_sum([xp[..., dy: dy + h, dx: dx + w]
                         for dy in range(3) for dx in range(3)],
                        [kernel[dy, dx] for dy in range(3) for dx in range(3)])


def _downsample(x):
    return _sep_conv(x, _BINOMIAL5)[:, ::2, ::2]


def _warp(img, flow_u, flow_v):
    """Bilinear backward warp of (B, H, W) by per-pixel (u=dx, v=dy):
    JAX's map_coordinates(img, [y + v, x + u], order=1, mode="nearest")."""
    b, h, w = img.shape
    dev, dt = img.device, img.dtype
    cy = torch.arange(h, dtype=dt, device=dev)[:, None] + flow_v
    cx = torch.arange(w, dtype=dt, device=dev)[None, :] + flow_u
    y0, x0 = torch.floor(cy), torch.floor(cx)
    wy1, wx1 = cy - y0, cx - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = y0.long(), x0.long()
    rows = [iy0.clamp(0, h - 1) * w, (iy0 + 1).clamp(0, h - 1) * w]
    cols = [ix0.clamp(0, w - 1), (ix0 + 1).clamp(0, w - 1)]
    flat = img.reshape(b, h * w)
    out = None
    for row, wy in zip(rows, (wy0, wy1)):
        for col, wx in zip(cols, (wx0, wx1)):
            val = torch.gather(flat, 1, (row + col).reshape(b, h * w)).reshape(b, h, w)
            term = (wy * wx) * val
            out = term if out is None else out + term
    return out


def _gradients(i1, i2w):
    """Symmetric spatial gradients (averaged over both frames) + temporal."""
    avg = 0.5 * (i1 + i2w)
    pad_x = _pad_edge(avg, 0, 0, 1, 1)
    pad_y = _pad_edge(avg, 1, 1, 0, 0)
    ix = 0.5 * (pad_x[..., 2:] - pad_x[..., :-2])
    iy = 0.5 * (pad_y[..., 2:, :] - pad_y[..., :-2, :])
    return ix, iy, i2w - i1


def _median3(x):
    """3x3 median over (..., H, W), edge-padded: the median of the nine
    shifted views (JAX ops/flow.py _median3 says why the solver filters)."""
    h, w = x.shape[-2:]
    xp = _pad_edge(x, 1, 1, 1, 1)
    stack = torch.stack([xp[..., dy: dy + h, dx: dx + w]
                         for dy in range(3) for dx in range(3)])
    return torch.median(stack, dim=0).values


def _hs_refine(i1, i2, u, v, alpha: float, n_warps: int, n_iters: int,
               data_weight=None):
    """Warp-iterate Horn-Schunck at one pyramid level (incremental flow).

    Each Jacobi step scales the brightness-constancy residual by the
    Charbonnier weight eps/sqrt(r^2 + eps^2) (times data_weight, when the
    forward-backward pass gives one); after each warp's solve the field is
    3x3-median filtered. The JAX module's docstring has the measurements
    behind both. The two flow components run as one (2, B, H, W) tensor
    through the stencil and the update, which halves the launches and
    changes no value.
    """
    a2 = _f32(alpha * alpha)
    eps = _f32(CHARBONNIER_EPS)
    eps_t = _const(eps, i1)
    eps2 = _f32(np.float32(eps) * np.float32(eps))
    uv = torch.stack([u, v])
    for _ in range(n_warps):
        i2w = _warp(i2, uv[0], uv[1])
        ix, iy, it = _gradients(i1, i2w)
        ixy = torch.stack([ix, iy])
        grad2 = ix * ix + iy * iy
        duv = torch.zeros_like(uv)
        for _ in range(n_iters):
            duvb = _conv3x3(duv, _HS_AVG)
            # ix * dub + iy * dvb + it: a sum of two terms is exact in
            # either order, so the reduction over the component axis is it
            r = (ixy * duvb).sum(0) + it
            w = eps_t / torch.sqrt(r * r + eps2)
            if data_weight is not None:
                w = w * data_weight
            t = w * r / (a2 + w * grad2)
            duv = duvb - ixy * t
        uv = _median3(uv + duv)
    return uv[0], uv[1]


def _affine_init(i1, i2, n_iters: int = 8):
    """Global 6-parameter affine pre-alignment, batched Gauss-Newton (JAX
    ops/flow.py _affine_init says why): per step one 6x6 normal system per
    pair, basis [x, y, 1] per component on coordinates centred and scaled
    to [-1, 1]. Returns dense (u, v) at the input resolution."""
    b, h, w = i1.shape
    s = max(h, w) / 2.0
    xn = torch.from_numpy((np.arange(w, dtype=np.float32) - np.float32((w - 1) / 2.0))
                          / np.float32(s))[None, :].to(i1.device)
    yn = torch.from_numpy((np.arange(h, dtype=np.float32) - np.float32((h - 1) / 2.0))
                          / np.float32(s))[:, None].to(i1.device)
    eye6 = torch.eye(6, dtype=i1.dtype, device=i1.device)
    six = _const(6.0, i1)
    u = torch.zeros_like(i1)
    v = torch.zeros_like(i1)
    for _ in range(n_iters):
        i2w = _warp(i2, u, v)
        ix, iy, it = _gradients(i1, i2w)
        j = torch.stack([ix * xn, ix * yn, ix, iy * xn, iy * yn, iy],
                        dim=-1).reshape(b, -1, 6)
        jt = j.transpose(1, 2)
        with precision_scope("highest"):
            a = torch.bmm(jt, j)
            g = -torch.bmm(jt, it.reshape(b, -1, 1))
        ridge = _f32(1e-6) * torch.diagonal(a, dim1=1, dim2=2).sum(-1) / six + _f32(1e-12)
        dp = torch.linalg.solve_ex(a + ridge[:, None, None] * eye6, g).result[..., 0]
        u = u + (dp[:, 0, None, None] * xn + dp[:, 1, None, None] * yn
                 + dp[:, 2, None, None])
        v = v + (dp[:, 3, None, None] * xn + dp[:, 4, None, None] * yn
                 + dp[:, 5, None, None])
    return u, v


def _occlusion_weight(u_f, v_f, u_b, v_b):
    """Soft forward-backward consistency weight in [0, 1] per pixel: the
    Sundaram/Brox gate |F_f + F_b o F_f|^2 > 0.01(|F_f|^2 + |F_b o F_f|^2)
    + 0.5, applied as a smooth falloff (JAX ops/flow.py _occlusion_weight)."""
    ub_w = _warp(u_b, u_f, v_f)
    vb_w = _warp(v_b, u_f, v_f)
    diff2 = (u_f + ub_w) ** 2 + (v_f + vb_w) ** 2
    mag2 = u_f * u_f + v_f * v_f + ub_w * ub_w + vb_w * vb_w
    thresh = _f32(0.01) * mag2 + 0.5
    falloff = torch.exp(-(diff2 - thresh) / (thresh + _f32(1e-6)))
    return torch.where(diff2 <= thresh, torch.ones_like(diff2), falloff)


def _upsample_flow(u, v, shape):
    """Bilinear (half-pixel centres) resize of (B, h, w) flow to `shape`,
    each component scaled by its axis' size ratio: jax.image.resize's
    "bilinear", which when upsampling equals align_corners=False
    interpolation (JAX renormalises the kernel at the edges, torch clamps
    the source coordinate: the same value)."""
    scale_y = shape[0] / u.shape[1]
    scale_x = shape[1] / u.shape[2]
    uv = F.interpolate(torch.stack([u, v], 1), size=tuple(shape), mode="bilinear",
                       align_corners=False)
    return uv[:, 0] * _f32(scale_x), uv[:, 1] * _f32(scale_y)


def _n_levels(h: int, w: int, min_size: int = 24) -> int:
    n = 1
    while min(h, w) // (2 ** n) >= min_size:
        n += 1
    return n


def flow_pairs(i1, i2, alpha: float = 0.05, n_warps: int = 3,
               n_iters: int = 60, n_levels: int | None = None,
               affine_init: bool = True, fb_occlusion: bool = False):
    """Dense flow for a batch of gray frame pairs.

    i1, i2: (B, H, W) float32 tensors in [0, 1]. Returns (B, H, W, 2) with
    [..., 0] = x-displacement, [..., 1] = y-displacement (the Farneback /
    FlowReader convention, etl/flow.py). `affine_init` seeds the coarsest
    level with a global affine fit (_affine_init). i2's global mean and
    std are matched to i1's per pair first (photometric normalisation).

    fb_occlusion: also solve the BACKWARD flow, stacked into the same batch
    (one pyramid pass at 2B), derive a forward-backward consistency weight
    (_occlusion_weight) and re-refine the finest level with occluded
    pixels' data term gated off. About twice the device work.
    """
    m1 = i1.mean(dim=(1, 2), keepdim=True)
    m2 = i2.mean(dim=(1, 2), keepdim=True)
    s1 = i1.std(dim=(1, 2), keepdim=True, correction=0)
    s2 = i2.std(dim=(1, 2), keepdim=True, correction=0)
    i2 = (i2 - m2) * (s1 / s2.clamp_min(_f32(1e-6))) + m1

    if fb_occlusion:
        b = i1.shape[0]
        flow_both = flow_pairs(torch.cat([i1, i2]), torch.cat([i2, i1]),
                               alpha, n_warps, n_iters, n_levels,
                               affine_init, fb_occlusion=False)
        u_f, v_f = flow_both[:b, ..., 0], flow_both[:b, ..., 1]
        u_b, v_b = flow_both[b:, ..., 0], flow_both[b:, ..., 1]
        weight = _occlusion_weight(u_f, v_f, u_b, v_b)
        u, v = _hs_refine(i1, i2, u_f, v_f, alpha, n_warps=2,
                          n_iters=max(n_iters // 2, 16), data_weight=weight)
        return torch.stack([u, v], dim=-1)

    h, w = i1.shape[1], i1.shape[2]
    levels = _n_levels(h, w) if n_levels is None else n_levels
    pyr1, pyr2 = [i1], [i2]
    for _ in range(levels - 1):
        pyr1.append(_downsample(pyr1[-1]))
        pyr2.append(_downsample(pyr2[-1]))
    if affine_init:
        u, v = _affine_init(pyr1[-1], pyr2[-1])
    else:
        u = torch.zeros_like(pyr1[-1])
        v = torch.zeros_like(pyr1[-1])
    for lvl in range(levels - 1, -1, -1):
        if lvl != levels - 1:
            u, v = _upsample_flow(u, v, pyr1[lvl].shape[1:])
        # full iteration budget at the coarsest level, halved per finer
        # level with a floor of 16 (the JAX module's schedule)
        level_iters = max(n_iters // (2 ** (levels - 1 - lvl)), 16)
        u, v = _hs_refine(pyr1[lvl], pyr2[lvl], u, v, alpha, n_warps,
                          level_iters)
    return torch.stack([u, v], dim=-1)


def horn_schunck_flow(frames: np.ndarray, alpha: float = 0.05,
                      n_warps: int = 3, n_iters: int = 60,
                      pair_batch: int = 16,
                      affine_init: bool = True,
                      fb_occlusion: bool = False,
                      device: str = "cuda") -> np.ndarray:
    """(T, H, W, 3) uint8/float frames -> (T, H, W, 2) float32 flow (the
    last frame repeats the flow before it; T < 2 gives zeros).

    Drop-in twin of etl.flow.farneback_flow with the compute on the torch
    `device` (the card unless the caller passes "cpu"). Gray is
    0.299 R + 0.587 G + 0.114 B, divided by 255 for uint8 frames or any
    value above 2. Pairs are solved in batches of `pair_batch`, the tail
    batch zero-padded, so every batch has one shape; a pair's flow does not
    depend on the batch it is solved in.
    """
    t, h, w = frames.shape[:3]
    if t < 2:
        return np.zeros(frames.shape[:3] + (2,), np.float32)
    gray = (np.asarray(frames, np.float32)
            @ np.array([0.299, 0.587, 0.114], np.float32))
    if frames.dtype == np.uint8 or gray.max() > 2.0:
        gray = gray / 255.0
    out = np.zeros((t, h, w, 2), np.float32)
    with torch.inference_mode():
        for start in range(0, t - 1, pair_batch):
            stop = min(start + pair_batch, t - 1)
            n = stop - start
            i1 = np.zeros((pair_batch, h, w), np.float32)
            i2 = np.zeros((pair_batch, h, w), np.float32)
            i1[:n] = gray[start:stop]
            i2[:n] = gray[start + 1: stop + 1]
            flow = flow_pairs(torch.from_numpy(i1).to(device), torch.from_numpy(i2).to(device),
                              alpha, n_warps, n_iters, affine_init=affine_init,
                              fb_occlusion=fb_occlusion)
            out[start:stop] = flow[:n].cpu().numpy()
    out[-1] = out[-2]
    return out
