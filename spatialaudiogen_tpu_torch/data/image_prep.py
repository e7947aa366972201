"""ImageNet-style image preprocessing on the host, in numpy (port of
spatialaudiogen_tpu.data.image_prep; reference
pyutils/tflib/models/image/preprocessing.py and the ResNet normalisation
chain, resnet.py:111-121).

The JAX module resizes with OpenCV, which the card's host does not have.
`_resize` is OpenCV's INTER_LINEAR in numpy: half-pixel centres, edges
clamped, and for uint8 images its fixed-point arithmetic (11-bit weights
per axis, rounded sums), so results stay within one LSB of cv2.resize
(tests/test_torch_generic_lib.py states the share of pixels that differ).
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN_BGR_CENTERED = np.array([-117.0, -117.0, -117.0], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_COEF_BITS = 11                     # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _taps(n_out: int, n_in: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first source index, second source index, weight of the second) per
    output index, as OpenCV computes them in float32: f = (d + 0.5) *
    n_in / n_out - 0.5, clamped to the edges."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0.astype(np.float32)
    low, high = i0 < 0, i0 >= n_in - 1
    frac[low | high] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def _fixed(frac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Both weights of each tap pair rounded to 11-bit fixed point
    (saturate_cast<short>: to nearest, ties to even)."""
    w0 = np.rint((np.float32(1.0) - frac) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(frac * np.float32(_COEF_SCALE)).astype(np.int64)
    return w0, w1


def _resize(img: np.ndarray, hw) -> np.ndarray:
    """Bilinear resize of (H, W[, C]) to hw = (out_h, out_w), OpenCV's
    INTER_LINEAR: a horizontal then a vertical two-tap pass."""
    out_h, out_w = hw
    y0, y1, fy = _taps(out_h, img.shape[0])
    x0, x1, fx = _taps(out_w, img.shape[1])
    along_x = (slice(None),) + (None,) * (img.ndim - 2)     # (out_w[, 1])
    along_y = (slice(None),) + (None,) * (img.ndim - 1)     # (out_h, 1[, 1])
    if img.dtype == np.uint8:
        a0, a1 = _fixed(fx)
        b0, b1 = _fixed(fy)
        src = img.astype(np.int64)
        rows = src[:, x0] * a0[along_x] + src[:, x1] * a1[along_x]   # (H, out_w, ...)
        # the vertical pass of OpenCV's vector route: 16-bit high products of
        # the row sums >> 4, then a rounding shift by 2
        top = ((rows[y0] >> 4) * b0[along_y]) >> 16
        bottom = ((rows[y1] >> 4) * b1[along_y]) >> 16
        return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    fx, fy = fx[along_x], fy[along_y]
    rows = src[:, x0] * (1 - fx) + src[:, x1] * fx
    return (rows[y0] * (1 - fy) + rows[y1] * fy).astype(img.dtype)


def eval_image(img: np.ndarray, out_h: int, out_w: int,
               central_fraction: float = 0.875) -> np.ndarray:
    """Central crop by `central_fraction`, then resize (preprocessing.py eval)."""
    h, w = img.shape[:2]
    ch, cw = int(h * central_fraction), int(w * central_fraction)
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    return _resize(img[y0:y0 + ch, x0:x0 + cw], (out_h, out_w))


def distort_image(img: np.ndarray, out_h: int, out_w: int,
                  rng: np.random.RandomState | None = None,
                  min_area: float = 0.5) -> np.ndarray:
    """Random area/aspect crop + horizontal flip (training distortion); the
    same draws from `rng` as the JAX function makes."""
    rng = rng or np.random.RandomState()
    h, w = img.shape[:2]
    for _ in range(10):
        area = rng.uniform(min_area, 1.0) * h * w
        aspect = rng.uniform(3 / 4, 4 / 3)
        ch = int(round(np.sqrt(area / aspect)))
        cw = int(round(np.sqrt(area * aspect)))
        if ch <= h and cw <= w:
            y0 = rng.randint(0, h - ch + 1)
            x0 = rng.randint(0, w - cw + 1)
            img = img[y0:y0 + ch, x0:x0 + cw]
            break
    out = _resize(img, (out_h, out_w))
    if rng.rand() < 0.5:
        out = out[:, ::-1]
    return out


def imagenet_normalize(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> standard ImageNet-normalized float (resnet.py:117-121)."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def model_normalize(img: np.ndarray) -> np.ndarray:
    """The training-path normalization (myutils.py:88-89): x/255 - 0.5."""
    return img.astype(np.float32) / 255.0 - 0.5
