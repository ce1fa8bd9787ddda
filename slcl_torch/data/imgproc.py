"""The image operations of the augmentation pipelines, with cv2's semantics.

The port runs on hosts without OpenCV, so each cv2 call of
``slcl_tpu/data/transforms.py`` has a numpy counterpart here, held against
cv2 by ``tests/test_torch_imgproc.py``. Images are single-channel (h, w)
arrays; sizes are given as cv2 gives them, ``(width, height)``.

Sampling follows cv2 (5.x) to the bit where it matters:
- a warp maps each output pixel (x, y) back through the inverted transform,
  with cv2's float32 arithmetic (the column term fused into the row term),
  so nearest-neighbour lookups pick the pixel cv2 picks;
- nearest rounds half to even (cv2's ``cvRound``); linear interpolation is
  plain float bilinear, and each of its four taps that falls outside the
  image takes the border value, not the edge pixel;
- filters pad by ``BORDER_REFLECT_101`` (numpy's ``reflect``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_F32, _F64 = np.float32, np.float64


# ---------------------------------------------------------------------------
# Borders and flips
# ---------------------------------------------------------------------------
def copy_make_border(img: np.ndarray, top: int, bottom: int, left: int, right: int,
                     value: float) -> np.ndarray:
    """``cv2.copyMakeBorder(..., cv2.BORDER_CONSTANT, value=value)``."""
    return np.pad(img, ((top, bottom), (left, right)), constant_values=value)


def flip(img: np.ndarray, code: int) -> np.ndarray:
    """``cv2.flip``: 0 flips rows, 1 flips columns, -1 both."""
    axes = {0: (0,), 1: (1,), -1: (0, 1)}[code]
    return np.ascontiguousarray(np.flip(img, axes))


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------
def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, ``angle`` in degrees,
    counter-clockwise about ``center`` = (x, y)."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` (float64; a singular M gives zeros)."""
    M = np.asarray(M, _F64)
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * d, M[0, 0] * d, -M[0, 1] * d, -M[1, 0] * d
    return np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                     [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]])


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform`` of four point pairs: (3, 3) float64
    with P[2, 2] = 1."""
    a, b = np.zeros((8, 8)), np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(np.asarray(src, _F64),
                                             np.asarray(dst, _F64))):
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _fused_rows(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """float32 ``m[0] * x + (m[1] * y + m[2])`` over the (h, w) grid, the
    outer multiply-add rounded once (exact in float64 for float32 operands)."""
    m = m.astype(_F32)
    row = m[1] * np.arange(h, dtype=_F32) + m[2]
    col = m[0].astype(_F64) * np.arange(w, dtype=_F64)
    return (row.astype(_F64)[:, None] + col[None, :]).astype(_F32)


def affine_map(M: np.ndarray, dsize: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Source coordinates (map_x, map_y), float32 (h, w), of ``warp_affine``
    by the forward transform M (2, 3) into an output of ``dsize``."""
    w, h = dsize
    inv = invert_affine(M)
    return _fused_rows(inv[0], h, w), _fused_rows(inv[1], h, w)


def perspective_map(P: np.ndarray, dsize: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Source coordinates of ``warp_perspective`` by the forward P (3, 3)."""
    w, h = dsize
    inv = np.linalg.inv(np.asarray(P, _F64))
    den = _fused_rows(inv[2], h, w)
    return _fused_rows(inv[0], h, w) / den, _fused_rows(inv[1], h, w) / den


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------
def remap(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          interpolation: str, border_value: float = 0.0) -> np.ndarray:
    """``cv2.remap`` with float32 maps and ``BORDER_CONSTANT``.

    ``interpolation`` is ``'nearest'`` (any dtype; rounds half to even) or
    ``'linear'`` (float32 images). A tap outside the image reads
    ``border_value``."""
    h, w = src.shape
    # a ring of two border pixels: a tap's coordinates are clamped into it,
    # so the pair of taps of an outside coordinate both read the border
    pad = np.full((h + 4, w + 4), border_value, src.dtype)
    pad[2:-2, 2:-2] = src
    flat = pad.ravel()
    stride = w + 4

    def index(x, y):
        return ((np.clip(y, -2, h).astype(np.int32) + 2) * stride
                + np.clip(x, -2, w).astype(np.int32) + 2)

    if interpolation == "nearest":
        return flat.take(index(np.rint(map_x), np.rint(map_y)))
    if interpolation != "linear":
        raise ValueError(f"interpolation {interpolation!r}: 'nearest' or 'linear'")
    if src.dtype != _F32:
        raise TypeError(f"linear remap takes float32 images, got {src.dtype}")
    x0, y0 = np.floor(map_x), np.floor(map_y)
    fx, fy = map_x - x0, map_y - y0
    i = index(x0, y0)
    gx = 1 - fx
    top = flat.take(i) * gx + flat.take(i + 1) * fx
    i += stride
    bottom = flat.take(i) * gx + flat.take(i + 1) * fx
    return top * (1 - fy) + bottom * fy


def warp_affine(src: np.ndarray, M: np.ndarray, dsize: Tuple[int, int],
                interpolation: str, border_value: float = 0.0) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=..., borderMode=BORDER_CONSTANT)``."""
    return remap(src, *affine_map(M, dsize), interpolation, border_value)


def warp_perspective(src: np.ndarray, P: np.ndarray, dsize: Tuple[int, int],
                     interpolation: str, border_value: float = 0.0) -> np.ndarray:
    """``cv2.warpPerspective(..., borderMode=BORDER_CONSTANT)``."""
    return remap(src, *perspective_map(P, dsize), interpolation, border_value)


# ---------------------------------------------------------------------------
# Resize and filters
# ---------------------------------------------------------------------------
def _cubic_taps(n_out: int, n_in: int):
    """cv2's bicubic (A = -0.75, half-pixel centres, edge indices
    replicated) along one axis: (n_out, 4) float32 weights, as cv2 computes
    them in float, and their (n_out, 4) source indices."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f)
    t = f - s
    A = _F32(-0.75)
    c0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    c1 = ((A + 2) * t - (A + 3)) * t * t + 1
    c2 = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    coeffs = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], 1)
    return coeffs, np.clip(s.astype(np.intp)[:, None] + np.arange(-1, 3), 0, n_in - 1)


def resize_cubic(src: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=cv2.INTER_CUBIC)``, float32:
    rows first, then columns, four taps summed in order."""
    w, h = dsize
    src = np.asarray(src, _F32)
    cx, ix = _cubic_taps(w, src.shape[1])
    cy, iy = _cubic_taps(h, src.shape[0])
    taps = src[:, ix]
    rows = taps[..., 0] * cx[:, 0] + taps[..., 1] * cx[:, 1] + \
        taps[..., 2] * cx[:, 2] + taps[..., 3] * cx[:, 3]
    taps = rows[iy]
    return cy[:, 0, None] * taps[:, 0] + cy[:, 1, None] * taps[:, 1] + \
        cy[:, 2, None] * taps[:, 2] + cy[:, 3, None] * taps[:, 3]


def _reflect101(src: np.ndarray, ry: int, rx: int) -> np.ndarray:
    return np.pad(src, ((ry, ry), (rx, rx)), mode="reflect")


def _sep_filter(src: np.ndarray, kx: Sequence[float], ky: Sequence[float]) -> np.ndarray:
    """Correlate rows with ``kx``, then columns with ``ky`` (odd lengths,
    centred anchors), in float32."""
    h, w = src.shape
    rx, ry = len(kx) // 2, len(ky) // 2
    pad = _reflect101(np.asarray(src, _F32), ry, rx)
    rows = sum(_F32(k) * pad[:, i:i + w] for i, k in enumerate(kx))
    return sum(_F32(k) * rows[i:i + h] for i, k in enumerate(ky))


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F)`` for sigma > 0."""
    x = np.arange(ksize) - (ksize - 1) * 0.5
    cf = np.exp(-0.5 / (sigma * sigma) * x * x).astype(_F32)
    return (cf * (1.0 / cf.astype(_F64).sum())).astype(_F32)


def gaussian_blur(src: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(src, (ksize, ksize), sigma)`` (sigma > 0)."""
    k = gaussian_kernel(ksize, sigma)
    return _sep_filter(src, k, k)


def filter2d(src: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(src, -1, kernel)``: correlation, centred anchor."""
    kh, kw = kernel.shape
    h, w = src.shape
    pad = _reflect101(np.asarray(src, _F32), kh // 2, kw // 2)
    return sum(_F32(kernel[i, j]) * pad[i:i + h, j:j + w]
               for i in range(kh) for j in range(kw))


def sobel(src: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """``cv2.Sobel(src, cv2.CV_32F, dx, dy)`` with the 3x3 aperture, for
    (dx, dy) = (1, 0) or (0, 1)."""
    diff, smooth = (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0)
    if (dx, dy) == (1, 0):
        return _sep_filter(src, diff, smooth)
    if (dx, dy) == (0, 1):
        return _sep_filter(src, smooth, diff)
    raise ValueError(f"sobel: (dx, dy) = ({dx}, {dy}); (1, 0) or (0, 1)")


# ---------------------------------------------------------------------------
# Resizes of the legacy datasets, the serve CLI and the offline tools
# ---------------------------------------------------------------------------
_COEF_BITS = 11             # cv2's INTER_RESIZE_COEF_BITS


def _resize_scales(shape: Tuple[int, int], dsize, fx, fy):
    """cv2.resize's output size and its source steps: with ``dsize`` the
    inverse scale is dst/src, else ``fx``/``fy`` themselves and the size
    their product with the source's, rounded half to even; the step is
    1 / inverse scale either way."""
    h, w = shape
    if dsize is None:
        inv_x, inv_y = float(fx), float(fy)
        dsize = (int(np.rint(w * inv_x)), int(np.rint(h * inv_y)))
    else:
        inv_x, inv_y = dsize[0] / w, dsize[1] / h
    return dsize, 1.0 / inv_x, 1.0 / inv_y


def _linear_coords(n_out: int, n_in: int, scale: float, clamp_weight: bool):
    """Source indices (i0, i1) and float32 weights of the second tap along
    one axis: cv2's ``(d + 0.5) * scale - 0.5`` split into floor and
    fraction in double, the fraction rounded to float. Along x a coordinate left of the first
    pixel or right of the last reads that pixel alone (``clamp_weight``);
    along y the two rows are clamped into the image, the weight kept."""
    f = (np.arange(n_out) + 0.5) * scale - 0.5
    s = np.floor(f)
    f = (f - s).astype(_F32)
    s = s.astype(np.intp)
    if clamp_weight:
        edge = (s < 0) | (s >= n_in - 1)
        f[edge] = 0
        s = np.clip(s, 0, n_in - 1)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), f


def _area_half(src: np.ndarray) -> np.ndarray:
    """cv2's fast INTER_AREA of an exact halving, which ``INTER_LINEAR``
    takes for it: the mean of each 2x2 block (uint8: rounded, ``+2 >> 2``)."""
    h, w = src.shape
    b = src[:h // 2 * 2, :w // 2 * 2]
    if src.dtype == np.uint8:
        s = b.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2)
                >> 2).astype(np.uint8)
    return (b[0::2, 0::2] + b[0::2, 1::2] + b[1::2, 0::2] + b[1::2, 1::2]) * _F32(0.25)


def resize_linear(src: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
                  fx: Optional[float] = None, fy: Optional[float] = None) -> np.ndarray:
    """``cv2.resize(src, dsize, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)``
    for uint8 or float32 images: rows resampled first, then columns.

    uint8 follows cv2's fixed-point path: weights rounded to 11 bits, the
    row pass in int32, the column pass ``((b0 * (s0 >> 4)) >> 16) +
    ((b1 * (s1 >> 4)) >> 16) + 2 >> 2``. float32 sums its two taps in
    float. A halving in both axes is a 2x2 mean, as in cv2."""
    dsize, sx, sy = _resize_scales(src.shape, dsize, fx, fy)
    w, h = dsize
    if src.dtype not in (np.uint8, _F32):
        raise TypeError(f"resize_linear takes uint8 or float32 images, got {src.dtype}")
    if abs(sx - 2) < np.finfo(_F64).eps and abs(sy - 2) < np.finfo(_F64).eps:
        return _area_half(src)
    x0, x1, ax = _linear_coords(w, src.shape[1], sx, True)
    y0, y1, ay = _linear_coords(h, src.shape[0], sy, False)
    if src.dtype == _F32:
        rows = src[:, x0] * (_F32(1) - ax) + src[:, x1] * ax
        by = ay[:, None]
        return rows[y0] * (_F32(1) - by) + rows[y1] * by
    one = 1 << _COEF_BITS
    a1 = np.rint(ax * _F32(one)).astype(np.int32)
    a0 = np.rint((_F32(1) - ax) * _F32(one)).astype(np.int32)
    s = src.astype(np.int32)
    rows = s[:, x0] * a0 + s[:, x1] * a1
    b1 = np.rint(ay * _F32(one)).astype(np.int32)[:, None]
    b0 = np.rint((_F32(1) - ay) * _F32(one)).astype(np.int32)[:, None]
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_nearest(src: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=cv2.INTER_NEAREST)``: output
    pixel d reads source ``floor(d * step)`` (step = 1 / (dst / src)), the
    last pixel at most — a floor, not the warps' half-to-even rounding."""
    w, h = dsize
    sh, sw = src.shape

    def index(n_out, n_in):
        return np.minimum(np.floor(np.arange(n_out) * (1.0 / (n_out / n_in))).astype(np.intp),
                          n_in - 1)
    return src[index(h, sh)[:, None], index(w, sw)[None, :]]


# ---------------------------------------------------------------------------
# Filters of the LGE pipeline and CLAHE
# ---------------------------------------------------------------------------
def median_blur(src: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.medianBlur(src, ksize)`` on float32, which cv2 takes for k 3
    and 5 only: the median of each k x k window, the border replicated."""
    if ksize not in (3, 5):
        raise ValueError(f"median_blur: ksize {ksize}; cv2 takes 3 or 5 on float32")
    h, w = src.shape
    r = ksize // 2
    pad = np.pad(np.asarray(src, _F32), r, mode="edge")
    win = np.stack([pad[i:i + h, j:j + w] for i in range(ksize) for j in range(ksize)])
    return np.median(win, axis=0).astype(_F32)


def box_blur(src: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.blur(src, (ksize, ksize))`` on float32: the window mean, its
    anchor at ksize // 2 (so an even k reaches one pixel further up and
    left), the border reflect-101; sums in float64 as cv2's are."""
    h, w = src.shape
    a = ksize // 2
    pad = np.pad(np.asarray(src, _F64), ((a, ksize - 1 - a), (a, ksize - 1 - a)),
                 mode="reflect")
    rows = sum(pad[:, j:j + w] for j in range(ksize))
    total = sum(rows[i:i + h] for i in range(ksize))
    return (total * (1.0 / (ksize * ksize))).astype(_F32)


def clahe(src: np.ndarray, clip_limit: float = 2.0, tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, tiles).apply(src)`` on uint8.

    As cv2 does it: an image whose sides are not both multiples of the tile
    counts is padded reflect-101 on the bottom and right by ``tiles -
    side % tiles`` (a whole tile where a side already divides); each tile's
    256-bin histogram is clipped at ``max(int(clip * area / 256), 1)``, the
    clipped count spread evenly with its remainder one by one at a stride
    of ``256 // remainder``; its LUT is the running sum times ``255 /
    area`` in float32, rounded half to even; each pixel blends the LUTs of
    its four nearest tile centres bilinearly in float32."""
    if src.dtype != np.uint8:
        raise TypeError(f"clahe takes uint8 images, got {src.dtype}")
    tx, ty = tiles
    h, w = src.shape
    ext = src
    if w % tx or h % ty:
        ext = np.pad(src, ((0, ty - h % ty), (0, tx - w % tx)), mode="reflect")
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    scale = _F32(255.0 / area)
    tile_px = ext[:th * ty, :tw * tx].reshape(ty, th, tx, tw).transpose(0, 2, 1, 3)
    lut = np.empty((ty, tx, 256), np.uint8)
    for i in range(ty):
        for j in range(tx):
            hist = np.bincount(tile_px[i, j].ravel(), minlength=256).astype(np.int64)
            if limit > 0:
                clipped = int(np.maximum(hist - limit, 0).sum())
                hist = np.minimum(hist, limit) + clipped // 256
                residual = clipped % 256
                if residual:
                    step = max(256 // residual, 1)
                    hist[np.arange(0, 256, step)[:residual]] += 1
            lut[i, j] = np.clip(np.rint(np.cumsum(hist).astype(_F32) * scale), 0, 255)

    def axis(n, t, count):
        f = np.arange(n).astype(_F32) * (_F32(1) / _F32(t)) - _F32(0.5)
        i1 = np.floor(f)
        a = (f - i1).astype(_F32)
        i1 = i1.astype(np.intp)
        return np.maximum(i1, 0), np.minimum(i1 + 1, count - 1), a, (_F32(1) - a).astype(_F32)

    y1, y2, ya, ya1 = axis(h, th, ty)
    x1, x2, xa, xa1 = axis(w, tw, tx)
    v = src.astype(np.intp)
    rows1, rows2 = y1[:, None], y2[:, None]
    cols1, cols2 = x1[None, :], x2[None, :]
    l11, l12 = lut[rows1, cols1, v].astype(_F32), lut[rows1, cols2, v].astype(_F32)
    l21, l22 = lut[rows2, cols1, v].astype(_F32), lut[rows2, cols2, v].astype(_F32)
    res = ((l11 * xa1 + l12 * xa) * ya1[:, None] + (l21 * xa1 + l22 * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
