"""Image transforms: decode, normalize, crop, remap, augment.

A copy of ``slcl_tpu/data/transforms.py`` on the port's own image
operations (``imgproc``, numpy; no OpenCV) and its own SLIC library
(``slic``). Every random draw is the JAX module's, in the same order and
count, so one ``(seed, epoch, index)`` gives both packages the same sample
(``tests/test_torch_data.py``). Host-side: these run in loader threads, off
the device's critical path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import imgproc as ip
from . import slic
from .nifti import read_nii


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Deterministic per-sample augmentation RNG from (run seed, epoch, index):
    two runs with the same config seed produce identical batches (the Loader
    pushes the epoch via ``dataset.set_epoch``)."""
    return np.random.default_rng([abs(int(seed)), 0x5EED, int(epoch), int(index)])


def load_raw_data_mmwhs(img_path, mask_path=None):
    """Decode one MMWHS raw slice pair.

    Parity: reference utils/utils_.py:1002-1020 — read the per-slice NIfTI,
    take channel 0, crop rows 8:-8, pad 2 rows top/bottom with the image min
    (mask padded with 0), remap labels {205->1, 500->2, 600->3}.
    """
    img, _ = read_nii(img_path)
    # a per-slice file holds one channel on its last axis (read_nii's
    # SimpleITK order): axis 0 kept, axis 1 cropped, the channel taken
    img = np.pad(img[:, 8:-8, 0], ((2, 2), (0, 0)), constant_values=img.min())
    mask = None
    if mask_path is not None:
        m, _ = read_nii(mask_path)
        m = np.pad(m[:, 8:-8, 0], ((2, 2), (0, 0)))
        mask = ((m == 205) * 1 + (m == 500) * 2 + (m == 600) * 3).astype(np.uint8)
    return img, mask


def normalize_minmax(img: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """Clip-to-[0,1] window normalization (data_generator_mmwhs_raw.py:122-141)."""
    return np.clip((img.astype(np.float32) - vmin) / (vmax - vmin + 1e-7), 0, 1)


def normalize_percentile(img: np.ndarray, percent: float = 99.0) -> np.ndarray:
    """Percentile-window fallback when no per-patient CSV exists."""
    lower = 1.0 if percent == 99 else (0.0 if percent == 100 else float(percent))
    upper = 99.0 if percent == 99 else (100.0 if percent == 100 else float(percent))
    vmin, vmax = np.percentile(img, lower), np.percentile(img, upper)
    return normalize_minmax(img, vmin, vmax)


def normalize_zscore(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) - img.mean()) / (img.std() + 1e-7)


def crop_resize(image: np.ndarray, target_size: Tuple[int, int] = (224, 224),
                is_mask: bool = False, pad_value: float = 0) -> np.ndarray:
    """Centre pad-then-crop to target size (ImageProcessor.crop_resize,
    data_generator_mscmrseg.py:241-285). H, W arrays."""
    pad_value = 0 if is_mask else pad_value
    h, w = image.shape[:2]
    th, tw = target_size
    if h < th or w < tw:
        dh, dw = max(0, th - h), max(0, tw - w)
        image = ip.copy_make_border(image, dh // 2, dh - dh // 2,
                                    dw // 2, dw - dw // 2, float(pad_value))
        h, w = image.shape[:2]
    x1 = max(0, int(round((w - tw) / 2.0)))
    y1 = max(0, int(round((h - th) / 2.0)))
    out = image[y1:y1 + th, x1:x1 + tw]
    # the JAX copy resizes when the crop comes out short; after the pad
    # h >= th and w >= tw, so the crop is always (th, tw)
    assert out.shape[:2] == (th, tw), (out.shape, target_size)
    return out


def remap_mask(mask: np.ndarray, mapping: dict) -> np.ndarray:
    out = np.zeros_like(mask, dtype=np.uint8)
    for raw, cls in mapping.items():
        out[mask == raw] = cls
    return out


def to_categorical(mask: np.ndarray, num_classes: int = 4) -> np.ndarray:
    """One-hot (H, W) -> (H, W, C) (data_generator_mscmrseg.py:22-45)."""
    return np.eye(num_classes, dtype=np.float32)[mask.astype(np.int64)]


def _warp_pair(image: np.ndarray, mask: Optional[np.ndarray], maps, border: float):
    """Sample ``image`` (float32, linear, ``border`` outside) and ``mask``
    (nearest, 0 outside) on one grid. A nearest lookup copies values, so the
    mask keeps its dtype where the JAX copy warps some masks as float32 and
    casts them back: the same labels."""
    img = ip.remap(np.asarray(image, np.float32), *maps, "linear", border)
    return img, None if mask is None else ip.remap(mask, *maps, "nearest", 0)


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------
def simple_aug(image: np.ndarray, mask: Optional[np.ndarray],
               rng: Optional[np.random.Generator] = None,
               ang=(-15, 15), translate=(-0.1, 0.1), scale=(0.9, 1.1)):
    """Affine + hflip augmentation (ImageProcessor.simple_aug,
    data_generator_mscmrseg.py:96-150): rotate U(-15, 15) deg, translate
    U(-10%, 10%), scale U(0.9, 1.1), 50% horizontal flip; linear interp for
    the image (border = image min), nearest for the mask (border = 0)."""
    rng = rng or np.random.default_rng()
    rows, cols = image.shape[:2]
    a = rng.integers(ang[0], ang[1]) if ang[0] != ang[1] else ang[0]
    tx = rng.uniform(*translate) * cols
    ty = rng.uniform(*translate) * rows
    s = rng.uniform(*scale)
    M = ip.get_rotation_matrix_2d((cols / 2, rows / 2), float(a), float(s))
    M[0, 2] += tx
    M[1, 2] += ty
    border = float(image.min()) if image.size else 0.0
    img, msk = _warp_pair(image, mask, ip.affine_map(M, (cols, rows)), border)
    if rng.random() < 0.5:
        img = ip.flip(img, 1)
        if msk is not None:
            msk = ip.flip(msk, 1)
    return img, msk


def heavy_aug(image: np.ndarray, mask: Optional[np.ndarray],
              rng: Optional[np.random.Generator] = None, vmax: float = 1.0):
    """Heavy augmentation — native equivalents of the reference's imgaug
    pipeline (data_generator_mscmrseg.py:152-238: flips, rot90, affine, blur,
    additive noise, dropout, contrast); each op is applied with prob 0.5 like
    ``iaa.Sometimes(0.5, ...)``."""
    rng = rng or np.random.default_rng()
    img, msk = image.astype(np.float32), mask
    if rng.random() < 0.5:
        img = ip.flip(img, 1)
        msk = ip.flip(msk, 1) if msk is not None else None
    if rng.random() < 0.5:
        img = ip.flip(img, 0)
        msk = ip.flip(msk, 0) if msk is not None else None
    if rng.random() < 0.5:
        k = int(rng.integers(0, 4))
        img = np.rot90(img, k).copy()
        msk = np.rot90(msk, k).copy() if msk is not None else None
    img, msk = simple_aug(img, msk, rng, scale=(0.8, 1.2))
    if rng.random() < 0.5:  # gaussian blur
        sigma = rng.uniform(0.0, 1.0)
        if sigma > 0.05:
            img = ip.gaussian_blur(img, 5, sigma)
    if rng.random() < 0.5:  # additive gaussian noise
        img = img + rng.normal(0, 0.03 * vmax, img.shape).astype(np.float32)
    if rng.random() < 0.5:  # coarse dropout
        frac = rng.uniform(0.0, 0.05)
        n = int(frac * img.size / 64)
        for _ in range(n):
            y = int(rng.integers(0, max(1, img.shape[0] - 8)))
            x = int(rng.integers(0, max(1, img.shape[1] - 8)))
            img[y:y + 8, x:x + 8] = 0
    if rng.random() < 0.5:  # linear contrast
        img = img * rng.uniform(0.8, 1.2)
    return img, msk


# ---------------------------------------------------------------------------
# heavy_aug2: native equivalents of the reference's extended imgaug pipeline
# (data_generator_mscmrseg.py:152-238 '2' branch), applied with the
# reference's Sometimes(0.5)/SomeOf structure. Geometric ops transform the
# mask with nearest-neighbour; photometric ops leave it.
# ---------------------------------------------------------------------------
def _slic_assign_numpy(gray: np.ndarray, g: int, iters: int) -> np.ndarray:
    """Vectorized numpy SLIC-lite: grid-seeded (y, x, intensity) k-means,
    global argmin per iteration, bincount Lloyd updates. The plain version
    of the C++ SLIC (``slic.assign``), reached only by ``superpixels(...,
    plain=True)``."""
    h, w = gray.shape
    ys = np.linspace(0, h - 1, g)
    xs = np.linspace(0, w - 1, g)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    cy, cx = cy.ravel(), cx.ravel()
    cv = gray[cy.astype(int), cx.astype(int)].astype(np.float64)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yf, xf, gf = yy.ravel(), xx.ravel(), gray.ravel().astype(np.float32)
    s_sp = max(h, w) / g
    s_in = max(float(gray.max() - gray.min()), 1e-6)
    k = len(cy)
    assign = np.zeros(h * w, np.int64)
    for _ in range(max(iters, 1)):
        d = ((yf[:, None] - cy) ** 2 + (xf[:, None] - cx) ** 2) / s_sp**2 \
            + ((gf[:, None] - cv) ** 2) / (0.3 * s_in) ** 2
        assign = np.argmin(d, axis=-1)
        cnt = np.bincount(assign, minlength=k).astype(np.float64)
        nz = cnt > 0
        cy = np.where(nz, np.bincount(assign, yf, k) / np.maximum(cnt, 1), cy)
        cx = np.where(nz, np.bincount(assign, xf, k) / np.maximum(cnt, 1), cx)
        cv = np.where(nz, np.bincount(assign, gf, k) / np.maximum(cnt, 1), cv)
    return assign.reshape(h, w).astype(np.int32)


def superpixels(image: np.ndarray, rng: np.random.Generator,
                n_segments: int = 64, p_replace: float = 0.5,
                iters: int = 2, plain: bool = False) -> np.ndarray:
    """SLIC superpixel replacement (iaa.Superpixels equivalent): grid-seeded
    (y, x, intensity) k-means, then each segment is replaced by its mean
    intensity with prob ``p_replace``. The assignment and the replacement
    run in the C++ library (proper SLIC with 2S-local search,
    ``slcl_torch/csrc/slic.cpp``, built at first use; a failed build
    raises). ``plain=True`` runs the numpy k-means instead, a different
    segmentation with the same contract, for tests."""
    img = image.astype(np.float32)
    gray = img if img.ndim == 2 else img.mean(-1)
    g = max(int(np.sqrt(n_segments)), 2)
    replace = rng.random(g * g) < p_replace
    if not plain:
        return slic.segment_replace(img, slic.assign(gray, g, iters + 1), replace)
    assign = _slic_assign_numpy(gray, g, iters)
    flat = assign.ravel()
    k = g * g
    cnt = np.maximum(np.bincount(flat, minlength=k), 1).astype(np.float32)
    if img.ndim == 2:
        means = (np.bincount(flat, img.ravel(), k) / cnt).astype(np.float32)
        return np.where(replace[assign], means[assign], img)
    means = np.stack([np.bincount(flat, img[..., c].ravel(), k) / cnt
                      for c in range(img.shape[-1])], -1).astype(np.float32)
    return np.where(replace[assign][..., None], means[assign], img)


def affine_shear_aug(image: np.ndarray, mask: Optional[np.ndarray],
                     rng: np.random.Generator, *,
                     rotate=(-10, 10), shear=(-12, 12),
                     translate_x=(-0.1, 0.05), translate_y=(-0.1, 0.1),
                     scale=(0.8, 1.2)):
    """Full iaa.Affine equivalent with per-axis scale and shear (the legacy
    bSSFP/LGE pipelines use shear, which ``simple_aug`` lacks — reference
    dataset/bSSFP_dataset.py:28-39, LGE_dataset.py:25-35). Linear interp for
    the image (constant border = image min), nearest for the mask."""
    h, w = image.shape[:2]
    ang = np.deg2rad(rng.uniform(*rotate))
    shr = np.deg2rad(rng.uniform(*shear))
    sx, sy = rng.uniform(*scale), rng.uniform(*scale)
    tx, ty = rng.uniform(*translate_x) * w, rng.uniform(*translate_y) * h
    # rotation+shear+scale about the image center, then translate
    ca, sa = np.cos(ang), np.sin(ang)
    A = np.array([[sx * (ca + np.tan(shr) * -sa), sx * -sa],
                  [sy * (sa + np.tan(shr) * ca), sy * ca]], np.float32)
    c = np.array([w / 2.0, h / 2.0], np.float32)
    t = c - A @ c + np.array([tx, ty], np.float32)
    M = np.concatenate([A, t[:, None]], axis=1)
    border = float(image.min()) if image.size else 0.0
    return _warp_pair(image, mask, ip.affine_map(M, (w, h)), border)


def perspective_warp(image: np.ndarray, mask: Optional[np.ndarray],
                     rng: np.random.Generator, scale: float = 0.05):
    """iaa.PerspectiveTransform equivalent (LGE_dataset.py:39): jitter the 4
    corners by |N(0, scale)| of the image size inward and warp to the full
    frame; image linear, mask nearest."""
    h, w = image.shape[:2]
    jit = np.abs(rng.normal(0, scale, (4, 2))).astype(np.float32)
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    inward = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    src = src + inward * jit * np.array([w, h], np.float32)
    dst = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    P = ip.get_perspective_transform(src, dst)
    border = float(image.min()) if image.size else 0.0
    return _warp_pair(image, mask, ip.perspective_map(P, (w, h)), border)


def _displacement_maps(h: int, w: int, dy: np.ndarray, dx: np.ndarray):
    """A coarse displacement grid densified by cubic resize, added to the
    pixel grid: the (map_x, map_y) of ``remap``."""
    dy = ip.resize_cubic(dy, (w, h))
    dx = ip.resize_cubic(dx, (w, h))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return xx + dx, yy + dy


def piecewise_affine(image: np.ndarray, mask: Optional[np.ndarray],
                     rng: np.random.Generator, scale: float = 0.03,
                     grid: int = 4):
    """iaa.PiecewiseAffine equivalent: a (grid x grid) lattice of control
    points jittered by N(0, scale * size), displacement field densified with
    cubic resize, sampled by remap (image linear, mask nearest)."""
    h, w = image.shape[:2]
    dy = rng.normal(0, scale * h, (grid, grid)).astype(np.float32)
    dx = rng.normal(0, scale * w, (grid, grid)).astype(np.float32)
    maps = _displacement_maps(h, w, dy, dx)
    return _warp_pair(image, mask, maps, float(image.min()))


def elastic_deform(image: np.ndarray, mask: Optional[np.ndarray],
                   rng: np.random.Generator, sigma: float = 4.0,
                   points: int = 3, order: int = 0):
    """elasticdeform.deform_random_grid equivalent (reference
    data_generator_mmwhs.py:111-114): a coarse (points x points) displacement
    grid ~ N(0, sigma), spline-densified to full resolution, applied with
    ``order`` interpolation (the reference uses order=0 for BOTH image and
    mask, mode='constant')."""
    h, w = image.shape[:2]
    dy = rng.normal(0, sigma, (points, points)).astype(np.float32)
    dx = rng.normal(0, sigma, (points, points)).astype(np.float32)
    maps = _displacement_maps(h, w, dy, dx)
    img = ip.remap(image.astype(np.float32), *maps,
                   "nearest" if order == 0 else "linear", 0.0)
    return img, None if mask is None else ip.remap(mask, *maps, "nearest", 0)


def _sharpen(img: np.ndarray, rng: np.random.Generator,
             vmax: float) -> np.ndarray:
    alpha = rng.uniform(0.0, 1.0)
    lightness = rng.uniform(0.75, 1.5)
    blurred = ip.gaussian_blur(img, 3, 1.0)
    sharp = img + lightness * (img - blurred)
    return (1 - alpha) * img + alpha * sharp


def _emboss(img: np.ndarray, rng: np.random.Generator,
            vmax: float) -> np.ndarray:
    alpha = rng.uniform(0.0, 1.0)
    s = rng.uniform(0.0, 2.0)
    k = np.array([[-s, -s, 0], [-s, 1, s], [0, s, s]], np.float32)
    emb = ip.filter2d(img, k)
    return (1 - alpha) * img + alpha * emb


def _edge_detect(img: np.ndarray, rng: np.random.Generator,
                 vmax: float) -> np.ndarray:
    alpha = rng.uniform(0.0, 0.7)
    if rng.random() < 0.5:  # sobel magnitude
        gx = ip.sobel(img, 1, 0)
        gy = ip.sobel(img, 0, 1)
        edges = np.sqrt(gx * gx + gy * gy)
    else:  # directed first-difference
        theta = rng.uniform(0, 2 * np.pi)
        k = np.zeros((3, 3), np.float32)
        k[1, 1] = -1.0
        k[1 + int(round(np.sin(theta))), 1 + int(round(np.cos(theta)))] = 1.0
        edges = np.abs(ip.filter2d(img, k))
    edges = np.clip(edges, 0, vmax)
    return (1 - alpha) * img + alpha * edges


def heavy_aug2(image: np.ndarray, mask: Optional[np.ndarray],
               rng: Optional[np.random.Generator] = None, vmax: float = 1.0):
    """Extended heavy augmentation (reference heavy_aug2,
    data_generator_mscmrseg.py:185-214): flips/rot90/affine plus up to 3 of
    {blur, noise, dropout, superpixels, sharpen, emboss, edge-detect, invert,
    add, multiply, contrast, piecewise-affine} per sample. The ops draw when
    they run, after the shuffle and the count, as the JAX copy's lambdas do."""
    rng = rng or np.random.default_rng()
    img, msk = heavy_aug(image, mask, rng, vmax=vmax)  # shared geometric+base
    ops = []
    if rng.random() < 0.25:     # Sometimes(0.5) * inner Sometimes(0.5)
        ops.append(lambda im: superpixels(
            im, rng, n_segments=int(rng.integers(20, 200)),
            p_replace=rng.uniform(0, 1)))
    ops.append(lambda im: _sharpen(im, rng, vmax))
    ops.append(lambda im: _emboss(im, rng, vmax))
    if rng.random() < 0.5:
        ops.append(lambda im: _edge_detect(im, rng, vmax))
    if rng.random() < 0.05:     # iaa.Invert(0.05)
        ops.append(lambda im: vmax - im)
    ops.append(lambda im: im + rng.uniform(-0.04, 0.04) * vmax)     # Add
    ops.append(lambda im: im * rng.uniform(0.5, 1.5))               # Multiply
    ops.append(lambda im: (im - im.mean()) * rng.uniform(0.5, 2.0)
               + im.mean())                                          # contrast
    rng.shuffle(ops)
    for op in ops[:int(rng.integers(0, 4))]:
        img = op(img).astype(np.float32)
    if rng.random() < 0.25:     # Sometimes(PiecewiseAffine)
        img, msk = piecewise_affine(img, msk, rng,
                                    scale=rng.uniform(0.01, 0.05))
    return img, msk
