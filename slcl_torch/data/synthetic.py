"""Synthetic cardiac-like dataset for tests, benchmarks, and CI.

The real MMWHS/MS-CMRSeg data is not distributable with the framework; this
generator produces structured 2D "short-axis cardiac" slices with the same
contract as the real pipelines (img (H, W, 3) float32 in [0, 1] or z-scored,
mask (H, W) int32 with classes {0 BG, 1 MYO, 2 LV, 3 RV}) and a controllable
domain gap (CT-like vs MR-like intensity statistics), so the full UDA recipe
is exercisable end-to-end without data on disk.

A copy of ``slcl_tpu/data/synthetic.py`` (numpy only), so both packages draw
the same slices from the same seed.
"""
from __future__ import annotations

import numpy as np


class SyntheticCardiacDataset:
    """Deterministic per-index synthetic slices.

    domain 'ct': bright blood pool, sharp edges, low noise.
    domain 'mr': inverted-ish contrast, blur, higher noise, bias field.
    """

    def __init__(self, n_slices: int = 64, crop: int = 224, domain: str = "ct",
                 seed: int = 1234, augmentation: bool = False,
                 aug_counter: bool = False, vert: bool = False,
                 n_points: int = 300, gap: float = 1.0,
                 aug_mode: str = "simple"):
        """``gap`` scales the CT->MR appearance shift: 0 = identical
        domains, 1 = full contrast inversion (the default, an adversarial
        stress test validated by the same-domain oracle at 0.986 dice).
        ``aug_mode`` ('simple' | 'heavy' | 'heavy2') selects the counter-
        image augmentation like the real pipelines (heavy2 exercises the
        native SLIC tier)."""
        self.n = n_slices
        self.crop = crop
        self.domain = domain
        self.seed = seed
        self.aug = augmentation
        self.aug_counter = aug_counter
        self.vert = vert
        self.n_points = n_points
        self.gap = gap
        self.aug_mode = aug_mode
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return self.n

    # ------------------------------------------------------------------
    def _mask(self, rng: np.random.Generator) -> np.ndarray:
        s = self.crop
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        cy = s / 2 + rng.uniform(-s * 0.08, s * 0.08)
        cx = s / 2 + rng.uniform(-s * 0.08, s * 0.08)
        r_lv = s * rng.uniform(0.08, 0.12)
        r_myo = r_lv + s * rng.uniform(0.04, 0.07)
        # LV cavity + MYO ring
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        mask = np.zeros((s, s), np.int32)
        mask[d < r_myo] = 1
        mask[d < r_lv] = 2
        # RV: crescent to the left
        rv_cy = cy + rng.uniform(-s * 0.03, s * 0.03)
        rv_cx = cx - r_myo - s * rng.uniform(0.01, 0.04)
        a, b = s * rng.uniform(0.10, 0.14), s * rng.uniform(0.06, 0.09)
        ell = ((yy - rv_cy) / b) ** 2 + ((xx - rv_cx) / a) ** 2 < 1.0
        mask[np.logical_and(ell, mask == 0)] = 3
        return mask

    def _image(self, mask: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        s = self.crop
        ct_levels = {0: 0.18, 1: 0.45, 2: 0.85, 3: 0.80}
        if self.domain == "ct":
            levels = ct_levels
            noise, blur = 0.03, 0
        else:
            mr_levels = {0: 0.25, 1: 0.65, 2: 0.40, 3: 0.45}
            g = self.gap
            levels = {k: (1 - g) * ct_levels[k] + g * mr_levels[k]
                      for k in ct_levels}
            noise, blur = 0.03 + 0.05 * g, (2 if g > 0.3 else 0)
        img = np.zeros((s, s), np.float32)
        for k, v in levels.items():
            img[mask == k] = v
        # anatomy texture + bias field
        img += 0.05 * rng.standard_normal((s, s)).astype(np.float32)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img *= (0.9 + 0.2 * np.sin(2 * np.pi * (yy * rng.uniform(0.3, 0.8)
                                                + xx * rng.uniform(0.3, 0.8))))
        if blur:
            from scipy import ndimage
            img = ndimage.uniform_filter(img, size=blur + 1)
        img += noise * rng.standard_normal((s, s)).astype(np.float32)
        return np.clip(img, 0.0, 1.0)

    def _augment(self, img, mask, rng):
        """Cheap affine-ish aug mirroring ImageProcessor.simple_aug intent."""
        if rng.random() < 0.5:
            img, mask = img[:, ::-1], mask[:, ::-1]
        shift = rng.integers(-10, 11, size=2)
        img = np.roll(img, shift, axis=(0, 1))
        mask = np.roll(mask, shift, axis=(0, 1))
        return img, mask

    def __getitem__(self, idx: int):
        # anatomy/appearance are deterministic per index (stable dataset
        # identity); augmentation varies per EPOCH (a fixed per-index aug rng
        # made the 128-slice synthetic set memorizable and killed
        # generalization) but is seeded from (seed, epoch, index) so runs
        # with the same config seed are reproducible
        rng = np.random.default_rng(self.seed * 100003 + idx)
        aug_rng = np.random.default_rng(
            [self.seed, 0x5EED, self._epoch, idx])
        mask = self._mask(rng)
        img = self._image(mask, rng)
        if self.aug:
            img, mask = self._augment(img, mask, aug_rng)
        img3 = np.stack([img] * 3, axis=-1).astype(np.float32)
        name = f"synth_{self.domain}_{idx}"
        if self.aug_counter:
            img_b = self._image(mask, rng)
            if self.aug_mode == "simple":
                img_b, _ = self._augment(img_b, mask, aug_rng)
            else:  # heavy / heavy2 like the real pipelines
                from . import transforms as T
                fn = T.heavy_aug2 if "2" in self.aug_mode else T.heavy_aug
                img_b, _ = fn(img_b, None, aug_rng)
                img_b = np.clip(img_b, 0.0, 1.0)
            img3_b = np.stack([img_b] * 3, axis=-1).astype(np.float32)
            return img3, img3_b, name
        if self.vert:
            return img3, mask.astype(np.int64), self._vertices(mask, rng), name
        return img3, mask.astype(np.int64), name

    def _vertices(self, mask: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Point cloud from foreground boundary pixels (AdaptEvery's vert
        data: (n_points, 3) = normalized (row, col, class))."""
        ys, xs = np.nonzero(mask > 0)
        if ys.size == 0:
            return np.zeros((self.n_points, 3), np.float32)
        sel = rng.integers(0, ys.size, self.n_points)
        pts = np.stack([ys[sel] / self.crop, xs[sel] / self.crop,
                        mask[ys[sel], xs[sel]] / 3.0], axis=1)
        return pts.astype(np.float32)
