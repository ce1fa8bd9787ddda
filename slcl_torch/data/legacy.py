"""Legacy MS-CMRSeg bSSFP / LGE PNG datasets (counterpart of
``slcl_tpu/data/legacy.py``; reference dataset/bSSFP_dataset.py and
dataset/LGE_dataset.py, the standalone few-shot / one-shot loaders).

The JAX module's behaviour on the port's image operations (``imgproc``,
numpy; no OpenCV): every random draw is the JAX module's, in the same order
and count from ``sample_rng(seed, epoch, index)``, so both packages give
the same item (``tests/test_torch_legacy.py``).

  bSSFP: ``trainA/*bSSFP*.png`` + ``trainAmask``, centre crop to ``crop``,
  mask remap {0:0, 85:1, 212:2, 255:3}, flips and a sheared affine, /255.

  LGE: few-shot (``*_{pat}_lge*``), ``fulldata`` (``pat*lge*``) and
  ``oneshot``; unlabelled: (image, name), or with augmentation (image,
  image_aug, name), image_aug through :func:`lge_heavy_aug`; a virtual
  epoch of ``LGE_VIRTUAL_LEN`` except oneshot.

Images NHWC float32 in [0, 1] (three equal channels), masks int64.
"""
from __future__ import annotations

from glob import glob
from pathlib import Path
from typing import Optional

import numpy as np

from . import imgproc as ip
from . import transforms as T
from .png import read_png_gray

LEGACY_LABEL_MAP = {0: 0, 85: 1, 212: 2, 255: 3}
LGE_VIRTUAL_LEN = 609 * 400  # LGE_dataset.py:101


def _center_crop(img: np.ndarray, crop: int) -> np.ndarray:
    """The centre ``crop`` x ``crop``; a side shorter than ``crop`` is
    resized up, nearest, in float32."""
    h, w = img.shape[:2]
    if w == crop and h == crop:
        return img
    by, bx = max((h - crop) // 2, 0), max((w - crop) // 2, 0)
    out = img[by:by + crop, bx:bx + crop]
    if out.shape[0] != crop or out.shape[1] != crop:
        out = ip.resize_nearest(out.astype(np.float32), (crop, crop))
    return out


class BSSFPDataset:
    """Labelled bSSFP source split (reference bSSFPDataSet)."""

    def __init__(self, data_dir: str, crop: int = 224,
                 length: Optional[int] = None, augmentation: bool = True,
                 seed: int = 1234):
        self.data_dir = Path(data_dir)
        self.crop = crop
        self._length = length
        self.aug = augmentation
        self.seed = seed
        self._epoch = 0
        self.items = sorted(glob(str(self.data_dir / "trainA" / "*bSSFP*.png")))
        self.lab_dir = self.data_dir / "trainAmask"

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return self._length if self._length is not None else len(self.items)

    def __getitem__(self, index: int):
        fp = Path(self.items[index % len(self.items)])
        img = read_png_gray(fp).astype(np.float32)
        lab_fp = self.lab_dir / fp.name
        mask = read_png_gray(lab_fp) if lab_fp.exists() else np.zeros_like(img, np.uint8)
        img = _center_crop(img, self.crop)
        mask = _center_crop(mask, self.crop)
        mask = T.remap_mask(mask, LEGACY_LABEL_MAP)
        rng = T.sample_rng(self.seed, self._epoch, index)
        if self.aug:
            if rng.random() < 0.5:
                img, mask = ip.flip(img, 1), ip.flip(mask, 1)
            if rng.random() < 0.5:
                img, mask = ip.flip(img, 0), ip.flip(mask, 0)
            if rng.random() < 0.5:
                img, mask = T.affine_shear_aug(
                    img, mask, rng, rotate=(-10, 10), shear=(-12, 12),
                    translate_x=(-0.1, 0.05), translate_y=(-0.1, 0.1),
                    scale=(0.8, 1.2))
        img = img / 255.0
        return (np.stack([img] * 3, -1).astype(np.float32),
                mask.astype(np.int64), fp.name)


def _elastic(im, rng, vmax):
    return T.elastic_deform(im, None, rng, sigma=rng.uniform(0.5, 3.0), order=1)[0]


def _piecewise(im, rng, vmax):
    return T.piecewise_affine(im, None, rng, scale=rng.uniform(0.01, 0.05))[0]


def _perspective(im, rng, vmax):
    return T.perspective_warp(im, None, rng, scale=rng.uniform(0.01, 0.1))[0]


def _noise(im, rng, vmax):
    return im + rng.normal(0, rng.uniform(0, 0.05) * vmax, im.shape).astype(np.float32)


def _dropout(im, rng, vmax):
    out = im.copy()
    if rng.random() < 0.5:  # pixel dropout
        keep = rng.random(im.shape[:2]) >= rng.uniform(0.01, 0.1)
        return out * keep.astype(np.float32)
    h, w = im.shape[:2]     # coarse dropout
    gh = max(int(h * rng.uniform(0.1, 0.2)), 1)
    gw = max(int(w * rng.uniform(0.1, 0.2)), 1)
    grid = rng.random((gh, gw)) >= rng.uniform(0.01, 0.05)
    return out * ip.resize_nearest(grid.astype(np.float32), (w, h))


def _blur(im, rng, vmax):
    c = rng.integers(0, 3)
    if c == 0:
        return ip.gaussian_blur(im, 5, rng.uniform(1.0, 1.75))
    if c == 1:
        return ip.box_blur(im, int(rng.integers(2, 5)))
    k = int(rng.integers(1, 3)) * 2 + 1  # 3 or 5
    return ip.median_blur(im.astype(np.float32), k)


def lge_heavy_aug(img: np.ndarray, rng: np.random.Generator,
                  vmax: float = 255.0) -> np.ndarray:
    """The LGE unlabelled-target pipeline (LGE_dataset.py:12-62): flips, an
    affine always, then up to three of elastic, piecewise affine,
    perspective, noise, dropout and blur in a shuffled order; image only."""
    if rng.random() < 0.5:
        img = ip.flip(img, 1)
    if rng.random() < 0.2:
        img = ip.flip(img, 0)
    img, _ = T.affine_shear_aug(img, None, rng, rotate=(-45, 45),
                                shear=(-16, 16), translate_x=(-0.2, 0.2),
                                translate_y=(-0.2, 0.2), scale=(0.9, 1.1))
    ops = [_elastic, _piecewise, _perspective, _noise, _dropout, _blur]
    rng.shuffle(ops)
    for op in ops[:int(rng.integers(0, 4))]:
        img = op(img, rng, vmax).astype(np.float32)
    return img


class LGEDataset:
    """Unlabelled LGE target split (reference LGEDataSet)."""

    def __init__(self, data_dir: str, crop: int = 224, pat_id: int = 0,
                 mode: str = "fewshot", augmentation: bool = False,
                 seed: int = 1234, virtual_len: Optional[int] = None):
        self.data_dir = Path(data_dir)
        self.crop = crop
        self.aug = augmentation
        self.seed = seed
        self._epoch = 0
        pat = "pat*lge*" if mode == "fulldata" else f"*_{pat_id}_lge*"
        self.items = sorted(glob(str(self.data_dir / "trainB" / f"{pat}.png")))
        if mode == "oneshot":
            self._length = len(self.items)
        else:
            self._length = virtual_len if virtual_len is not None else LGE_VIRTUAL_LEN

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return self._length

    def __getitem__(self, index: int):
        fp = Path(self.items[index % len(self.items)])
        img = _center_crop(read_png_gray(fp).astype(np.float32), self.crop)
        image = np.stack([img / 255.0] * 3, -1).astype(np.float32)
        if not self.aug:
            return image, fp.name
        rng = T.sample_rng(self.seed, self._epoch, index)
        img_aug = lge_heavy_aug(img, rng, vmax=255.0)
        return image, np.stack([img_aug / 255.0] * 3, -1).astype(np.float32), fp.name
