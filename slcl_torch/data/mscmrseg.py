"""MS-CMRSeg bSSFP->LGE PNG pipeline.

A copy of ``slcl_tpu/data/mscmrseg.py`` that reads its PNGs with
``png.read_png_gray`` (no OpenCV). Parity: reference
dataset/data_generator_mscmrseg.py — reads
``pat_{id}_{bSSFP|lge}_{i}.png`` from ``{train|test}{A|B}`` folders, mask
remap {85->1, 212->2, 255->3}, minmax (/255) or zscore normalization, fold
tables MSCMRSEG_TEST_FOLDS.
"""
from __future__ import annotations

from glob import glob
from pathlib import Path

import numpy as np

from .. import config as C
from . import transforms as T
from .png import read_png_gray


class MSCMRSegDataset:
    def __init__(self, data_dir: str, modality: str = "bssfp", domain: str = "s",
                 fold: int = 0, crop: int = 224, normalization: str = "minmax",
                 augmentation: bool = False, aug_mode: str = "simple",
                 aug_counter: bool = False, seed: int = 1234):
        self.data_dir = Path(data_dir)
        self.modality = modality.lower()
        self.crop = crop
        self.normalization = normalization
        self.aug = augmentation
        self.aug_mode = aug_mode
        self.aug_counter = aug_counter
        self.seed = seed
        self._epoch = 0
        phase = "test" if domain == "test" else "train"
        sub = "A" if self.modality == "bssfp" else "B"
        self.img_dir = self.data_dir / f"{phase}{sub}"
        self.lab_dir = self.data_dir / f"{phase}{sub}mask"
        tag = "bSSFP" if sub == "A" else "lge"
        test_pats = set(C.MSCMRSEG_TEST_FOLDS[fold % len(C.MSCMRSEG_TEST_FOLDS)])
        items = sorted(glob(str(self.img_dir / f"pat_*_{tag}_*.png")))
        if not items:  # tolerate lowercase modality tag in filenames
            items = sorted(glob(str(self.img_dir / "pat_*_*_*.png")))

        def pat_id(p):
            return int(Path(p).name.split("_")[1])

        if domain == "test":
            self.items = [p for p in items if pat_id(p) in test_pats]
        else:
            self.items = [p for p in items if pat_id(p) not in test_pats]

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int):
        fp = Path(self.items[index])
        img = read_png_gray(fp).astype(np.float32)
        lab_fp = self.lab_dir / fp.name
        mask = read_png_gray(lab_fp) if lab_fp.exists() else np.zeros_like(img, np.uint8)
        mask = T.remap_mask(mask, C.MSCMRSEG_LABEL_MAP)
        img = img / 255.0 if self.normalization == "minmax" else T.normalize_zscore(img)
        img = T.crop_resize(img, (self.crop, self.crop))
        mask = T.crop_resize(mask, (self.crop, self.crop), is_mask=True)
        rng = T.sample_rng(self.seed, self._epoch, index)
        if self.aug_counter:
            # the mask's warp draws nothing and is dropped: not sampled
            a, _ = T.simple_aug(img, None, rng)
            b, _ = T.simple_aug(img, None, rng)
            return (np.stack([a] * 3, -1).astype(np.float32),
                    np.stack([b] * 3, -1).astype(np.float32), fp.name)
        if self.aug:
            if self.aug_mode == "simple":
                img, mask = T.simple_aug(img, mask, rng)
            elif "2" in self.aug_mode:
                img, mask = T.heavy_aug2(img, mask, rng)
            else:
                img, mask = T.heavy_aug(img, mask, rng)
        return (np.stack([img] * 3, -1).astype(np.float32),
                mask.astype(np.int64), fp.name)


def prepare_datasets_mscmrseg(cfg):
    d = cfg.data
    src = "bssfp" if not d.rev else "lge"
    trg = "lge" if not d.rev else "bssfp"
    kw = dict(data_dir=d.data_dir, fold=d.fold, crop=d.crop,
              normalization=d.normalization)
    return {
        "train_s": MSCMRSegDataset(modality=src, domain="s",
                                   augmentation=d.aug_s, aug_mode=d.aug_mode, **kw),
        "train_t": MSCMRSegDataset(modality=trg, domain="t",
                                   augmentation=d.aug_t, aug_mode=d.aug_mode,
                                   aug_counter=d.aug_counter, **kw),
        "valid_t": MSCMRSegDataset(modality=trg, domain="test", **kw),
        "test_t": MSCMRSegDataset(modality=trg, domain="test", **kw),
        "test_s": MSCMRSegDataset(modality=src, domain="test", **kw),
    }
