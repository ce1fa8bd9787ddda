"""MMWHS CT<->MR pipelines: raw per-slice NIfTI and preprocessed PNG.

A copy of ``slcl_tpu/data/mmwhs.py`` that reads its PNGs with
``png.read_png_gray`` and its minmax CSV with the ``csv`` module (no OpenCV,
no pandas). Parity targets:
  raw:  reference dataset/data_generator_mmwhs_raw.py (patient fold tables,
        per-slice ``img{pat}_slice{n}.nii`` decode via
        ``load_raw_data_mmwhs``, per-patient minmax CSV or percentile
        fallback, centre crop/pad to 224, simple/heavy aug, grayscale ->
        3-channel stack)
  png:  reference dataset/data_generator_mmwhs.py (``pat_{id}_..._{i}.png``
        16 slices/patient, mask remap {87, 212, 255}, aug_counter pairs for
        MCCL, epoch-length equalisation)
"""
from __future__ import annotations

import csv
import os
import re
from glob import glob
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .. import config as C
from . import transforms as T
from .png import read_png_gray


def patient_lists(modality: str, domain: str, fold: int, split: int,
                  val_num: Optional[int] = None):
    """Patient-ID resolution (data_generator_mmwhs_raw.py:64-107).

    source/target train: full modality train set + the extra fold patients
    (CT ids offset +32); test: the fold's patients only.
    """
    is_ct = modality.lower() == "ct"
    folds = C.MMWHS_TEST_FOLDS[split]
    if domain in ("s", "t"):
        base = list(C.MMWHS_CT_TRAIN_SET if is_ct else C.MMWHS_MR_TRAIN_SET)
        fold_idx = fold if domain == "s" or val_num is None else val_num
        extra = folds[fold_idx] if 0 <= fold_idx < len(folds) else []
        base += [p + C.MMWHS_CT_ID_OFFSET for p in extra] if is_ct else list(extra)
    else:  # test
        extra = folds[fold] if 0 <= fold < len(folds) else list(range(1, 21))
        base = [p + C.MMWHS_CT_ID_OFFSET for p in extra] if is_ct else list(extra)
    return sorted(set(base))


_POW10 = [float(f"1e{i}") for i in range(309)]
_NUMBER = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*")


def _csv_float(text: str) -> np.float64:
    """A decimal as pandas' C parser (``read_csv``'s default, what the JAX
    reader uses) reads it: up to 17 significant digits summed in a double,
    then scaled by a power of ten. That is not correctly rounded (past about
    15 digits it is one ulp off ``float(text)`` on a third of the windows
    ``to_csv`` writes), and the windows must match JAX's to the bit."""
    m = _NUMBER.fullmatch(text)
    if m is None or not (m.group(2) or m.group(3)):
        if text.strip() == "":
            return np.float64("nan")
        raise ValueError(f"not a number: {text!r}")
    number, digits, exponent = 0.0, 0, 0
    for ch in m.group(2):
        if digits < 17:
            number, digits = number * 10.0 + (ord(ch) - 48), digits + 1
        else:
            exponent += 1
    for ch in m.group(3) or "":
        if digits >= 17:
            break
        number, digits, exponent = number * 10.0 + (ord(ch) - 48), digits + 1, exponent - 1
    if m.group(1) == "-":
        number = -number
    exponent += int(m.group(4) or 0)
    if exponent > 308:
        number *= float("inf")
    elif exponent >= 0:
        number *= _POW10[exponent]
    elif exponent >= -308:
        number /= _POW10[-exponent]
    else:
        number = number / _POW10[-308 - exponent] / _POW10[308] if exponent >= -616 else 0.0
    return np.float64(number)


def read_minmax_csv(path) -> Dict[str, Dict[str, np.float64]]:
    """``{MOD}minmax{p}.csv``: one row a patient (``img{pat}``), one column a
    window bound (``min{p}``, ``max{p}``), read as pandas reads them."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    cols = rows[0][1:]
    return {r[0]: {c: _csv_float(v) for c, v in zip(cols, r[1:])} for r in rows[1:]}


class MMWHSRawDataset:
    """Per-slice raw NIfTI dataset (the train_SLCL/train_MCCL data path)."""

    def __init__(self, data_dir: str, modality: str, domain: str = "s",
                 fold: int = 0, split: int = 0, crop: int = 224,
                 normalization: str = "minmax", percent: float = 99.0,
                 augmentation: bool = False, aug_mode: str = "simple",
                 aug_counter: bool = False, val_num: Optional[int] = None,
                 seed: int = 1234):
        self.data_dir = Path(data_dir)
        self.modality = modality.upper()
        self.domain = domain
        self.crop = crop
        self.normalization = normalization
        self.percent = int(float(percent))
        self.aug = augmentation
        self.aug_mode = aug_mode
        self.aug_counter = aug_counter
        self.seed = seed
        self._epoch = 0

        folder_type = "_withGT" if domain == "test" else "_woGT"
        self.img_dir = self.data_dir / f"{self.modality}{folder_type}"
        self.lab_dir = self.data_dir / f"{self.modality}_withGT"
        pats = patient_lists(modality, domain, fold, split, val_num)
        self.image_paths = []
        for p in pats:
            self.image_paths += sorted(glob(str(self.img_dir / f"img{p}_slice*.nii")))
        self._mnmx = None
        if normalization == "minmax":
            path = self.data_dir / f"{self.modality}minmax{self.percent}.csv"
            if path.exists():
                self._mnmx = read_minmax_csv(path)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, index: int):
        img_path = self.image_paths[index]
        base = os.path.basename(img_path)
        m = re.search(r"img(\d+)_slice(\d+)\.nii", base)
        key = f"img{m.group(1)}" if m else Path(img_path).stem.split("_slice")[0]
        lab_path = str(self.lab_dir / base.replace("img", "lab").replace(
            "_slice", "_label_slice"))
        img, mask = T.load_raw_data_mmwhs(
            img_path, lab_path if os.path.exists(lab_path) else None)

        if self.normalization == "minmax":
            if self._mnmx is not None and key in self._mnmx:
                window = self._mnmx[key]
                img = T.normalize_minmax(img, window[f"min{self.percent}"],
                                         window[f"max{self.percent}"])
            else:
                img = T.normalize_percentile(img, self.percent)
        elif self.normalization == "zscore":
            img = T.normalize_zscore(img)

        img = T.crop_resize(img.astype(np.float32), (self.crop, self.crop))
        if mask is not None:
            mask = T.crop_resize(mask, (self.crop, self.crop), is_mask=True)
        else:
            mask = np.zeros((self.crop, self.crop), np.uint8)

        rng = T.sample_rng(self.seed, self._epoch, index)
        if self.aug_counter:
            # MCCL target pair: two independent augmentations of the slice
            # (data_generator_mmwhs.py:132-151); the mask draws nothing in
            # either and is dropped, so it is not augmented
            img_a, _ = self._augment(img, None, rng)
            img_b, _ = self._augment(img, None, rng)
            return (np.stack([img_a] * 3, -1).astype(np.float32),
                    np.stack([img_b] * 3, -1).astype(np.float32), base)
        if self.aug:
            img, mask = self._augment(img, mask, rng)
        img3 = np.stack([img] * 3, axis=-1).astype(np.float32)
        return img3, mask.astype(np.int64), base

    def _augment(self, img, mask, rng):
        if self.aug_mode == "simple":
            return T.simple_aug(img, mask, rng)
        if "2" in self.aug_mode:
            return T.heavy_aug2(img, mask, rng)
        return T.heavy_aug(img, mask, rng)


class MMWHSPngDataset:
    """Preprocessed-PNG dataset (raw=False path, data_generator_mmwhs.py)."""

    SLICES_PER_PATIENT = 16

    def __init__(self, data_dir: str, modality: str, domain: str = "s",
                 fold: int = 0, split: int = 0, crop: int = 224,
                 normalization: str = "minmax", augmentation: bool = False,
                 aug_mode: str = "simple", aug_counter: bool = False,
                 vert: bool = False, seed: int = 1234):
        self.data_dir = Path(data_dir)
        self.modality = modality.lower()
        self.crop = crop
        self.normalization = normalization
        self.aug = augmentation
        self.aug_mode = aug_mode
        self.aug_counter = aug_counter
        self.vert = vert
        self.seed = seed
        self._epoch = 0
        phase = "test" if domain == "test" else "train"
        sub = "A" if self.modality == "ct" else "B"
        self.img_dir = self.data_dir / f"{phase}{sub}"
        self.lab_dir = self.data_dir / f"{phase}{sub}mask"
        # precomputed label point clouds for AdaptEvery's Chamfer/PointNet
        # branch (reference data_generator_mmwhs.py:48-49,64-65 loads
        # ``vert{MOD}/lab{num}_slice{slc}.npy``; adapted to this layout's
        # flattened image naming)
        self.vert_dir = self.data_dir / f"vert{self.modality.upper()}"
        pats = patient_lists(self.modality, domain, fold, split)
        self.items = []
        for p in pats:
            for i in range(self.SLICES_PER_PATIENT):
                fp = self.img_dir / f"pat_{p}_{self.modality}_{i}.png"
                if fp.exists():
                    self.items.append(fp)
        if vert:
            missing = [f.name for f in self.items
                       if not (self.vert_dir / f"{f.stem}.npy").exists()]
            if missing:
                raise FileNotFoundError(
                    f"vert=True but {len(missing)} point-cloud files are "
                    f"missing under {self.vert_dir} (e.g. {missing[0]!r})")

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int):
        fp = self.items[index]
        img = read_png_gray(fp).astype(np.float32)
        lab_fp = self.lab_dir / fp.name
        mask = read_png_gray(lab_fp) if lab_fp.exists() else np.zeros_like(img, np.uint8)
        mask = T.remap_mask(mask, C.MMWHS_PNG_LABEL_MAP)
        if self.normalization == "minmax":
            img = img / 255.0
        else:
            img = T.normalize_zscore(img)
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
            else:
                aug = T.heavy_aug2 if "2" in self.aug_mode else T.heavy_aug
                img, mask = aug(img, mask, rng)
                # heavy modes add elastic deformation at 50%
                # (data_generator_mmwhs.py:111-114)
                if rng.random() < 0.5:
                    img, mask = T.elastic_deform(img, mask, rng,
                                                 sigma=rng.uniform(1, 7))
        img3 = np.stack([img] * 3, -1).astype(np.float32)
        if self.vert:
            # vert branch (data_generator_mmwhs.py:129-131): the augmented
            # image with the STATIC precomputed point cloud — vertices
            # deliberately do not track augmentation (reference behaviour)
            verts = np.load(self.vert_dir / f"{fp.stem}.npy")
            return (img3, mask.astype(np.int64),
                    verts.astype(np.float32), fp.name)
        return img3, mask.astype(np.int64), fp.name


def prepare_datasets_mmwhs(cfg):
    """Build the train/valid/test dataset dict (prepare_dataset parity,
    data_generator_mmwhs_raw.py:201-240)."""
    d = cfg.data
    src = "ct" if not d.rev else "mr"
    trg = "mr" if not d.rev else "ct"
    cls = MMWHSRawDataset if d.raw else MMWHSPngDataset
    kw = dict(data_dir=d.data_dir, fold=d.fold, split=d.split, crop=d.crop,
              normalization=d.normalization)
    src_kw = {}
    if d.raw:
        kw["percent"] = d.percent
        kw["val_num"] = d.val_num
        if d.vert:
            # the reference's raw generator silently ignores vert=True
            # (data_generator_mmwhs_raw.py has no vert path even though
            # Trainer_AdaptEvery.py:185-187 passes it) — fail loudly
            # instead of training AdaptEvery without its point branch
            raise ValueError("data.vert requires the preprocessed-PNG "
                             "MMWHS tree (data.raw=false); the raw layout "
                             "has no vert{MOD}/ point-cloud files")
    elif d.vert:
        # source loader only, like the synthetic pipeline / zip_domains
        src_kw["vert"] = True
    return {
        "train_s": cls(modality=src, domain="s", augmentation=d.aug_s,
                       aug_mode=d.aug_mode, **src_kw, **kw),
        "train_t": cls(modality=trg, domain="t", augmentation=d.aug_t,
                       aug_mode=d.aug_mode, aug_counter=d.aug_counter, **kw),
        "valid_t": cls(modality=trg, domain="test", **kw),
        "test_t": cls(modality=trg, domain="test", **kw),
        "test_s": cls(modality=src, domain="test", **kw),
    }
