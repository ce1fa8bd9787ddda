#!/usr/bin/env python
"""Measure how far the port's data layer is from the JAX package's and from
OpenCV, on the CPU (the figures the tests' tolerances are set against).

    JAX_PLATFORMS=cpu python tools/data_parity.py

Prints one JSON line:
- ``samples``: over every sample of every domain of the three fixture trees
  (``tests/fixtures``), each aug_mode with and without counter pairs, crops
  96 and 48, epochs 0 and 3: the largest |image difference| and the largest
  share of a sample's mask (int) pixels that differ, port against
  ``slcl_tpu.data``;
- ``transforms``: the same per transform on seeded 224x224 slices;
- ``imgproc``: per operation, the largest |difference| from cv2 and the
  largest share of nearest-neighbour pixels that differ, on seeded 224x224
  and 61x97 inputs.
"""
import json
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from slcl_torch.data import imgproc as ip  # noqa: E402
from slcl_torch.data import mmwhs, mscmrseg, transforms  # noqa: E402
from slcl_tpu.data import mmwhs as j_mmwhs  # noqa: E402
from slcl_tpu.data import mscmrseg as j_mscmrseg  # noqa: E402
from slcl_tpu.data import transforms as j_transforms  # noqa: E402

FIX = ROOT / "tests" / "fixtures"


def _diff(acc, got, want):
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            if w.dtype.kind in "iu":
                acc["mask_share"] = max(acc["mask_share"], float((g != w).mean()))
            else:
                acc["image"] = max(acc["image"], float(np.abs(g - w).max()))


def samples():
    acc = {"image": 0.0, "mask_share": 0.0, "n": 0}
    trees = [(mmwhs.MMWHSRawDataset, j_mmwhs.MMWHSRawDataset, "mini_mmwhs", ("ct", "mr")),
             (mmwhs.MMWHSPngDataset, j_mmwhs.MMWHSPngDataset, "mini_mmwhs_png", ("ct", "mr")),
             (mscmrseg.MSCMRSegDataset, j_mscmrseg.MSCMRSegDataset, "mini_mscmrseg",
              ("bssfp", "lge"))]
    for ours_cls, theirs_cls, tree, (src, trg) in trees:
        for mode in ("simple", "heavy", "heavy2"):
            for counter in (False, True):
                for crop in (96, 48):
                    for domain, mod in (("s", src), ("t", trg), ("test", trg), ("test", src)):
                        kw = dict(data_dir=str(FIX / tree), modality=mod, domain=domain,
                                  crop=crop, augmentation=True, aug_mode=mode,
                                  aug_counter=counter)
                        ours, theirs = ours_cls(**kw), theirs_cls(**kw)
                        for epoch in (0, 3):
                            ours.set_epoch(epoch)
                            theirs.set_epoch(epoch)
                            for i in range(len(ours)):
                                _diff(acc, ours[i], theirs[i])
                                acc["n"] += 1
    return acc


def per_transform():
    out = {}
    names = ["simple_aug", "heavy_aug", "heavy_aug2", "affine_shear_aug", "perspective_warp",
             "piecewise_affine", "elastic_deform"]
    for name in names:
        acc = {"image": 0.0, "mask_share": 0.0}
        for seed in range(12):
            rng = np.random.default_rng(seed)
            img = rng.random((224, 224)).astype(np.float32)
            mask = rng.integers(0, 4, (224, 224)).astype(np.uint8)
            got = getattr(transforms, name)(img, mask, np.random.default_rng(seed + 100))
            want = getattr(j_transforms, name)(img, mask, np.random.default_rng(seed + 100))
            if name == "elastic_deform":  # order 0: the image is a nearest lookup too
                acc["mask_share"] = max(acc["mask_share"], float((got[0] != want[0]).mean()))
                got, want = got[1:], want[1:]
            _diff(acc, got, want)
        out[name] = acc
    return out


def per_op():
    acc = {}

    def rec(op, value):
        acc[op] = max(acc.get(op, 0.0), float(value))

    for seed in range(20):
        rng = np.random.default_rng(seed)
        h, w = (224, 224) if seed % 2 else (61, 97)
        img = rng.random((h, w)).astype(np.float32)
        mask = rng.integers(0, 4, (h, w)).astype(np.uint8)
        border = float(img.min())
        M = cv2.getRotationMatrix2D((w / 2, h / 2), float(rng.integers(-30, 30)),
                                    float(rng.uniform(0.7, 1.3)))
        M[0, 2] += rng.uniform(-0.6, 0.6) * w
        M[1, 2] += rng.uniform(-0.6, 0.6) * h
        rec("warp_affine_linear", np.abs(ip.warp_affine(img, M, (w, h), "linear", border) - (
            cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_CONSTANT, borderValue=border))).max())
        rec("warp_affine_nearest_share", (ip.warp_affine(mask, M, (w, h), "nearest", 0) != (
            cv2.warpAffine(mask, M, (w, h), flags=cv2.INTER_NEAREST,
                           borderMode=cv2.BORDER_CONSTANT, borderValue=0))).mean())
        frame = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
        inward = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
        src = frame + inward * np.abs(rng.normal(0, 0.1, (4, 2))).astype(np.float32) * \
            np.array([w, h], np.float32)
        P = ip.get_perspective_transform(src, frame)
        rec("warp_perspective_linear", np.abs(
            ip.warp_perspective(img, P, (w, h), "linear", border) - cv2.warpPerspective(
                img, P, (w, h), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                borderValue=border)).max())
        m32 = mask.astype(np.float32)
        rec("warp_perspective_nearest_share", (
            ip.warp_perspective(m32, P, (w, h), "nearest", 0.0) != cv2.warpPerspective(
                m32, P, (w, h), flags=cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT,
                borderValue=0)).mean())
        for g in (3, 4):
            grid = rng.normal(0, 7, (g, g)).astype(np.float32)
            rec(f"resize_cubic_{g}x{g}", np.abs(ip.resize_cubic(grid, (w, h)) - cv2.resize(
                grid, (w, h), interpolation=cv2.INTER_CUBIC)).max())
        sigma = rng.uniform(0.05, 1.0)
        rec("gaussian_blur_5", np.abs(ip.gaussian_blur(img, 5, sigma)
                                      - cv2.GaussianBlur(img, (5, 5), sigma)).max())
        rec("gaussian_blur_3", np.abs(ip.gaussian_blur(img, 3, 1.0)
                                      - cv2.GaussianBlur(img, (3, 3), 1.0)).max())
        k = rng.normal(0, 1, (3, 3)).astype(np.float32)
        rec("filter2d", np.abs(ip.filter2d(img, k) - cv2.filter2D(img, -1, k)).max())
        for dx, dy in ((1, 0), (0, 1)):
            rec("sobel", np.abs(ip.sobel(img, dx, dy) - cv2.Sobel(img, cv2.CV_32F, dx, dy)).max())
    return acc


if __name__ == "__main__":
    print(json.dumps({"samples": samples(), "transforms": per_transform(),
                      "imgproc": per_op()}))
