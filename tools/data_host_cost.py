#!/usr/bin/env python
"""Time the port's data path on the host it runs on (CPU only, no card).

    python tools/data_host_cost.py [--repeats N]

Writes phase 6's two trees (``chip_smoke.write_trees``, 8 slices a
patient) into a temporary directory, then prints one JSON line:
- ``ms_per_sample``: one thread, the mean over a domain's samples, for the
  MMWHS raw source (simple aug), the MS-CMRSeg target pairs (two warps a
  sample) and the synthetic source;
- ``loader_ms_per_batch``: a Loader of 16 over the same sets with 1 and
  with 4 threads (the default ``data.num_workers``);
- ``op_ms``: one 224x224 bilinear warp, nearest warp and PNG decode of the
  port, and the same calls of OpenCV where it is installed (the card's
  host has none).
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from slcl_torch.data import Loader, SyntheticCardiacDataset  # noqa: E402
from slcl_torch.data import imgproc as ip  # noqa: E402
from slcl_torch.data.mmwhs import MMWHSRawDataset  # noqa: E402
from slcl_torch.data.mscmrseg import MSCMRSegDataset  # noqa: E402
from slcl_torch.data.png import read_png_gray, write_png_gray  # noqa: E402


def _ms(fn, repeats):
    fn()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) * 1e3 / repeats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=50)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        trees = chip_smoke.write_trees(Path(tmp), slices=8)
        sets = {"mmwhs_raw_s": MMWHSRawDataset(str(trees["mmwhs"]), "ct", "s",
                                               augmentation=True),
                "mscmrseg_t_pairs": MSCMRSegDataset(str(trees["mscmrseg"]), "lge", "t",
                                                    augmentation=True, aug_counter=True),
                "synthetic_s": SyntheticCardiacDataset(32, 224, "ct", augmentation=True)}
        per_sample = {k: _ms(lambda d=d: [d[i] for i in range(len(d))], 1) / len(d)
                      for k, d in sets.items()}
        loader = {k: {th: _ms(lambda d=d, th=th: list(Loader(d, 16, num_threads=th)), 1) / 2
                      for th in (1, 4)} for k, d in sets.items()}
        rng = np.random.default_rng(0)
        img = rng.random((224, 224)).astype(np.float32)
        mask = rng.integers(0, 4, (224, 224)).astype(np.uint8)
        M = ip.get_rotation_matrix_2d((112.0, 112.0), 10.0, 1.1)
        png = Path(tmp) / "x.png"
        write_png_gray(png, (img * 255).astype(np.uint8))
        ops = {"warp_linear": _ms(lambda: ip.warp_affine(img, M, (224, 224), "linear", 0.0),
                                  args.repeats),
               "warp_nearest": _ms(lambda: ip.warp_affine(mask, M, (224, 224), "nearest", 0),
                                   args.repeats),
               "png_decode": _ms(lambda: read_png_gray(png), args.repeats)}
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            ops["cv2_warp_linear"] = _ms(lambda: cv2.warpAffine(
                img, M, (224, 224), flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_CONSTANT, borderValue=0.0), args.repeats)
            ops["cv2_warp_nearest"] = _ms(lambda: cv2.warpAffine(
                mask, M, (224, 224), flags=cv2.INTER_NEAREST,
                borderMode=cv2.BORDER_CONSTANT, borderValue=0), args.repeats)
            ops["cv2_png_decode"] = _ms(lambda: cv2.imread(str(png), cv2.IMREAD_GRAYSCALE),
                                        args.repeats)
    print(json.dumps({"ms_per_sample": per_sample, "loader_ms_per_batch": loader,
                      "op_ms": ops}))


if __name__ == "__main__":
    main()
