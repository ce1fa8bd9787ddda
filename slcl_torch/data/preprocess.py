"""Offline preprocessing tools (counterpart of ``slcl_tpu/data/preprocess.py``;
reference preprocess_data.py, cal_sample_mean_std.py and the minmax-CSV
generator), without OpenCV or pandas: NIfTI through ``nifti.read_nii``,
PNGs through ``png``, resizes and CLAHE through ``imgproc`` (cv2's
arithmetic), CSVs through the ``csv`` module in the text pandas'
``DataFrame.to_csv`` writes (each float as its shortest repr), so the
files equal the JAX package's byte for byte.

Run before training on the raw datasets:
  python -m slcl_torch.data.preprocess minmax-csv --data_dir DIR --modality CT
  python -m slcl_torch.data.preprocess nii-to-png-mmwhs --data_dir DIR \\
      --out OUT --modality MR
"""
from __future__ import annotations

import argparse
import csv
import re
from glob import glob
from pathlib import Path
from typing import Dict

import numpy as np

from . import imgproc as ip
from .nifti import read_nii
from .png import read_png_gray, write_png_gray
from .transforms import crop_resize


def _write_frame_csv(path, rows: Dict[str, Dict[str, float]]) -> None:
    """``pd.DataFrame.from_dict(rows, orient="index").to_csv(path)``: a
    header of an empty index name and the first row's keys, then one line
    per key; an empty table is ``""``."""
    with open(path, "w", newline="") as f:
        if not rows:
            f.write('""\n')
            return
        cols = list(next(iter(rows.values())))
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + cols)
        for key, row in rows.items():
            w.writerow([key] + [repr(float(row[c])) for c in cols])


def generate_minmax_csv(data_dir: str, modality: str, percent: float = 99.0,
                        out_dir: str = None) -> str:
    """Per-patient percentile window CSV ``{MOD}minmax{p}.csv``
    (data_generator_mmwhs_raw.py:122-141): rows ``img{pat}``, columns
    ``min{p}`` / ``max{p}`` over all slices of the patient."""
    data_dir = Path(data_dir)
    out_dir = Path(out_dir or data_dir)
    mod = modality.upper()
    p = int(float(percent))
    lower = 1.0 if p == 99 else (0.0 if p == 100 else float(p))
    upper = 99.0 if p == 99 else (100.0 if p == 100 else float(p))

    per_pat = {}
    for folder in (f"{mod}_woGT", f"{mod}_withGT"):
        for fp in sorted(glob(str(data_dir / folder / "img*_slice*.nii"))):
            m = re.search(r"img(\d+)_slice", Path(fp).name)
            if not m:
                continue
            arr, _ = read_nii(fp)
            per_pat.setdefault(f"img{m.group(1)}", []).append(arr.ravel())
    rows = {}
    for key, chunks in sorted(per_pat.items()):
        vals = np.concatenate(chunks)
        rows[key] = {f"min{p}": float(np.percentile(vals, lower)),
                     f"max{p}": float(np.percentile(vals, upper))}
    out = out_dir / f"{mod}minmax{p}.csv"
    _write_frame_csv(out, rows)
    return str(out)


def _window_png(sl: np.ndarray, crop: int) -> np.ndarray:
    """A slice's 1/99-percentile window, centre crop / resize, as uint8."""
    vmin, vmax = np.percentile(sl, 1), np.percentile(sl, 99)
    sl = np.clip((sl - vmin) / (vmax - vmin + 1e-7), 0, 1)
    sl = crop_resize(sl.astype(np.float32), (crop, crop))
    return (sl * 255).astype(np.uint8)


def nii_to_png_mmwhs(data_dir: str, out_dir: str, modality: str,
                     crop: int = 224, percent: float = 99.0):
    """Raw slices -> windowed PNGs ``pat_{id}_{mod}_{slice}.png``
    (preprocess_data.py:101-138 intent)."""
    data_dir, out_dir = Path(data_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mod = modality.upper()
    for fp in sorted(glob(str(data_dir / f"{mod}_woGT" / "img*_slice*.nii"))):
        m = re.search(r"img(\d+)_slice(\d+)", Path(fp).name)
        arr, _ = read_nii(fp)
        sl = arr[:, :, 0] if arr.ndim == 3 else arr
        write_png_gray(out_dir / f"pat_{m.group(1)}_{mod.lower()}_{m.group(2)}.png",
                       _window_png(sl, crop))


def nii_to_png_mscmrseg(data_dir: str, out_dir: str, crop: int = 224,
                        clahe: bool = False, target_spacing: float = 1.0):
    """MS-CMRSeg volumes -> per-slice PNGs ``{name}_{i}.png``: in-plane
    resample to ``target_spacing`` (linear, by the spacing ratios), window,
    centre crop, optional CLAHE (reference preprocess_data.py:28-98)."""
    data_dir, out_dir = Path(data_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for fp in sorted(glob(str(data_dir / "*.nii*"))):
        vol, spacing = read_nii(fp)
        if vol.ndim == 2:
            vol = vol[None]
        name = Path(fp).name.split(".")[0]
        for i, sl in enumerate(vol):
            sy = (spacing[-2] if len(spacing) >= 2 else 1.0) / target_spacing
            sx = (spacing[-1] if len(spacing) >= 1 else 1.0) / target_spacing
            if abs(sy - 1) > 1e-3 or abs(sx - 1) > 1e-3:
                sl = ip.resize_linear(sl.astype(np.float32), fx=sx, fy=sy)
            png = _window_png(sl, crop)
            if clahe:
                png = ip.clahe(png, 2.0, (8, 8))
            write_png_gray(out_dir / f"{name}_{i}.png", png)


def sample_mean_std_csv(data_dir: str, out_csv: str):
    """Per-patient mean / std CSV of a PNG folder (cal_sample_mean_std.py)."""
    rows = {}
    for fp in sorted(glob(str(Path(data_dir) / "*.png"))):
        img = read_png_gray(fp).astype(np.float32)
        pat = "_".join(Path(fp).stem.split("_")[:2])
        rows.setdefault(pat, []).append(img.ravel())
    out = {k: {"mean": float(np.concatenate(v).mean()),
               "std": float(np.concatenate(v).std())} for k, v in rows.items()}
    _write_frame_csv(out_csv, out)
    return out_csv


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m slcl_torch.data.preprocess")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("minmax-csv")
    p1.add_argument("--data_dir", required=True)
    p1.add_argument("--modality", required=True)
    p1.add_argument("--percent", type=float, default=99.0)
    p1.add_argument("--out_dir", default=None)
    p2 = sub.add_parser("nii-to-png-mmwhs")
    p2.add_argument("--data_dir", required=True)
    p2.add_argument("--out", required=True)
    p2.add_argument("--modality", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "minmax-csv":
        print(generate_minmax_csv(args.data_dir, args.modality, args.percent,
                                  args.out_dir))
    elif args.cmd == "nii-to-png-mmwhs":
        nii_to_png_mmwhs(args.data_dir, args.out, args.modality)


if __name__ == "__main__":
    main()
