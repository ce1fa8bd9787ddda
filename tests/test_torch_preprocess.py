"""The port's offline tools (``slcl_torch.data.preprocess``) against
``slcl_tpu.data.preprocess`` on the committed MMWHS tree and on numpy-seeded
NIfTI volumes and PNGs.

Tolerances: none. The CSVs equal the JAX package's byte for byte (pandas'
``to_csv`` text), and the port's ``read_minmax_csv`` reads them back to the
windows pandas reads, to the bit; every PNG equals JAX's pixel for pixel
(the float32 resample of the MS-CMRSeg tool is within an ulp of cv2's and
the 8-bit truncation after it agrees on these inputs; CLAHE and the
uint8 steps are exact).
"""
import shutil
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest

from slcl_torch.data import mmwhs, nifti, png, preprocess
from slcl_tpu.data import preprocess as j_pre

FIX = Path(__file__).resolve().parent / "fixtures"


def _float_tree(root: Path, seed: int, mod: str = "MR"):
    """A raw MMWHS tree of float32 slices whose percentiles interpolate
    (non-integral windows, many digits)."""
    rng = np.random.default_rng(seed)
    for pat, folder in ((3, "woGT"), (11, "withGT"), (40, "withGT")):
        d = root / f"{mod}_{folder}"
        d.mkdir(parents=True, exist_ok=True)
        for s in range(2):
            vol = (rng.normal(size=(1, 20, 24)) * rng.uniform(1e-3, 1e3)
                   + rng.uniform(-50, 50)).astype(np.float32)
            nifti.write_nii(d / f"img{pat}_slice{s}.nii", vol)


@pytest.mark.parametrize("tree,mod,percent", [
    ("fixture", "CT", 99.0), ("fixture", "MR", 99.0), ("float", "MR", 99.0),
    ("float", "MR", 100.0), ("float", "MR", 95.0)])
def test_minmax_csv_equals_jax_and_reads_back_to_its_windows(tmp_path, tree, mod, percent):
    src = tmp_path / "src"
    if tree == "fixture":
        shutil.copytree(FIX / "mini_mmwhs", src)
    else:
        _float_tree(src, 7)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = j_pre.generate_minmax_csv(str(src), mod, percent, str(tmp_path / "j"))
    got = preprocess.generate_minmax_csv(str(src), mod, percent, str(tmp_path / "t"))
    assert Path(got).name == Path(want).name
    assert Path(got).read_bytes() == Path(want).read_bytes()
    frame = pd.read_csv(want, index_col=0)
    windows = mmwhs.read_minmax_csv(got)
    assert list(windows) == list(frame.index)
    for key, row in windows.items():
        for col, v in row.items():
            assert np.float64(frame.loc[key, col]).tobytes() == v.tobytes(), (key, col)


def test_frame_csv_writes_what_pandas_writes(tmp_path):
    """Floats of every magnitude and sign, integral ones, and an empty table."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.normal(size=40) * 10.0 ** rng.integers(-20, 20, 40),
                           [0.0, -0.0, 1.0, 130.0, 1e16, 1e-5, 123456789.0, 0.1]])
    rows = {f"img{i}": {"min99": float(v), "max99": float(-v * 3)} for i, v in enumerate(vals)}
    for table in (rows, {}):
        preprocess._write_frame_csv(tmp_path / "t.csv", table)
        pd.DataFrame.from_dict(table, orient="index").to_csv(tmp_path / "p.csv")
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "p.csv").read_bytes()


def test_sample_mean_std_csv_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    d = tmp_path / "png"
    d.mkdir()
    for pat in (1, 2):
        for i in range(3):
            img = (rng.random((30, 26)) * 255).astype(np.uint8)
            cv2.imwrite(str(d / f"pat_{pat}_lge_{i}.png"), img)
    j_pre.sample_mean_std_csv(str(d), str(tmp_path / "j.csv"))
    preprocess.sample_mean_std_csv(str(d), str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def _same_pngs(got: Path, want: Path):
    names = sorted(p.name for p in want.glob("*.png"))
    assert names and names == sorted(p.name for p in got.glob("*.png"))
    for n in names:
        np.testing.assert_array_equal(png.read_png_gray(got / n),
                                      cv2.imread(str(want / n), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("mod", ["CT", "MR"])
def test_nii_to_png_mmwhs_equals_jax(tmp_path, mod):
    j_pre.nii_to_png_mmwhs(str(FIX / "mini_mmwhs"), str(tmp_path / "j"), mod, crop=48)
    preprocess.nii_to_png_mmwhs(str(FIX / "mini_mmwhs"), str(tmp_path / "t"), mod, crop=48)
    _same_pngs(tmp_path / "t", tmp_path / "j")


@pytest.mark.parametrize("clahe", [False, True])
@pytest.mark.parametrize("spacing", [(8.0, 1.25, 1.25), (8.0, 1.0, 1.0), (5.0, 0.8, 1.3)])
def test_nii_to_png_mscmrseg_equals_jax(tmp_path, clahe, spacing):
    """Resampled (1.25 mm, 0.8 x 1.3 mm) and not (1 mm), CLAHE on and off,
    at a crop that 8 does not divide (CLAHE's padded tiles)."""
    rng = np.random.default_rng(11)
    src = tmp_path / "src"
    src.mkdir()
    for k in range(2):
        yy, xx = np.mgrid[:52, :44]
        vol = (np.sin(xx / 6.0 + k) * np.cos(yy / 9.0) * 300
               + rng.normal(size=(3, 52, 44)) * 40).astype(np.float32)
        nifti.write_nii(src / f"patient{k}_LGE.nii", vol, spacing=spacing)
    j_pre.nii_to_png_mscmrseg(str(src), str(tmp_path / "j"), crop=60, clahe=clahe)
    preprocess.nii_to_png_mscmrseg(str(src), str(tmp_path / "t"), crop=60, clahe=clahe)
    _same_pngs(tmp_path / "t", tmp_path / "j")


def test_cli_writes_the_csv_and_pngs(tmp_path, capsys):
    src = tmp_path / "src"
    shutil.copytree(FIX / "mini_mmwhs", src)
    preprocess.main(["minmax-csv", "--data_dir", str(src), "--modality", "MR",
                     "--out_dir", str(tmp_path)])
    assert capsys.readouterr().out.strip() == str(tmp_path / "MRminmax99.csv")
    assert (tmp_path / "MRminmax99.csv").read_bytes() == (FIX / "mini_mmwhs" / "MRminmax99.csv"
                                                          ).read_bytes()
    preprocess.main(["nii-to-png-mmwhs", "--data_dir", str(src), "--out",
                     str(tmp_path / "png"), "--modality", "MR"])
    j_pre.nii_to_png_mmwhs(str(src), str(tmp_path / "j"), "MR")
    _same_pngs(tmp_path / "png", tmp_path / "j")
