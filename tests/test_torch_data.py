"""The port's data layer (``slcl_torch.data``) against ``slcl_tpu.data`` on
the committed trees (``tests/fixtures/mini_mmwhs`` raw NIfTI,
``mini_mmwhs_png`` with ``vert``, ``mini_mscmrseg``) and on numpy-seeded
inputs, with the same ``(seed, epoch, index)``.

Tolerances: the steps that only move or decode values (NIfTI, PNG, CSV,
pad, crop, flip, rot90, label remaps) are equal to the bit; images after an
interpolating warp or a filter within atol 1e-4 (cv2's float arithmetic
against numpy's; measured up to 2.3e-5 over every fixture sample); masks,
and the images that ``elastic_deform`` samples nearest, differ on at most
1e-4 of the pixels of a sample (measured: none); the C++ SLIC's
assignments equal ``slcl_tpu.native``'s to the bit. Every transform must
leave its generator where JAX's leaves it: same draws, same count.
"""
import shutil
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from slcl_torch import config as TC
from slcl_torch.data import imgproc, mmwhs, mscmrseg, nifti, png, prepare_datasets, slic
from slcl_torch.data import synthetic, transforms
from slcl_tpu import config as JC
from slcl_tpu import native
from slcl_tpu.data import mmwhs as j_mmwhs
from slcl_tpu.data import mscmrseg as j_mscmrseg
from slcl_tpu.data import nifti as j_nifti
from slcl_tpu.data import synthetic as j_synthetic
from slcl_tpu.data import transforms as j_transforms

torch.set_num_threads(1)

FIX = Path(__file__).resolve().parent / "fixtures"
ATOL_IMG = 1e-4
MAX_MASK_SHARE = 1e-4


def _assert_sample(got, want, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape)
        if exact:
            np.testing.assert_array_equal(g, w)
        elif w.dtype.kind in "iu":
            assert (g != w).mean() <= MAX_MASK_SHARE
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_IMG)


def _tree_pairs(tree, **kw):
    """(port, JAX) datasets of every domain of a fixture tree."""
    if tree == "mmwhs_raw":
        doms = [("s", "ct", {}), ("t", "mr", {}), ("test", "mr", {}), ("test", "ct", {})]
        make = (mmwhs.MMWHSRawDataset, j_mmwhs.MMWHSRawDataset, FIX / "mini_mmwhs")
    elif tree == "mmwhs_png":
        doms = [("s", "ct", {"vert": not kw.get("aug_counter")}), ("t", "mr", {}),
                ("test", "mr", {}), ("test", "ct", {})]
        make = (mmwhs.MMWHSPngDataset, j_mmwhs.MMWHSPngDataset, FIX / "mini_mmwhs_png")
    else:
        doms = [("s", "bssfp", {}), ("t", "lge", {}), ("test", "lge", {}),
                ("test", "bssfp", {})]
        make = (mscmrseg.MSCMRSegDataset, j_mscmrseg.MSCMRSegDataset, FIX / "mini_mscmrseg")
    port, jax_cls, root = make
    for domain, modality, extra in doms:
        args = dict(data_dir=str(root), modality=modality, domain=domain, **extra, **kw)
        yield port(**args), jax_cls(**args)


TREES = ["mmwhs_raw", "mmwhs_png", "mscmrseg"]


@pytest.mark.parametrize("counter", [False, True])
@pytest.mark.parametrize("aug_mode", ["simple", "heavy", "heavy2"])
@pytest.mark.parametrize("tree", TREES)
def test_augmented_samples_match_jax(tree, aug_mode, counter):
    """Every sample of every domain in two epochs, at a crop that pads
    (96 > 64) and one that crops (48)."""
    for crop in (96, 48):
        for ours, theirs in _tree_pairs(tree, crop=crop, augmentation=True,
                                        aug_mode=aug_mode, aug_counter=counter):
            assert len(ours) == len(theirs) > 0
            for epoch in (0, 3):
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                for i in range(len(ours)):
                    _assert_sample(ours[i], theirs[i])


@pytest.mark.parametrize("normalization", ["minmax", "zscore"])
@pytest.mark.parametrize("tree", TREES)
def test_plain_samples_equal_jax(tree, normalization):
    """Without augmentation nothing interpolates: decode, window, pad, crop
    and label remap equal to the bit."""
    for ours, theirs in _tree_pairs(tree, crop=96, normalization=normalization):
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            _assert_sample(ours[i], theirs[i], exact=True)


def test_percentile_fallback_equals_jax(tmp_path):
    """A raw tree without its minmax CSVs windows each slice by its own 1/99
    percentiles."""
    root = tmp_path / "mmwhs"
    shutil.copytree(FIX / "mini_mmwhs", root)
    for csv in root.glob("*minmax*.csv"):
        csv.unlink()
    for domain, modality in (("s", "ct"), ("t", "mr")):
        ours = mmwhs.MMWHSRawDataset(str(root), modality, domain)
        theirs = j_mmwhs.MMWHSRawDataset(str(root), modality, domain)
        assert ours._mnmx is None and len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            _assert_sample(ours[i], theirs[i], exact=True)


@pytest.mark.parametrize("modality", ["CT", "MR"])
def test_minmax_csv_reads_as_pandas(tmp_path, modality):
    """The committed CSVs, and one pandas writes from random windows (its
    parser is one ulp off a correctly rounded one on many of them), with a
    few hand-written forms."""
    for path in (FIX / "mini_mmwhs" / f"{modality}minmax99.csv",
                 tmp_path / f"{modality}minmax99.csv"):
        if not path.exists():
            rng = np.random.default_rng(0 if modality == "CT" else 1)
            ints = rng.integers(-1000, 3000, (200, 999))
            pd.DataFrame({"min99": np.concatenate([np.percentile(ints, 1, axis=1),
                                                   rng.normal(100, 50, 200)]),
                          "max99": np.concatenate([np.percentile(ints, 99, axis=1),
                                                   rng.random(200) * 1e-3])},
                         index=[f"img{i}" for i in range(400)]).to_csv(path)
            with open(path, "a") as f:
                f.write("img400,-0.0,1.5E3\nimg401,00012.5,1e-5\n"
                        "img402,0.000123456789012345678,123456789012345678901\n")
        want = pd.read_csv(path, index_col=0)
        got = mmwhs.read_minmax_csv(path)
        assert list(got) == list(want.index)
        for key, row in got.items():
            for col, v in row.items():
                assert type(v) is type(want.loc[key, col]) and v == want.loc[key, col]


@pytest.mark.parametrize("split", range(len(JC.MMWHS_TEST_FOLDS)))
def test_patient_lists_match_jax(split):
    assert TC.MMWHS_TEST_FOLDS == JC.MMWHS_TEST_FOLDS
    for modality in ("ct", "mr", "CT"):
        for domain in ("s", "t", "test"):
            for fold in (-1, 0, 1, 2, 5):
                for val_num in (None, 0, 1, 2):
                    assert mmwhs.patient_lists(modality, domain, fold, split, val_num) == \
                        j_mmwhs.patient_lists(modality, domain, fold, split, val_num)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32, np.float64, np.int32])
def test_nifti_round_trips(tmp_path, dtype, gz):
    """Port writes, both read; JAX writes, port reads; and the committed
    raw slices decode as JAX decodes them."""
    arr = (np.random.default_rng(5).normal(0, 300, (7, 5, 3))).astype(dtype)
    suffix = ".nii.gz" if gz else ".nii"
    for writer, name in ((nifti.write_nii, "port"), (j_nifti.write_nii, "jax")):
        path = tmp_path / f"{name}{suffix}"
        writer(path, arr, spacing=(2.0, 0.5, 0.75))
        for reader in (nifti.read_nii, j_nifti.read_nii):
            got, spacing = reader(path)
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr)
            assert spacing == (2.0, 0.5, 0.75)
    for path in sorted((FIX / "mini_mmwhs").glob("*/*.nii"))[:6]:
        got, want = nifti.read_nii(path), j_nifti.read_nii(path)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_load_raw_data_mmwhs_equals_jax():
    img = FIX / "mini_mmwhs" / "CT_withGT" / "img1_slice0.nii"
    lab = FIX / "mini_mmwhs" / "CT_withGT" / "lab1_label_slice0.nii"
    for mask_path in (lab, None):
        got = transforms.load_raw_data_mmwhs(img, mask_path)
        want = j_transforms.load_raw_data_mmwhs(img, mask_path)
        np.testing.assert_array_equal(got[0], want[0])
        if mask_path is None:
            assert got[1] is None and want[1] is None
        else:
            assert got[1].dtype == want[1].dtype
            np.testing.assert_array_equal(got[1], want[1])
            assert set(np.unique(got[1])) <= {0, 1, 2, 3}


def _write_png(path, img, filters):
    """An 8-bit grayscale PNG whose row y uses filter ``filters[y % len]``."""
    import struct
    import zlib
    h, w = img.shape
    prev = np.zeros(w, np.int64)
    rows = []
    for y in range(h):
        cur, ftype = img[y].astype(np.int64), filters[y % len(filters)]
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        if ftype == 0:
            pred = np.zeros(w, np.int64)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(t + body))
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                           + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4),
                                     (4, 2, 3, 1)])
def test_png_reader_row_filters(tmp_path, filters):
    """Hand-built files with each of the five row filters, alone and mixed,
    read as cv2 reads them."""
    img = np.random.default_rng(len(filters)).integers(0, 256, (37, 53), dtype=np.uint8)
    img[5:9] = 255  # runs that wrap the filters' sums
    path = tmp_path / "f.png"
    _write_png(path, img, filters)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), img)
    got = png.read_png_gray(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("shape", [(224, 224), (61, 97), (1, 1)])
def test_png_reads_cv2_and_cv2_reads_png(tmp_path, shape):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "cv2.png"), img)
    np.testing.assert_array_equal(png.read_png_gray(tmp_path / "cv2.png"), img)
    png.write_png_gray(tmp_path / "port.png", img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_GRAYSCALE), img)
    for path in sorted(FIX.glob("*/*mask/*.png"))[:8] + sorted(FIX.glob("*/train*/*.png"))[:8]:
        np.testing.assert_array_equal(png.read_png_gray(path),
                                      cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_png_reader_refuses_other_kinds_naming_the_file(tmp_path):
    rng = np.random.default_rng(4)
    cv2.imwrite(str(tmp_path / "colour.png"), rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "deep.png"), rng.integers(0, 65535, (8, 8), dtype=np.uint16))
    path = tmp_path / "interlaced.png"
    _write_png(path, rng.integers(0, 256, (8, 8), dtype=np.uint8), (1,))
    data = bytearray(path.read_bytes())
    data[28] = 1                                   # IHDR's interlace byte
    import zlib
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    path.write_bytes(bytes(data))
    (tmp_path / "broken.png").write_bytes(bytes(data[:40]))
    (tmp_path / "notpng.png").write_bytes(b"GIF89a")
    for name in ("colour", "deep", "interlaced", "broken", "notpng"):
        with pytest.raises(ValueError, match=f"{name}.png"):
            png.read_png_gray(tmp_path / f"{name}.png")
    with pytest.raises(ValueError):
        png.write_png_gray(tmp_path / "x.png", np.zeros((4, 4), np.float32))


@pytest.fixture(scope="module")
def jax_native():
    if not native.available():
        pytest.skip("slcl_tpu.native could not be built (no g++)")
    return native


@pytest.mark.parametrize("grid,iters", [(2, 1), (4, 2), (8, 3), (14, 3), (6, 0)])
@pytest.mark.parametrize("shape", [(224, 224), (61, 97)])
def test_slic_equals_jax_native_bit_for_bit(jax_native, shape, grid, iters):
    """The same C++ source with the same g++ flags: the same segmentation
    and the same segment means, to the bit."""
    rng = np.random.default_rng(grid * 10 + iters)
    img = rng.random(shape).astype(np.float32)
    img[10:40, 20:50] += 1.0
    got = slic.assign(img, grid, iters)
    want = jax_native.slic_assign(img, grid, iters)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    replace = rng.random(grid * grid) < 0.5
    np.testing.assert_array_equal(slic.segment_replace(img, got, replace),
                                  jax_native.segment_replace(img, want, replace))
    img3 = np.stack([img, 2 * img], -1)
    np.testing.assert_array_equal(slic.segment_replace(img3, got, replace),
                                  jax_native.segment_replace(img3, want, replace))


@pytest.mark.parametrize("plain", [False, True])
def test_superpixels_contract(jax_native, plain):
    """The C++ SLIC and the numpy plain version segment differently but keep
    one contract (tests/test_native.py does the same for JAX): segments are
    coherent, replacement smooths the image inside its range, the same rng
    gives the same result, and the plain version equals JAX's numpy path."""
    rng = np.random.default_rng(0)
    img = np.zeros((96, 128), np.float32)
    img[20:60, 30:90] = 1.0
    img += 0.1 * rng.standard_normal(img.shape).astype(np.float32)
    out = transforms.superpixels(img, np.random.default_rng(7), n_segments=64,
                                 p_replace=0.8, iters=2, plain=plain)
    assert out.shape == img.shape and out.dtype == np.float32
    assert img.min() - 1e-5 <= out.min() and out.max() <= img.max() + 1e-5
    assert out.std() < img.std()
    again = transforms.superpixels(img, np.random.default_rng(7), n_segments=64,
                                   p_replace=0.8, iters=2, plain=plain)
    np.testing.assert_array_equal(out, again)
    assign = slic.assign(img, 6, 3) if not plain else transforms._slic_assign_numpy(img, 6, 2)
    within = sum(img[assign == k].var() * (assign == k).sum()
                 for k in np.unique(assign)) / img.size
    assert within < 0.7 * img.var()
    if plain:
        np.testing.assert_array_equal(assign, j_transforms._slic_assign_numpy(img, 6, 2))


def test_slic_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "slic.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(slic, "SRC", bad)
    monkeypatch.setattr(slic, "_lib", None)
    monkeypatch.setattr(slic, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        slic.assign(np.zeros((8, 8), np.float32), 2, 1)


def _same_draws(fn_ours, fn_theirs, seed):
    """Run both with one seed; return their outputs after checking that the
    generators were left in the same state."""
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = fn_ours(r1), fn_theirs(r2)
    assert r1.random() == r2.random(), "the generators drew a different count"
    return got, want


def _as_pair(x):
    return x if isinstance(x, tuple) else (x, None)


TRANSFORMS = ["simple_aug", "heavy_aug", "heavy_aug2", "affine_shear_aug",
              "perspective_warp", "piecewise_affine", "elastic_deform",
              "elastic_deform_linear", "_sharpen", "_emboss", "_edge_detect",
              "superpixels"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", TRANSFORMS)
def test_transforms_match_jax(jax_native, name, seed):
    """Each transform on a 224x224 slice and its mask, same seed: same draws,
    images within atol 1e-4, masks equal but at most 1e-4 of the pixels."""
    rng = np.random.default_rng(seed)
    img = rng.random((224, 224)).astype(np.float32)
    mask = rng.integers(0, 4, (224, 224)).astype(np.uint8)

    def call(mod):
        if name == "elastic_deform_linear":
            return lambda r: mod.elastic_deform(img, mask, r, sigma=5.0, order=1)
        fn = getattr(mod, name)
        if name.startswith("_"):
            return lambda r: fn(img, r, 1.0)
        if name == "superpixels":
            return lambda r: fn(img, r, n_segments=50, p_replace=0.7)
        return lambda r: fn(img, mask, r)

    for trial in range(3):
        got, want = _same_draws(call(transforms), call(j_transforms), 31 * seed + trial)
        (gi, gm), (wi, wm) = _as_pair(got), _as_pair(want)
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        if name == "elastic_deform":   # order 0: the image is sampled nearest
            assert (gi != wi).mean() <= MAX_MASK_SHARE
        else:
            np.testing.assert_allclose(gi, wi, rtol=0, atol=ATOL_IMG)
        if wm is not None:
            assert gm.dtype == wm.dtype
            assert (gm != wm).mean() <= MAX_MASK_SHARE


@pytest.mark.parametrize("shape", [(40, 30), (224, 224), (256, 300), (61, 97)])
def test_host_steps_equal_jax(shape):
    """crop_resize (pad and crop), the label remap, one-hot, normalisations."""
    rng = np.random.default_rng(shape[0])
    img = rng.normal(300, 100, shape).astype(np.float32)
    mask = rng.choice([0, 85, 87, 212, 255], shape).astype(np.uint8)
    for target in ((224, 224), (48, 64)):
        np.testing.assert_array_equal(
            transforms.crop_resize(img, target, pad_value=img.min()),
            j_transforms.crop_resize(img, target, pad_value=img.min()))
        np.testing.assert_array_equal(transforms.crop_resize(mask, target, is_mask=True),
                                      j_transforms.crop_resize(mask, target, is_mask=True))
    for mapping in (TC.MSCMRSEG_LABEL_MAP, TC.MMWHS_PNG_LABEL_MAP):
        remapped = transforms.remap_mask(mask, mapping)
        np.testing.assert_array_equal(remapped, j_transforms.remap_mask(mask, mapping))
        np.testing.assert_array_equal(transforms.to_categorical(remapped),
                                      j_transforms.to_categorical(remapped))
    for fn, args in (("normalize_minmax", (np.float64(120.0), np.float64(480.5))),
                     ("normalize_percentile", (99.0,)), ("normalize_zscore", ())):
        got, want = getattr(transforms, fn)(img, *args), getattr(j_transforms, fn)(img, *args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aug_mode", ["simple", "heavy", "heavy2"])
def test_synthetic_counter_image_matches_jax(aug_mode):
    """The synthetic target pair in every aug_mode (heavy and heavy2 raised
    in the port before it had the transforms)."""
    kw = dict(n_slices=4, crop=48, domain="mr", seed=3, augmentation=True,
              aug_counter=True, aug_mode=aug_mode)
    ours = synthetic.SyntheticCardiacDataset(**kw)
    theirs = j_synthetic.SyntheticCardiacDataset(**kw)
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(4):
            got, want = ours[i], theirs[i]
            _assert_sample(got, want)
            assert 0.0 <= got[1].min() and got[1].max() <= 1.0


@pytest.mark.parametrize("name,tree", [("mmwhs", "mini_mmwhs"), ("mmwhs", "mini_mmwhs_png"),
                                       ("mscmrseg", "mini_mscmrseg"), ("synthetic", ""),
                                       ("acdc", "")])
def test_dataset_switch(name, tree):
    cfg = TC.Config()
    cfg.data.dataset, cfg.data.data_dir = name, str(FIX / tree)
    cfg.data.raw = tree == "mini_mmwhs"
    cfg.data.aug_counter = True
    if name == "acdc":
        with pytest.raises(ValueError, match="unknown dataset"):
            prepare_datasets(cfg)
        return
    ds = prepare_datasets(cfg)
    assert set(ds) == {"train_s", "train_t", "valid_t", "test_t", "test_s"}
    assert all(len(d) > 0 for d in ds.values())
    assert ds["train_t"].aug_counter and not ds["train_s"].aug_counter
    img_a, img_b, _ = ds["train_t"][0]
    assert img_a.shape == img_b.shape == (cfg.data.crop, cfg.data.crop, 3)


def test_imgproc_warp_of_a_dataset_slice_shares_its_grid():
    """simple_aug samples image and mask on one grid: the mask is the
    nearest lookup of the grid that the image interpolates."""
    img = png.read_png_gray(FIX / "mini_mscmrseg" / "trainA" / "pat_6_bSSFP_0.png")
    img = img.astype(np.float32) / 255.0
    mask = (img > 0.5).astype(np.uint8)
    a, m = transforms.simple_aug(img, mask, np.random.default_rng(1))
    rng = np.random.default_rng(1)
    ang, tx, ty, s = rng.integers(-15, 15), rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), \
        rng.uniform(0.9, 1.1)
    M = imgproc.get_rotation_matrix_2d((32.0, 32.0), float(ang), float(s))
    M[0, 2] += tx * 64
    M[1, 2] += ty * 64
    want = imgproc.warp_affine(mask, M, (64, 64), "nearest", 0)
    if rng.random() < 0.5:
        want = want[:, ::-1]
    np.testing.assert_array_equal(m, want)


@pytest.mark.parametrize("tree", ["mmwhs", "mscmrseg"])
def test_chip_smoke_trees_are_the_real_formats(tmp_path, tree):
    """The trees ``chip_smoke.py`` phase 6 writes with the port's writers
    (two slices a patient here) read the same through ``slcl_tpu.data``
    (pandas, cv2, its NIfTI reader) as through the port, every domain
    non-empty and the masks holding all four classes."""
    import chip_smoke
    root = chip_smoke.write_trees(tmp_path, slices=2)[tree]
    ours_cls, theirs_cls, src, trg = (
        (mmwhs.MMWHSRawDataset, j_mmwhs.MMWHSRawDataset, "ct", "mr") if tree == "mmwhs"
        else (mscmrseg.MSCMRSegDataset, j_mscmrseg.MSCMRSegDataset, "bssfp", "lge"))
    for domain, modality in (("s", src), ("t", trg), ("test", trg), ("test", src)):
        ours = ours_cls(str(root), modality, domain)
        theirs = theirs_cls(str(root), modality, domain)
        # four training and two test patients a domain
        assert len(ours) == len(theirs) == 2 * (2 if domain == "test" else 4)
        for i in range(len(ours)):
            got = ours[i]
            _assert_sample(got, theirs[i], exact=True)
            assert set(np.unique(got[1])) == {0, 1, 2, 3}
