"""The legacy bSSFP / LGE datasets (``slcl_torch.data.legacy``) against
``slcl_tpu.data.legacy`` on a tree written as ``tests/test_data.py`` writes
one, and the image operations they and the serve CLI and offline tools add
to ``slcl_torch.data.imgproc`` against cv2.

Tolerances: the uint8 resize, nearest resize, CLAHE and the median blur
equal cv2 to the bit; the float32 linear resize and the box blur within
atol 1e-4 of cv2 on values up to 255 / 7 (``test_torch_imgproc.py``'s
atol for the warps; measured up to 4e-6: cv2 5.x rounds its sums in
another order). Dataset
items: masks and names equal, images (in [0, 1]) within atol 1e-4 (the
warps' float arithmetic against cv2's); ``lge_heavy_aug`` the same on its
output / 255.
"""
import cv2
import numpy as np
import pytest

from slcl_torch.data import imgproc as ip
from slcl_torch.data import legacy
from slcl_tpu.data import legacy as j_legacy

ATOL = 1e-4


def _image(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return (127 + 120 * np.sin(xx / 7.0) * np.cos(yy / 5.0)).astype(np.uint8)


SIZES = [(224, 224, 224, 224), (256, 256, 224, 224), (200, 180, 224, 224),
         (448, 448, 224, 224), (100, 150, 224, 224), (37, 53, 224, 224),
         (512, 512, 224, 224), (10, 13, 7, 5), (448, 446, 224, 223)]


@pytest.mark.parametrize("h,w,dh,dw", SIZES)
def test_resizes_match_cv2(h, w, dh, dw):
    """uint8 linear (the serve CLI's: 11-bit fixed point, an exact halving
    as a 2x2 mean) and nearest to the bit; float32 linear within ATOL."""
    for kind in ("noise", "smooth"):
        img = _image(kind, h, w)
        np.testing.assert_array_equal(ip.resize_linear(img, (dw, dh)), cv2.resize(img, (dw, dh)))
        f = img.astype(np.float32) / 7
        np.testing.assert_allclose(ip.resize_linear(f, (dw, dh)), cv2.resize(f, (dw, dh)),
                                   rtol=0, atol=ATOL)
        np.testing.assert_array_equal(
            ip.resize_nearest(f, (dw, dh)),
            cv2.resize(f, (dw, dh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("h,w,fx,fy", [(224, 224, 1.3, 0.7), (200, 180, 0.5, 0.5),
                                       (150, 170, 1.25, 1.5625), (256, 216, 0.78125, 0.78125),
                                       (48, 44, 0.8, 0.8)])
def test_resize_by_factors_matches_cv2(h, w, fx, fy):
    """float32 sized by ``fx`` / ``fy`` (the MS-CMRSeg resample): cv2's
    size, and its coordinates mapped with 1 / fx."""
    f = np.random.default_rng(1).random((h, w)).astype(np.float32) * 36
    want = cv2.resize(f, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    got = ip.resize_linear(f, fx=fx, fy=fy)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_median_and_box_blur_match_cv2(k):
    f = np.random.default_rng(k).random((60, 50)).astype(np.float32) * 255
    if k in (3, 5):
        np.testing.assert_array_equal(ip.median_blur(f, k), cv2.medianBlur(f, k))
    if k <= 4:
        np.testing.assert_allclose(ip.box_blur(f, k), cv2.blur(f, (k, k)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,w", [(224, 224), (64, 64), (100, 60), (224, 230), (37, 51),
                                 (17, 17), (60, 60)])
def test_clahe_matches_cv2(h, w):
    """Sizes 8 divides, does not divide on one side (cv2 pads a whole tile
    on the other), or on neither; noise, smooth and dark images."""
    cl = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    rng = np.random.default_rng(h * w)
    for img in (_image("noise", h, w, h), _image("smooth", h, w),
                (rng.random((h, w)) ** 4 * 80).astype(np.uint8)):
        np.testing.assert_array_equal(ip.clahe(img), cl.apply(img))


@pytest.fixture
def legacy_tree(tmp_path):
    """``tests/test_data.py::test_legacy_bssfp_lge_datasets``'s tree."""
    rng = np.random.default_rng(1234)
    for d in ("trainA", "trainAmask", "trainB"):
        (tmp_path / d).mkdir(parents=True)
    mask = np.zeros((64, 64), np.uint8)
    mask[10:20, 10:20] = 85
    mask[30:40, 30:40] = 212
    mask[50:60, 50:60] = 255
    for i in range(3):
        img = (rng.random((64, 64)) * 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / "trainA" / f"pat_1_bSSFP_{i}.png"), img)
        cv2.imwrite(str(tmp_path / "trainAmask" / f"pat_1_bSSFP_{i}.png"), mask)
        cv2.imwrite(str(tmp_path / "trainB" / f"pat_1_lge_{i}.png"), img)
        cv2.imwrite(str(tmp_path / "trainB" / f"pat_2_lge_{i}.png"), img)
    return tmp_path


def _same_items(got_ds, want_ds, indices):
    assert len(got_ds) == len(want_ds)
    for epoch in (0, 1):
        got_ds.set_epoch(epoch)
        want_ds.set_epoch(epoch)
        for i in indices:
            got, want = got_ds[i], want_ds[i]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if isinstance(w, str):
                    assert g == w
                elif w.dtype == np.int64:
                    assert g.dtype == np.int64
                    np.testing.assert_array_equal(g, w)
                else:
                    assert g.dtype == w.dtype and g.shape == w.shape
                    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("crop", [48, 80])
@pytest.mark.parametrize("aug", [False, True])
def test_bssfp_dataset_matches_jax(legacy_tree, crop, aug):
    """Centre crop (48) and the nearest resize up (80), every augmentation
    draw of (seed, epoch, index), the mask remap."""
    kw = dict(crop=crop, augmentation=aug, seed=3)
    _same_items(legacy.BSSFPDataset(str(legacy_tree), **kw),
                j_legacy.BSSFPDataset(str(legacy_tree), **kw), range(3))
    kw["length"] = 10
    _same_items(legacy.BSSFPDataset(str(legacy_tree), **kw),
                j_legacy.BSSFPDataset(str(legacy_tree), **kw), (7, 9))


@pytest.mark.parametrize("mode", ["fewshot", "fulldata", "oneshot"])
@pytest.mark.parametrize("aug", [False, True])
def test_lge_dataset_matches_jax(legacy_tree, mode, aug):
    kw = dict(crop=48, pat_id=1, mode=mode, augmentation=aug, seed=11)
    if mode != "oneshot":
        kw["virtual_len"] = 7
    got, want = legacy.LGEDataset(str(legacy_tree), **kw), j_legacy.LGEDataset(
        str(legacy_tree), **kw)
    assert got.items == want.items
    _same_items(got, want, range(len(want)))
    if mode == "fewshot" and not aug:
        assert len(legacy.LGEDataset(str(legacy_tree))) == legacy.LGE_VIRTUAL_LEN


# seeds whose draws together run each of the six ops, the three blurs and
# both dropouts (6: pixel, 15: coarse)
LGE_SEEDS = (0, 1, 3, 5, 6, 15, 42)


def test_lge_heavy_aug_matches_jax_through_every_op(monkeypatch):
    ran = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            ran.setdefault(seed, set()).add(name)
            return fn(*a, **k)
        return wrapped

    for name in ("_elastic", "_piecewise", "_perspective", "_noise", "_dropout"):
        monkeypatch.setattr(legacy, name, spy(name, getattr(legacy, name)))
    for name in ("gaussian_blur", "box_blur", "median_blur", "resize_nearest"):
        monkeypatch.setattr(ip, name, spy(name, getattr(ip, name)))
    img = np.random.default_rng(0).random((48, 48)).astype(np.float32) * 255
    for seed in LGE_SEEDS:
        got = legacy.lge_heavy_aug(img, np.random.default_rng(seed))
        want = j_legacy.lge_heavy_aug(img, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got / 255, want / 255, rtol=0, atol=ATOL)
    seen = set().union(*ran.values())
    assert seen == {"_elastic", "_piecewise", "_perspective", "_noise", "_dropout",
                    "gaussian_blur", "box_blur", "median_blur", "resize_nearest"}
    assert any("_dropout" in r and "resize_nearest" not in r for r in ran.values())
