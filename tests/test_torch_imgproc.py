"""The port's image operations (``slcl_torch.data.imgproc``, numpy) against
OpenCV on random inputs from numpy seeds, at 224x224 and at a ragged 61x97.

Tolerances: warps, remaps and the cubic resize within atol 1e-4 (linear
interpolation of unit-range noise; measured up to 3.5e-5, the perspective
warp's, whose matrix the port solves by LAPACK, not by cv2's own LU);
the filters within atol 1e-5 (float32 sums in another order; measured
1.4e-6). Nearest-neighbour lookups equal cv2's except where a source
coordinate lies within 1e-3 px of a rounding tie, on at most 1e-4 of the
pixels (measured: none for the affine warp and remap, 4e-5 for the
perspective warp).
"""
import cv2
import numpy as np
import pytest

from slcl_torch.data import imgproc as ip

SHAPES = [(224, 224), (61, 97)]
ATOL_WARP = 1e-4
ATOL_FILTER = 1e-5


def _image(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _mask(seed, shape, dtype):
    return np.random.default_rng(seed + 1).integers(0, 4, shape).astype(dtype)


def _affine(rng, h, w, reach):
    """A rotation about the centre with a scale, translated by up to
    ``reach`` of the size (far outside the image at 0.6)."""
    M = cv2.getRotationMatrix2D((w / 2, h / 2), float(rng.integers(-30, 30)),
                                float(rng.uniform(0.7, 1.3)))
    M[0, 2] += rng.uniform(-reach, reach) * w
    M[1, 2] += rng.uniform(-reach, reach) * h
    return M


def _assert_nearest(got, want, map_x, map_y):
    """Equal, except at source coordinates within 1e-3 px of a rounding
    tie, on at most 1e-4 of the pixels."""
    bad = got != want
    assert bad.mean() <= 1e-4, bad.mean()
    tie = np.minimum(np.abs(map_x - np.floor(map_x) - 0.5),
                     np.abs(map_y - np.floor(map_y) - 0.5))
    assert (tie[bad] < 1e-3).all(), tie[bad]


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("shape", SHAPES)
def test_copy_make_border_and_flip(shape, dtype):
    img = (_image(0, shape) * 255).astype(dtype)
    value = float(img.min()) + 3
    for pads in [(0, 0, 0, 0), (3, 4, 5, 6), (81, 0, 0, 127)]:
        want = cv2.copyMakeBorder(img, *pads, cv2.BORDER_CONSTANT, value=value)
        got = ip.copy_make_border(img, *pads, value)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for code in (0, 1, -1):
        got = ip.flip(img, code)
        assert got.flags.c_contiguous
        np.testing.assert_array_equal(got, cv2.flip(img, code))


@pytest.mark.parametrize("angle,scale", [(0, 1.0), (-15, 0.9), (14, 1.1), (7, 0.8),
                                         (-90, 1.2), (33.5, 1.0)])
def test_rotation_matrix(angle, scale):
    center = (97 / 2, 61 / 2)
    np.testing.assert_array_equal(ip.get_rotation_matrix_2d(center, angle, scale),
                                  cv2.getRotationMatrix2D(center, angle, scale))
    M = cv2.getRotationMatrix2D(center, angle, scale)
    M[0, 2] += 11.25
    np.testing.assert_allclose(ip.invert_affine(M), cv2.invertAffineTransform(M),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_warp_affine(shape, seed):
    h, w = shape
    rng = np.random.default_rng(100 + seed)
    img = _image(seed, shape)
    for reach in (0.1, 0.6):
        M = _affine(rng, h, w, reach)
        border = float(img.min())
        want = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=border)
        got = ip.warp_affine(img, M, (w, h), "linear", border)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_WARP)
        maps = ip.affine_map(M, (w, h))
        for dtype in (np.uint8, np.float32):
            mask = _mask(seed, shape, dtype)
            want = cv2.warpAffine(mask, M, (w, h), flags=cv2.INTER_NEAREST,
                                  borderMode=cv2.BORDER_CONSTANT, borderValue=0)
            got = ip.warp_affine(mask, M, (w, h), "nearest", 0)
            assert got.dtype == dtype
            _assert_nearest(got, want, *maps)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_warp_perspective(shape, seed):
    h, w = shape
    rng = np.random.default_rng(200 + seed)
    img = _image(seed, shape)
    frame = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    inward = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    for jitter in (0.05, 0.2):
        jit = np.abs(rng.normal(0, jitter, (4, 2))).astype(np.float32)
        src = frame + inward * jit * np.array([w, h], np.float32)
        P = ip.get_perspective_transform(src, frame)
        np.testing.assert_allclose(P, cv2.getPerspectiveTransform(src, frame),
                                   rtol=1e-7, atol=1e-10)
        border = float(img.min())
        want = cv2.warpPerspective(img, P, (w, h), flags=cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_CONSTANT, borderValue=border)
        got = ip.warp_perspective(img, P, (w, h), "linear", border)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_WARP)
        mask = _mask(seed, shape, np.float32)
        want = cv2.warpPerspective(mask, P, (w, h), flags=cv2.INTER_NEAREST,
                                   borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        _assert_nearest(ip.warp_perspective(mask, P, (w, h), "nearest", 0.0), want,
                        *ip.perspective_map(P, (w, h)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_remap(shape, seed):
    """Displacements up to tens of pixels (far outside at the edges), one
    coordinate in ten on an exact half: nearest rounds half to even."""
    h, w = shape
    rng = np.random.default_rng(300 + seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    map_x = (xx + rng.normal(0, 12, shape)).astype(np.float32)
    map_y = (yy + rng.normal(0, 12, shape)).astype(np.float32)
    half = rng.random(shape) < 0.1
    map_x[half] = np.floor(map_x[half]) + 0.5
    map_y[~half] = np.floor(map_y[~half]) + 0.5
    img = _image(seed, shape)
    border = float(img.min())
    want = cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=border)
    np.testing.assert_allclose(ip.remap(img, map_x, map_y, "linear", border), want,
                               rtol=0, atol=ATOL_WARP)
    for src in (img, _mask(seed, shape, np.float32)):
        want = cv2.remap(src, map_x, map_y, cv2.INTER_NEAREST,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
        np.testing.assert_array_equal(ip.remap(src, map_x, map_y, "nearest", 0.0), want)
    with pytest.raises(TypeError):
        ip.remap(_mask(seed, shape, np.uint8), map_x, map_y, "linear", 0)


@pytest.mark.parametrize("grid", [3, 4, 7])
@pytest.mark.parametrize("shape", SHAPES)
def test_resize_cubic(shape, grid):
    """The displacement fields of ``elastic_deform`` (3x3) and
    ``piecewise_affine`` (4x4) densified to the image size."""
    h, w = shape
    g = np.random.default_rng(grid).normal(0, 7, (grid, grid)).astype(np.float32)
    want = cv2.resize(g, (w, h), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(ip.resize_cubic(g, (w, h)), want, rtol=0,
                               atol=ATOL_WARP)


@pytest.mark.parametrize("ksize,sigma", [(5, 0.06), (5, 0.25), (5, 0.5), (5, 0.8),
                                         (5, 1.0), (3, 1.0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_blur(shape, ksize, sigma):
    """``heavy_aug``'s 5x5 blur at the sigmas it draws (0.05-1.0) and
    ``_sharpen``'s 3x3 at 1.0."""
    img = _image(7, shape)
    np.testing.assert_allclose(
        ip.gaussian_kernel(ksize, sigma)[:, None],
        cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F), rtol=0, atol=1e-7)
    want = cv2.GaussianBlur(img, (ksize, ksize), sigma)
    np.testing.assert_allclose(ip.gaussian_blur(img, ksize, sigma), want, rtol=0,
                               atol=ATOL_FILTER)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_filter2d_and_sobel(shape, seed):
    """``_emboss``'s and ``_edge_detect``'s kernels (and a random 3x3), and
    both Sobel derivatives."""
    img = _image(seed, shape)
    s = np.random.default_rng(seed).uniform(0, 2)
    kernels = [np.array([[-s, -s, 0], [-s, 1, s], [0, s, s]], np.float32),
               np.array([[0, 0, 0], [0, -1, 1], [0, 0, 0]], np.float32),
               np.random.default_rng(seed).normal(0, 1, (3, 3)).astype(np.float32)]
    for k in kernels:
        np.testing.assert_allclose(ip.filter2d(img, k), cv2.filter2D(img, -1, k),
                                   rtol=0, atol=ATOL_FILTER)
    for dx, dy in ((1, 0), (0, 1)):
        np.testing.assert_allclose(ip.sobel(img, dx, dy),
                                   cv2.Sobel(img, cv2.CV_32F, dx, dy), rtol=0,
                                   atol=ATOL_FILTER)
