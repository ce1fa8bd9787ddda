"""Port parity for the main-path losses and the EMA class centres: value and
gradient of ``slcl_torch.ops.losses`` / ``ops.centroids`` against the jnp
functions on shared inputs.

Tolerance rtol 1e-5 / atol 1e-6 throughout: the same f32 formulas,
reduced in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.ops import centroids as tcen
from slcl_torch.ops import losses as TL
from slcl_torch.parallel.spatial import resize_labels
from slcl_tpu.ops import centroids as cen
from slcl_tpu.ops import losses as L

torch.set_num_threads(1)

B, H, W, C = 2, 12, 10, 4
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def seg_data(rng):
    logits = rng.normal(size=(B, H, W, C)).astype(np.float32) * 2
    labels = rng.integers(0, C, size=(B, H, W)).astype(np.int32)
    return logits, labels


def _both(fn_t, fn_j, x, *args):
    """Value and gradient wrt ``x`` of the port's and jnp's function."""
    xt = torch.from_numpy(x).requires_grad_(True)
    vt = fn_t(xt, *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in args])
    (gt,) = torch.autograd.grad(vt, xt)
    vj, gj = jax.value_and_grad(lambda z: fn_j(z, *[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))(jnp.asarray(x))
    return (float(vt.detach()), gt.numpy()), (float(vj), np.asarray(gj))


@pytest.mark.parametrize("name", ["cross_entropy_loss", "jaccard_loss", "dice_loss",
                                  "loss_calc", "loss_calc_jaccard"])
def test_segmentation_losses(seg_data, name):
    logits, labels = seg_data
    if name == "loss_calc_jaccard":
        ft, fj = (lambda x, y: TL.loss_calc(x, y, jaccard=True),
                  lambda x, y: L.loss_calc(x, y, jaccard=True))
    else:
        ft, fj = getattr(TL, name), getattr(L, name)
    (vt, gt), (vj, gj) = _both(ft, fj, logits, labels)
    assert vt == pytest.approx(vj, rel=RTOL, abs=ATOL)
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_adversarial_terms(seg_data, target):
    logits, _ = seg_data

    def ft(x):
        return TL.bce_with_logits(TL.prob_2_entropy(torch.softmax(x, -1)), target)

    def fj(x):
        return L.bce_with_logits(L.prob_2_entropy(jax.nn.softmax(x, -1)), target)
    (vt, gt), (vj, gj) = _both(ft, fj, logits)
    assert vt == pytest.approx(vj, rel=RTOL, abs=ATOL)
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)


def test_cnr_loss_with_an_empty_class(rng):
    cs = rng.normal(size=(C, 8)).astype(np.float32)
    ct = rng.normal(size=(C, 8)).astype(np.float32)
    ct[2] = 0.0      # a class with no confident pixels: finite gradient
    (vt, gt), (vj, gj) = _both(lambda t, s: TL.cnr_loss(s, t),
                               lambda t, s: L.cnr_loss(s, t), ct, cs)
    assert np.isfinite(gt).all()
    assert vt == pytest.approx(vj, rel=RTOL, abs=ATOL)
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bootstrap", [None, True, False])
def test_update_class_center_iter(rng, bootstrap):
    feats = rng.normal(size=(B, H, W, 8)).astype(np.float32)
    labels = rng.integers(0, C - 1, size=(B, H, W)).astype(np.int32)  # class 3 absent
    prev = rng.normal(size=(C, 8)).astype(np.float32)
    got = tcen.update_class_center_iter(
        torch.from_numpy(feats), torch.from_numpy(labels), torch.from_numpy(prev),
        momentum=0.9, num_classes=C, bootstrap=bootstrap)
    want = cen.update_class_center_iter(
        jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(prev), momentum=0.9,
        num_classes=C, bootstrap=None if bootstrap is None else jnp.asarray(bootstrap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the absent class keeps its centre (0.9 * prev + 0.1 * prev)
    np.testing.assert_allclose(got.numpy()[3], prev[3], rtol=RTOL, atol=ATOL)


def test_nearest_resize_labels(rng):
    labels = rng.integers(0, C, size=(B, 16, 16)).astype(np.int32)
    for size in ((8, 8), (32, 32), (12, 20)):
        got = resize_labels(torch.from_numpy(labels), size)
        want = L.nearest_resize_labels(jnp.asarray(labels), size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
