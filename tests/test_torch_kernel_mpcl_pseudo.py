"""Port parity: the plain PyTorch version of the fused target-branch kernel
(``slcl_torch.ops.cuda.mpcl_pseudo.mpcl_pseudo_plain``) against the Pallas
kernel (``mpcl_pseudo_fused``, interpret mode) and against the jnp two-op
composition it fuses (``generate_pseudo_label`` then ``mpcl_loss_calc``),
in value and feature gradient.

Tolerances are those of tests/test_pallas.py's fused-kernel test: value
rel 1e-4, gradient rtol 1e-3 / atol 1e-6. M = 2500 is not a multiple of
any tile. The widths F = 16 and F = 64 are held as F = 32 is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slcl_torch.ops import losses as TL
from slcl_torch.ops.cuda.mpcl_pseudo import mpcl_pseudo, mpcl_pseudo_plain
from slcl_tpu.ops import centroids as cen
from slcl_tpu.ops import losses as L
from slcl_tpu.ops.pallas import mpcl_pseudo_fused

torch.set_num_threads(1)

M, F, C = 2500, 32, 4
T, BASE_T, MARGIN, TH = 0.1, 1.0, 0.2, 0.25


@pytest.fixture
def data(rng):
    feats = rng.normal(size=(M, F)).astype(np.float32)
    centers = rng.normal(size=(C, F)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return feats, centers


def _port(feats, centers, easy, th):
    x = torch.from_numpy(feats).requires_grad_(True)
    loss = mpcl_pseudo_plain(x, torch.from_numpy(centers), temperature=T,
                             base_temperature=BASE_T, margin=MARGIN, easy_margin=easy,
                             pixel_sel_th=th)
    (g,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), g.numpy()


def _jnp(feats, centers, easy, th):
    def f(x):
        x4 = x.reshape(1, 50, 50, feats.shape[1])
        lab, sel = cen.generate_pseudo_label(x4, jnp.asarray(centers), pixel_sel_th=th)
        return L.mpcl_loss_calc(x4, lab, jnp.asarray(centers), temperature=T,
                                base_temperature=BASE_T, margin=MARGIN,
                                easy_margin=easy, pixel_sel_loc=sel,
                                resize_labels=False)
    v, g = jax.value_and_grad(f)(jnp.asarray(feats))
    return float(v), np.asarray(g)


def _pallas(feats, centers, easy, th):
    def f(x):
        return mpcl_pseudo_fused(x, jnp.asarray(centers), T, BASE_T, MARGIN, easy, th)
    with pltpu.force_tpu_interpret_mode():
        v, g = jax.value_and_grad(f)(jnp.asarray(feats))
    return float(v), np.asarray(g)


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("easy", [False, True])
def test_mpcl_pseudo_plain_matches_reference(data, reference, easy):
    feats, centers = data
    got_v, got_g = _port(feats, centers, easy, TH)
    ref = _jnp if reference == "jnp" else _pallas
    want_v, want_g = ref(feats, centers, easy, TH)
    assert got_v != 0.0
    assert got_v == pytest.approx(want_v, rel=1e-4)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("f", [16, 64])
def test_mpcl_pseudo_plain_other_widths_match_reference(rng, reference, f):
    feats = rng.normal(size=(M, f)).astype(np.float32)
    centers = rng.normal(size=(C, f)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    got_v, got_g = _port(feats, centers, False, TH)
    want_v, want_g = (_jnp if reference == "jnp" else _pallas)(feats, centers, False, TH)
    assert got_v != 0.0
    assert got_v == pytest.approx(want_v, rel=1e-4)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_threshold_that_masks_every_row_gives_zero(data, reference):
    """No row passes the gap test: den is 1e-4 alone, loss and gradient 0."""
    feats, centers = data
    got_v, got_g = _port(feats, centers, False, 2.0)
    ref = _jnp if reference == "jnp" else _pallas
    want_v, want_g = ref(feats, centers, False, 2.0)
    assert got_v == 0.0 and want_v == 0.0
    assert not got_g.any() and not np.asarray(want_g).any()


def test_mpcl_pseudo_loss_nhwc_and_unnormalised_centres(data):
    """The NHWC wrapper normalises raw centres as the jnp two-op route does."""
    feats, centers = data
    raw = centers * np.arange(1, C + 1, dtype=np.float32)[:, None]
    x = torch.from_numpy(feats.reshape(1, 50, 50, F)).requires_grad_(True)
    got = TL.mpcl_pseudo_loss(x, torch.from_numpy(raw), temperature=T, margin=MARGIN,
                              pixel_sel_th=TH)
    (g,) = torch.autograd.grad(got, x)

    def f(xj):
        lab, sel = cen.generate_pseudo_label(xj, jnp.asarray(raw), pixel_sel_th=TH)
        return L.mpcl_loss_calc(xj, lab, jnp.asarray(raw), temperature=T, margin=MARGIN,
                                pixel_sel_loc=sel, resize_labels=False)
    want, gw = jax.value_and_grad(f)(jnp.asarray(feats.reshape(1, 50, 50, F)))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=1e-3, atol=1e-6)


def test_mpcl_pseudo_wrapper_uses_plain_version_on_cpu(data):
    feats, centers = data
    args = (torch.from_numpy(feats), torch.from_numpy(centers))
    kw = dict(temperature=T, base_temperature=BASE_T, margin=MARGIN, pixel_sel_th=TH)
    assert torch.equal(mpcl_pseudo(*args, **kw), mpcl_pseudo_plain(*args, **kw))
