"""Port parity: the plain PyTorch version of the MPCL kernel
(``slcl_torch.ops.cuda.mpcl.mpcl_plain``) against the jnp function
(``losses.mpcl_loss_calc``) and against the Pallas kernel
(``mpcl_loss_fused``, interpret mode), in value and feature gradient.

Tolerances are those of tests/test_pallas.py: value rel 1e-4, gradient
rtol 2e-3. M = 2500 is not a multiple of any tile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slcl_torch.ops import losses as TL
from slcl_torch.ops.cuda.mpcl import mpcl, mpcl_plain
from slcl_tpu.ops import losses as L
from slcl_tpu.ops.pallas import mpcl_loss_fused

torch.set_num_threads(1)

M, F, C = 2500, 32, 4
T, BASE_T, MARGIN = 0.1, 1.0, 0.4


@pytest.fixture
def data(rng):
    feats = rng.normal(size=(M, F)).astype(np.float32)
    labels = rng.integers(0, C, size=(M,)).astype(np.int32)
    centers = rng.normal(size=(C, F)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    sel = rng.integers(0, 2, size=(M,)).astype(np.float32)
    return feats, labels, centers, sel


def _port(feats, labels, centers, sel, easy):
    x = torch.from_numpy(feats).requires_grad_(True)
    loss = mpcl_plain(x, torch.from_numpy(labels), torch.from_numpy(centers),
                      None if sel is None else torch.from_numpy(sel),
                      temperature=T, base_temperature=BASE_T, margin=MARGIN,
                      easy_margin=easy)
    (g,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), g.numpy()


def _jnp(feats, labels, centers, sel, easy):
    def f(x):
        return L.mpcl_loss_calc(x.reshape(1, 50, 50, F), jnp.asarray(labels),
                                jnp.asarray(centers), temperature=T,
                                base_temperature=BASE_T, margin=MARGIN,
                                easy_margin=easy,
                                pixel_sel_loc=None if sel is None else jnp.asarray(sel),
                                resize_labels=False)
    v, g = jax.value_and_grad(f)(jnp.asarray(feats))
    return float(v), np.asarray(g)


def _pallas(feats, labels, centers, sel, easy):
    def f(x):
        return mpcl_loss_fused(x, jnp.asarray(labels), jnp.asarray(centers), T,
                               BASE_T, MARGIN, easy, sel is not None,
                               None if sel is None else jnp.asarray(sel))
    with pltpu.force_tpu_interpret_mode():
        v, g = jax.value_and_grad(f)(jnp.asarray(feats))
    return float(v), np.asarray(g)


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("easy", [False, True])
@pytest.mark.parametrize("use_sel", [False, True])
def test_mpcl_plain_matches_reference(data, reference, easy, use_sel):
    feats, labels, centers, sel = data
    sel = sel if use_sel else None
    got_v, got_g = _port(feats, labels, centers, sel, easy)
    ref = _jnp if reference == "jnp" else _pallas
    want_v, want_g = ref(feats, labels, centers, sel, easy)
    assert got_v == pytest.approx(want_v, rel=1e-4)
    np.testing.assert_allclose(got_g, want_g, rtol=2e-3, atol=1e-7)


def test_mpcl_loss_calc_nhwc_and_unnormalised_centres(data):
    """The NHWC wrapper normalises the centres as jnp does (raw centres in)."""
    feats, labels, centers, sel = data
    raw = centers * np.arange(1, C + 1, dtype=np.float32)[:, None]
    x = torch.from_numpy(feats.reshape(1, 50, 50, F)).requires_grad_(True)
    got = TL.mpcl_loss_calc(x, torch.from_numpy(labels), torch.from_numpy(raw),
                            temperature=T, margin=0.2,
                            pixel_sel_loc=torch.from_numpy(sel), resize_labels=False)
    (g,) = torch.autograd.grad(got, x)

    def f(xj):
        return L.mpcl_loss_calc(xj, jnp.asarray(labels), jnp.asarray(raw),
                                temperature=T, margin=0.2,
                                pixel_sel_loc=jnp.asarray(sel), resize_labels=False)
    want, gw = jax.value_and_grad(f)(jnp.asarray(feats.reshape(1, 50, 50, F)))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=2e-3, atol=1e-7)


def test_mpcl_wrapper_uses_plain_version_on_cpu(data):
    feats, labels, centers, sel = data
    args = (torch.from_numpy(feats), torch.from_numpy(labels),
            torch.from_numpy(centers), torch.from_numpy(sel))
    kw = dict(temperature=T, base_temperature=BASE_T, margin=MARGIN)
    assert torch.equal(mpcl(*args, **kw), mpcl_plain(*args, **kw))
