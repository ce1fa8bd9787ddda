"""The losses no step calls (``supcon_loss``, ``local_con_loss``,
``block_con_loss``, ``interpolated_supcon_loss``,
``softmax_cross_entropy_soft``; ``slcl_tpu/ops/losses.py:335-429,500-503``)
against jnp: value and gradient with respect to the features (logits),
rtol 1e-5 / atol 1e-6, the same f32 formulas reduced in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.ops import losses as TL
from slcl_tpu.ops import losses as L

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _both(fn_t, fn_j, x, *args):
    xt = torch.from_numpy(x).requires_grad_(True)
    vt = fn_t(xt, *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    (gt,) = torch.autograd.grad(vt, xt)
    vj, gj = jax.value_and_grad(lambda z: fn_j(z, *[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))(jnp.asarray(x))
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("name", ["supcon_loss", "local_con_loss", "block_con_loss"])
def test_pixel_contrastive_losses(rng, name, with_labels):
    feats = _unit(rng.normal(size=(2, 2, 8, 8, 6))).astype(np.float32)
    labels = rng.integers(0, 3, size=(2, 2, 8, 8)).astype(np.int32)
    kw = {"supcon_loss": {"temperature": 0.5}, "local_con_loss": {"stride": 2},
          "block_con_loss": {"block_size": 4}}[name]
    args = (labels,) if with_labels else ()
    _both(lambda x, *a: getattr(TL, name)(x, *a, **kw),
          lambda x, *a: getattr(L, name)(x, *a, **kw), feats, *args)


def test_block_con_loss_without_labelled_tiles(rng):
    feats = _unit(rng.normal(size=(1, 2, 8, 8, 6))).astype(np.float32)
    labels = np.zeros((1, 2, 8, 8), np.int32)
    labels[:, :, :4, :4] = 1
    _both(lambda x, y: TL.block_con_loss(x, y, block_size=4),
          lambda x, y: L.block_con_loss(x, y, block_size=4), feats, labels)
    zero = np.zeros_like(labels)
    got = TL.block_con_loss(torch.from_numpy(feats), torch.from_numpy(zero), block_size=4)
    assert float(got) == 0.0


@pytest.mark.parametrize("lam", [0.0, 0.3, 1.0])
def test_interpolated_supcon_loss(rng, lam):
    feats = _unit(rng.normal(size=(40, 8))).astype(np.float32)
    la = rng.integers(0, 4, size=(40,)).astype(np.int32)
    lb = rng.integers(0, 4, size=(40,)).astype(np.int32)
    _both(lambda x, a, b: TL.interpolated_supcon_loss(x, a, b, lam, temperature=0.2),
          lambda x, a, b: L.interpolated_supcon_loss(x, a, b, lam, temperature=0.2),
          feats, la, lb)


def test_softmax_cross_entropy_soft(rng):
    logits = (rng.normal(size=(2, 6, 5, 4)) * 2).astype(np.float32)
    soft = rng.random(size=(2, 6, 5, 4)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    _both(TL.softmax_cross_entropy_soft, L.softmax_cross_entropy_soft, logits, soft)
