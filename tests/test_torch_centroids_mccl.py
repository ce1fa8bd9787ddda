"""Port parity for MCCL's centroid and loss functions: the same numpy inputs
through ``slcl_tpu.ops`` (jnp, ``jax.grad``) and ``slcl_torch.ops`` (the
plain versions that CPU tensors take; autograd).

- ``source_centroids``: masked class means with ``counts + 1e-7``, alone,
  as an EMA of ``previous``, and bootstrapped; labels nearest-resized when
  the feature grid is smaller.
- ``target_soft_centroids`` stddevs: values and the gradient of their sum
  with respect to features and probabilities, at P = 1 and 2, soft and hard
  weights, thd 0 and 0.6, with JAX's own rMC draw passed to the port.
- ``centroid_contrastive_loss`` over ``bg`` x ``split``, and with ``tau``;
  an all-zero centroid keeps a finite gradient.
- ``seg_pseudo_loss``: values and gradients.

Tolerances are those of tests/test_pallas.py for the centroids: values
rtol 1e-4 / atol 1e-5, gradients rtol 2e-3 (atol 1e-6: gradients of a sum
over M = 2048 rows are ~1e-4 per element). The losses are the same f32
formulas: rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.ops import centroids as tcen
from slcl_torch.ops import losses as tL
from slcl_tpu.ops import centroids as cen
from slcl_tpu.ops import losses as L

torch.set_num_threads(1)

N, H, W, F, C = 2, 32, 32, 8, 4


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("mode", ["plain", "ema", "bootstrap", "resized"])
def test_source_centroids_match_jnp(rng, mode):
    feats = rng.normal(size=(N, H, W, F)).astype(np.float32)
    size = (2 * H, 2 * W) if mode == "resized" else (H, W)
    labels = rng.integers(0, C, size=(N, *size)).astype(np.int32)
    labels[labels == 2] = 1            # class 2 absent: a zero mean, no fallback
    prev = rng.normal(size=(C, F)).astype(np.float32)
    kw = {} if mode in ("plain", "resized") else {"previous": prev, "momentum": 0.9}
    boot = {"bootstrap": True} if mode == "bootstrap" else {}
    want = cen.source_centroids(jnp.asarray(feats), jnp.asarray(labels), num_classes=C,
                                **{k: jnp.asarray(v) if k == "previous" else v
                                   for k, v in kw.items()},
                                **({"bootstrap": jnp.asarray(True)} if boot else {}))
    got = tcen.source_centroids(_t(feats), _t(labels), num_classes=C,
                                **{k: _t(v) if k == "previous" else v for k, v in kw.items()},
                                **boot)
    assert got.dtype == torch.float32 and tuple(got.shape) == (C, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    if mode == "ema":
        assert np.allclose(got.numpy()[2], 0.9 * prev[2])
    else:
        assert not got.numpy()[2].any()


def _jax_draw(P, m, seed=11):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (m,), 0, P), np.int32)


@pytest.mark.parametrize("thd", [0.0, 0.6])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("P", [1, 2])
def test_stddevs_and_their_gradient_match_jnp(rng, P, weighted, thd):
    feats = rng.normal(size=(N, H, W, F)).astype(np.float32)
    logits = 2.0 * rng.normal(size=(N, H, W, C)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.astype(np.float32)
    assign = _jax_draw(P, N * H * W)
    key = jax.random.PRNGKey(11)

    def jax_std(f, p):
        res = cen.target_soft_centroids(f, p, partition=P, rng=key if P > 1 else None,
                                        threshold=thd, weighted_ave=weighted, num_classes=C)
        return jnp.sum(res.stddevs), res

    (_, want), grads = jax.value_and_grad(jax_std, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(probs))

    f_t, p_t = _t(feats, True), _t(probs, True)
    got = tcen.target_soft_centroids(f_t, p_t, partition=P,
                                     assign=_t(assign) if P > 1 else None, threshold=thd,
                                     weighted_ave=weighted, num_classes=C, with_std=True)
    np.testing.assert_allclose(got.centroids.detach().numpy(), np.asarray(want.centroids),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.stddevs.detach().numpy(), np.asarray(want.stddevs),
                               rtol=1e-4, atol=1e-5)
    g_f, g_p = torch.autograd.grad(got.stddevs.sum(), [f_t, p_t], allow_unused=True)
    np.testing.assert_allclose(g_f.numpy(), np.asarray(grads[0]), rtol=2e-3, atol=1e-6)
    if weighted:
        np.testing.assert_allclose(g_p.numpy(), np.asarray(grads[1]), rtol=2e-3, atol=1e-6)
    else:
        assert g_p is None or not g_p.any()
    # without with_std the result has none, and the centroids are the same
    plain = tcen.target_soft_centroids(_t(feats), _t(probs), partition=P,
                                       assign=_t(assign) if P > 1 else None, threshold=thd,
                                       weighted_ave=weighted, num_classes=C)
    assert plain.stddevs is None
    assert torch.equal(plain.centroids, got.centroids.detach())


@pytest.mark.parametrize("bg,split,tau", [(False, False, None), (False, True, None),
                                          (True, False, None), (True, True, None),
                                          (False, False, 0.1)])
def test_centroid_contrastive_loss_matches_jnp(rng, bg, split, tau):
    s = rng.normal(size=(C, F)).astype(np.float32)
    t = rng.normal(size=(C, F)).astype(np.float32)
    t[3] = 0.0          # a class with no confident pixel: an all-zero centroid

    def jax_loss(a, b):
        return L.centroid_contrastive_loss(a, b, bg=bg, split=split, tau=tau)

    want, (gs, gt) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(s),
                                                                   jnp.asarray(t))
    s_t, t_t = _t(s, True), _t(t, True)
    got = tL.centroid_contrastive_loss(s_t, t_t, bg=bg, split=split, tau=tau)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    got_s, got_t = torch.autograd.grad(got, [s_t, t_t])
    assert torch.isfinite(got_t).all()
    np.testing.assert_allclose(got_s.numpy(), np.asarray(gs), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(gt), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("thd", [0.0, 0.5])
def test_seg_pseudo_loss_matches_jnp(rng, thd):
    logits = 2.0 * rng.normal(size=(N, H, W, C)).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    want, g = jax.value_and_grad(lambda p: L.seg_pseudo_loss(p, thd, C))(jnp.asarray(probs))
    p_t = _t(probs, True)
    got = tL.seg_pseudo_loss(p_t, thd, C)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    (g_t,) = torch.autograd.grad(got, [p_t])
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7)
