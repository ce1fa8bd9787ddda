"""Port parity: the plain PyTorch versions of the pseudo-label and
soft-centroid kernels, through ``slcl_torch.ops.centroids``, against the
jnp functions (``generate_pseudo_label``, ``target_soft_centroids`` with
``jax.grad``) and the Pallas kernels (``pseudo_label_fused``,
``soft_centroids_fused``; interpret mode, forward only — the Pallas
centroid kernel has no backward).

Tolerances are those of tests/test_pallas.py: centroids rtol 1e-4 / atol
1e-5, ratio rel 1e-5; gradients rtol 2e-3. Pseudo-labels and masks are
exact except on rows whose top1-top2 gap lies within 1e-6 of a tie or of
the threshold; with this seed there are 0 such rows, and the test asserts
that every differing row is one of them. M = 2500 is not a multiple of any
tile. The centroid version and its autograd backward are also held at
F = 16, 32 and 64 with an odd M (2491 = 47 * 53, so the rows past the last
whole group of four, whose ids the backward kernel reads from memory, are
there at P = 2, soft weights and thd 0 and 0.4), and with partition ids
outside [0, P): the Pallas kernel gives such rows no weight and counts them
in the ratio, as the port does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slcl_torch.ops import centroids as tcen
from slcl_torch.ops.cuda.pseudo_label import pseudo_label, pseudo_label_plain
from slcl_tpu.ops import centroids as cen
from slcl_tpu.ops.pallas import pseudo_label_fused, soft_centroids_fused

torch.set_num_threads(1)

M, F, C = 2500, 32, 4
TH = 0.25


@pytest.fixture
def data(rng):
    feats = rng.normal(size=(M, F)).astype(np.float32)
    centers = rng.normal(size=(C, F)).astype(np.float32)
    logits = rng.normal(size=(M, C)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    dcents = rng.normal(size=(2, C, F)).astype(np.float32)
    return feats, centers, probs.astype(np.float32), dcents


def _near_tie_rows(feats, centers):
    f = feats.astype(np.float64)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    c = centers.astype(np.float64)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    top = np.sort(f @ c.T, axis=1)
    gap = top[:, -1] - top[:, -2]
    return (np.abs(gap) < 1e-6) | (np.abs(gap - TH) < 1e-6)


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_pseudo_label_plain_matches_reference(data, reference):
    feats, centers, _, _ = data
    lab, mask = tcen.generate_pseudo_label(
        torch.from_numpy(feats.reshape(1, 50, 50, F)), torch.from_numpy(centers),
        pixel_sel_th=TH)
    assert lab.dtype == torch.int32 and lab.shape == (M,)
    if reference == "jnp":
        want_lab, want_mask = cen.generate_pseudo_label(
            jnp.asarray(feats.reshape(1, 50, 50, F)), jnp.asarray(centers),
            pixel_sel_th=TH)
    else:
        with pltpu.force_tpu_interpret_mode():
            want_lab, want_mask = pseudo_label_fused(jnp.asarray(feats),
                                                     jnp.asarray(centers), TH)
    near = _near_tie_rows(feats, centers)
    differ = ((lab.numpy() != np.asarray(want_lab))
              | (mask.numpy() != np.asarray(want_mask)))
    assert int(near.sum()) == 0
    assert not np.any(differ & ~near), f"{int(differ.sum())} rows differ"


def test_pseudo_label_wrapper_uses_plain_version_on_cpu(data):
    feats, centers, _, _ = data
    a = pseudo_label(torch.from_numpy(feats), torch.from_numpy(centers), TH)
    b = pseudo_label_plain(torch.from_numpy(feats), torch.from_numpy(centers), TH)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _assign(P):
    # the draw target_soft_centroids makes from its rng (centroids.py:124)
    return np.array(jax.random.randint(jax.random.PRNGKey(3), (M,), 0, P))


def _jnp_centroids(feats, probs, P, weighted, thd, dc):
    def f(x, p):
        res = cen.target_soft_centroids(
            x.reshape(1, 50, 50, F), p.reshape(1, 50, 50, C), partition=P,
            rng=jax.random.PRNGKey(3) if P > 1 else None, threshold=thd,
            weighted_ave=weighted, num_classes=C)
        return jnp.sum(res.centroids * dc), (res.centroids, res.ratio)
    (_, (cents, ratio)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(probs))
    return np.asarray(cents), float(ratio), np.asarray(gx), np.asarray(gp)


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("thd", [0.0, 0.4])
def test_soft_centroids_plain_matches_jnp_and_pallas(data, P, weighted, thd):
    feats, _, probs, dcents = data
    dc = dcents[:P]
    assign = _assign(P)
    x = torch.from_numpy(feats.reshape(1, 50, 50, F)).requires_grad_(True)
    p = torch.from_numpy(probs.reshape(1, 50, 50, C)).requires_grad_(True)
    res = tcen.target_soft_centroids(
        x, p, partition=P, assign=torch.from_numpy(assign) if P > 1 else None,
        threshold=thd, weighted_ave=weighted, num_classes=C)
    gx, gp = torch.autograd.grad((res.centroids * torch.from_numpy(dc)).sum(), [x, p],
                                 allow_unused=True)
    gp = torch.zeros_like(p) if gp is None else gp

    cents, ratio, want_gx, want_gp = _jnp_centroids(feats, probs, P, weighted, thd, dc)
    got = res.centroids.detach().numpy()
    np.testing.assert_allclose(got, cents, rtol=1e-4, atol=1e-5)
    assert float(res.ratio) == pytest.approx(ratio, rel=1e-5)
    np.testing.assert_allclose(gx.numpy().reshape(M, F), want_gx, rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(gp.numpy().reshape(M, C), want_gp, rtol=2e-3, atol=1e-7)

    with pltpu.force_tpu_interpret_mode():
        pc, pr = soft_centroids_fused(jnp.asarray(feats), jnp.asarray(probs),
                                      jnp.asarray(assign), partition=P,
                                      threshold=thd, weighted_ave=weighted,
                                      num_classes=C)
    np.testing.assert_allclose(got, np.asarray(pc), rtol=1e-4, atol=1e-5)
    assert float(res.ratio) == pytest.approx(float(pr), rel=1e-5)


H2, W2 = 47, 53   # M = 2491: odd, so no multiple of 4, of a warp's rows or of a tile


def _wide_data(rng, f):
    m = H2 * W2
    feats = rng.normal(size=(m, f)).astype(np.float32)
    logits = rng.normal(size=(m, C)).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    return feats, probs, rng.normal(size=(2, C, f)).astype(np.float32)


def _port_centroids(feats, probs, assign, P, weighted, thd, dc):
    f = feats.shape[1]
    x = torch.from_numpy(feats.reshape(1, H2, W2, f)).requires_grad_(True)
    p = torch.from_numpy(probs.reshape(1, H2, W2, C)).requires_grad_(True)
    res = tcen.target_soft_centroids(
        x, p, partition=P, assign=torch.from_numpy(assign) if P > 1 else None,
        threshold=thd, weighted_ave=weighted, num_classes=C)
    gx, gp = torch.autograd.grad((res.centroids * torch.from_numpy(dc)).sum(), [x, p],
                                 allow_unused=True)
    gp = torch.zeros_like(p) if gp is None else gp
    return (res.centroids.detach().numpy(), float(res.ratio),
            gx.numpy().reshape(-1, f), gp.numpy().reshape(-1, C))


def _check_other_width(rng, f, P, weighted, thd):
    feats, probs, dcents = _wide_data(rng, f)
    dc = dcents[:P]
    key = jax.random.PRNGKey(5)
    # the draw target_soft_centroids makes from its rng (centroids.py:124)
    assign = np.array(jax.random.randint(key, (H2 * W2,), 0, P))
    got, ratio, gx, gp = _port_centroids(feats, probs, assign, P, weighted, thd, dc)

    def fn(x, p):
        res = cen.target_soft_centroids(
            x.reshape(1, H2, W2, f), p.reshape(1, H2, W2, C), partition=P,
            rng=key if P > 1 else None, threshold=thd, weighted_ave=weighted,
            num_classes=C)
        return jnp.sum(res.centroids * dc), (res.centroids, res.ratio)
    (_, (cents, want_ratio)), (want_gx, want_gp) = jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True)(jnp.asarray(feats), jnp.asarray(probs))
    np.testing.assert_allclose(got, np.asarray(cents), rtol=1e-4, atol=1e-5)
    assert ratio == pytest.approx(float(want_ratio), rel=1e-5)
    np.testing.assert_allclose(gx, np.asarray(want_gx), rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(gp, np.asarray(want_gp), rtol=2e-3, atol=1e-7)


@pytest.mark.parametrize("f", [16, 32, 64])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("weighted", [True, False])
def test_soft_centroids_plain_other_widths_match_jnp(rng, f, P, weighted):
    _check_other_width(rng, f, P, weighted, 0.4)


@pytest.mark.parametrize("f", [16, 32, 64])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("weighted", [True, False])
def test_soft_centroids_plain_other_widths_without_threshold_match_jnp(rng, f, P, weighted):
    _check_other_width(rng, f, P, weighted, 0.0)


@pytest.mark.parametrize("f", [16, 64])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("thd", [0.0, 0.4])
def test_soft_centroids_plain_ids_out_of_range_match_pallas(rng, f, weighted, thd):
    """Rows whose partition id is -1 or P get no weight and count in the
    ratio, in the last three rows and elsewhere."""
    P = 2
    feats, probs, dcents = _wide_data(rng, f)
    assign = rng.integers(0, P, size=H2 * W2).astype(np.int32)
    assign[::101] = P
    assign[5::211] = -1
    assign[-3:] = (-1, P, -1)
    got, ratio, _, _ = _port_centroids(feats, probs, assign, P, weighted, thd, dcents)
    with pltpu.force_tpu_interpret_mode():
        pc, pr = soft_centroids_fused(jnp.asarray(feats), jnp.asarray(probs),
                                      jnp.asarray(assign), partition=P, threshold=thd,
                                      weighted_ave=weighted, num_classes=C)
    np.testing.assert_allclose(got, np.asarray(pc), rtol=1e-4, atol=1e-5)
    assert ratio == pytest.approx(float(pr), rel=1e-5)
    # the out-of-range rows are missing from the sums: with all ids in range
    # the centroids differ
    inside, _, _, _ = _port_centroids(feats, probs, np.clip(assign, 0, P - 1), P, weighted,
                                      thd, dcents)
    assert np.abs(inside - got).max() > 1e-4
