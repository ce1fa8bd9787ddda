"""Every batch-global reduction of the port's steps at W = 2 on the CPU over
gloo, in float64, against the one-process function on the global rows: the
losses' means and ratios (CE, Jaccard, Dice, CE with ignored pixels, the
entropies, the class-prior hinge's marginal, BCE, the seg-pseudo term, the
soft-target CE, MSE, Chamfer), MPCL with and without ``sel`` and the fused
target branch, the source centres and their EMA, the soft centroids with
one and two partitions, soft and hard weights, and the std variant (whose
streaming pass sums raw moments, sum w*x and sum w*x^2, so that one
all-reduce of them gives the global spread), and BatchNorm's training
moments and running statistics. Each rank's gradient of its share with
respect to its rows must be its rows of the one-process gradient.
Tolerance rtol 1e-5 (the inputs are float64, but the losses and centroids
cast to float32 as the steps do; gradients also atol 1e-6 of their
largest)."""
import numpy as np
import pytest
import torch
import torch_parallel_common as C

from slcl_torch.parallel.dryrun import spawn

torch.set_num_threads(1)
NAMES = ("cross_entropy", "jaccard", "dice", "ce_ignore", "entropy", "entropy_sum",
              "class_prior", "bce", "seg_pseudo", "soft_ce", "mse", "mpcl", "mpcl_sel",
              "mpcl_pseudo", "chamfer", "source_centroids", "soft_p1", "soft_p2",
              "soft_p2_std", "hard_p1_std", "ema_centres", "batchnorm", "bn_running")


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(5)
    n, h, w, c, f = 4, 6, 5, 4, 8
    plabel = rng.integers(0, c, size=(n, h, w)).astype(np.int64)
    plabel[:, ::2] = 255
    arrays = {"logits": rng.normal(size=(n, h, w, c)) * 2,
              "labels": rng.integers(0, c, size=(n, h, w)).astype(np.int64),
              "plabel": plabel,
              "feats": rng.normal(size=(n, h, w, f)) + 0.5,
              "assign": rng.integers(0, 2, size=(n, h, w)).astype(np.int64),
              "sel": (rng.random(size=(n, h, w)) > 0.4).astype(np.float64),
              "centers": rng.normal(size=(c, f)),
              "points": rng.normal(size=(n, 7, 3)), "verts": rng.normal(size=(n, 9, 3))}
    ranks = spawn(2, "ops_entry", (arrays,), module="torch_parallel_common")
    return ranks, C.ops_entry(None, arrays)


@pytest.mark.parametrize("name", NAMES)
def test_reduction_matches_one_process(runs, name):
    ranks, one = runs
    want_v, want_g = one[name]
    for r, got in enumerate(ranks):
        v, g = got[name]
        np.testing.assert_allclose(v, want_v, rtol=1e-5, atol=1e-12, err_msg=f"{name} {r}")
        if want_g is not None:
            rows = want_g.shape[0] // 2
            np.testing.assert_allclose(g, want_g[r * rows:(r + 1) * rows], rtol=1e-5,
                                       atol=1e-12 + 1e-6 * np.abs(want_g).max(),
                                       err_msg=f"{name} grad {r}")
