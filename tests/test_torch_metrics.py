"""Port parity: ``slcl_torch.ops.metrics`` against ``slcl_tpu.ops.metrics``
on seeded label maps (host metrics and KLC equal to the last bit, device
Dice within 1e-6), and against the committed medpy-formula goldens
(tests/fixtures/metric_goldens.json) as tests/test_metrics.py holds the JAX
package to them.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.ops import metrics as TM
from slcl_tpu.ops import metrics as JM

torch.set_num_threads(1)


def _label_maps(rng, n=6, size=48):
    """Blobby 4-class maps: a few rectangles per class on background, so
    borders, several components and empty classes all occur."""
    out = np.zeros((n, size, size), np.int64)
    for i in range(n):
        for c in (1, 2, 3):
            for _ in range(rng.integers(0, 3)):
                y, x = rng.integers(0, size - 8, 2)
                h, w = rng.integers(2, 12, 2)
                out[i, y:y + h, x:x + w] = c
    return out


@pytest.mark.parametrize("spacing", [None, (1.0, 2.0)])
def test_host_metrics_equal_jax(rng, spacing):
    gts, preds = _label_maps(rng), _label_maps(rng)
    for gt, pred in zip(gts, preds):
        for c in (1, 2, 3):
            g, p = (gt == c).astype(np.uint8), (pred == c).astype(np.uint8)
            if not (g.any() and p.any()):
                continue
            for fn in ("hd95", "hd", "asd", "assd"):
                assert getattr(TM, fn)(g, p, spacing) == getattr(JM, fn)(g, p, spacing), fn
            assert TM.dc(g, p) == JM.dc(g, p)
        for hd, asd in ((False, False), (True, True)):
            assert (TM.metrics_per_class(gt, pred, apply_hd=hd, apply_asd=asd, spacing=spacing)
                    == JM.metrics_per_class(gt, pred, apply_hd=hd, apply_asd=asd,
                                            spacing=spacing))


def test_keep_largest_connected_components_equal_jax(rng):
    for seg in _label_maps(rng, n=8):
        np.testing.assert_array_equal(TM.keep_largest_connected_components(seg),
                                      JM.keep_largest_connected_components(seg))


def test_surface_metrics_match_committed_goldens():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "metric_goldens.json")
    with open(path) as f:
        cases = json.load(f)
    assert len(cases) >= 5
    for c in cases:
        gt = np.asarray(c["gt"], np.uint8)
        pred = np.asarray(c["pred"], np.uint8)
        sp = c["spacing"]
        np.testing.assert_allclose(TM.dc(gt, pred), c["dc"], atol=1e-9)
        np.testing.assert_allclose(TM.hd(gt, pred, sp), c["hd"], rtol=1e-6)
        np.testing.assert_allclose(TM.hd95(gt, pred, sp), c["hd95"], rtol=1e-6)
        np.testing.assert_allclose(TM.asd(gt, pred, sp), c["asd"], rtol=1e-6)
        np.testing.assert_allclose(TM.assd(gt, pred, sp), c["assd"], rtol=1e-6)


def test_device_dice_matches_jax(rng):
    gts, preds = _label_maps(rng), _label_maps(rng)
    got = TM.dice_coef_per_class(torch.from_numpy(preds), torch.from_numpy(gts)).numpy()
    want = np.asarray(JM.dice_coef_per_class(jnp.asarray(preds), jnp.asarray(gts)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    per_img = TM.dice_per_image(torch.from_numpy(preds), torch.from_numpy(gts)).numpy()
    for i in range(len(gts)):
        want_i = np.asarray(JM.dice_coef_per_class(jnp.asarray(preds[i]),
                                                   jnp.asarray(gts[i])))
        np.testing.assert_allclose(per_img[i], want_i, rtol=0, atol=1e-6)
