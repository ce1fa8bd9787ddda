"""BCL in the port against the JAX package: the losses (CE with ignore, the
double-softmax entropy, the prototype similarity, MSE), the pseudo-label
helpers (class-balanced thresholds and labels, the local top-r% labels,
fusion, accuracy), ``BCLDeepLab`` (the ``pair`` variant with its target
stem, frozen BatchNorm, the -inf-padded ceil pool) and two ``bcl`` steps
from the same weights and batches, on the CPU.

Flax variables are drawn with numpy and carried across by
``slcl_torch.utils.convert``. Sizes are the JAX CLI rehearsal's:
``BCLDeepLab`` with one block a stage at base 8, 33x33 for the model (an
odd side through the ceil pool) and 32x32 for the steps, batch 2.
Tolerances: losses and outputs rtol 1e-4 / atol 1e-5 in float32 (the
pseudo-labels exactly); the model's gradients and the steps in float64 on
both sides, as tests/test_torch_ddfseg.py holds them (gradients rtol 1e-4
with an atol of 1e-5 of the tensor's largest entry; metrics and running
statistics rtol 1e-4 / atol 1e-5; parameters rtol 1e-4 / atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_extra_common import (assert_grads_close, assert_tree_close, draw_variables, f64,
                                grads_as_flax, np_tree)

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.models.deeplabv2 import BCLDeepLab as TBCLDeepLab
from slcl_torch.ops import centroids as TC
from slcl_torch.ops import losses as TL
from slcl_torch.train.trainer import Trainer as TTrainer
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models.deeplabv2 import BCLDeepLab
from slcl_tpu.ops import centroids as JC
from slcl_tpu.ops import losses as L
from slcl_tpu.train.state import NetState, TrainState, make_optimizer
from slcl_tpu.train.steps_extra import make_bcl_step

torch.set_num_threads(1)

C, BS, B = 4, 2, 8
SMALL = (1, 1, 1, 1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# losses and pseudo-label helpers
# ---------------------------------------------------------------------------
def test_cross_entropy_ignore_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 8, 8, C)).astype(np.float32)
    labels = rng.integers(0, C, size=(2, 8, 8)).astype(np.int32)
    labels[0, :3] = 255
    want = L.cross_entropy_ignore(logits, labels, 255)
    assert float(TL.cross_entropy_ignore(_t(logits), _t(labels), 255)) == pytest.approx(
        float(want), rel=1e-5)
    all_ignored = np.full_like(labels, 255)
    assert float(TL.cross_entropy_ignore(_t(logits), _t(all_ignored))) == 0.0 == float(
        L.cross_entropy_ignore(logits, all_ignored))


def test_bcl_entropy_and_mse_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 8, 8, C)).astype(np.float32)
    np.testing.assert_allclose(TL.bcl_entropy_loss(_t(logits)).numpy(),
                               np.asarray(L.bcl_entropy_loss(logits)), rtol=1e-5, atol=1e-6)
    a, b = rng.normal(size=(3, 5)).astype(np.float32), rng.normal(size=(3, 5)).astype(np.float32)
    assert float(TL.mse_loss(_t(a), _t(b))) == pytest.approx(float(L.mse_loss(a, b)), rel=1e-6)


def test_bcl_prototype_similarity_matches_jax():
    """Absent classes (zero prototypes), ignored pixels and an exact-zero
    cosine (an all-zero feature column) in the values; the gradients where
    no column is zero (there JAX's norm gradient is NaN)."""
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(6, 5, 8)).astype(np.float32)
    feat2 = rng.normal(size=(6, 5, 8)).astype(np.float32)
    lab = rng.integers(0, 2, size=(6, 5)).astype(np.int32)       # classes 2, 3 absent
    lab[0] = 255
    zero_col = feat2.copy()
    zero_col[:, :, 3] = 0.0
    want = np.asarray(L.bcl_prototype_similarity(feat, lab, zero_col, C))
    got = TL.bcl_prototype_similarity(_t(feat), _t(lab), _t(zero_col), C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (want[2:] == -10.0).all()
    tf, tf2 = _t(feat).requires_grad_(True), _t(feat2).requires_grad_(True)
    got = TL.bcl_prototype_similarity(tf, _t(lab), tf2, C)
    w = rng.normal(size=got.shape).astype(np.float32)
    (got * _t(w)).sum().backward()
    g1, g2 = jax.grad(lambda a, b: jnp.sum(L.bcl_prototype_similarity(a, lab, b, C) * w),
                      argnums=(0, 1))(feat, feat2)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(g1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tf2.grad.numpy(), np.asarray(g2), rtol=1e-4, atol=1e-5)


def _probs(seed, shape=(3, 10, 12, C)):
    logits = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_pseudo_label_helpers_match_jax():
    probs = _probs(3)
    conf, pred = probs.max(-1), probs.argmax(-1)
    for prop in (0.2, 0.5, 1.0):
        th = TC.gene_thres(conf.ravel(), pred.ravel(), prop, C + 1)  # class 4: no pixel
        np.testing.assert_array_equal(th, np.asarray(JC.gene_thres(conf.ravel(), pred.ravel(),
                                                                   prop, C + 1)))
        assert th.dtype == np.float32 and th[C] == 1.0
        th = th[:C]
        got_l, got_m = TC.thres_cb_plabel(_t(probs), _t(th), C)
        want_l, want_m = JC.thres_cb_plabel(jnp.asarray(probs), jnp.asarray(th), C)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        got_l, got_m = TC.gene_plabel_prop(_t(probs), prop)
        want_l, want_m = JC.gene_plabel_prop(jnp.asarray(probs), prop)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # the 0.999 cap
    assert float(TC.gene_thres(np.full(10, 0.99999, np.float32), np.zeros(10), 0.5, 1)[0]) \
        == np.float32(0.999)
    a, b = TC.gene_plabel_prop(_t(probs), 0.5)[0], TC.thres_cb_plabel(_t(probs), _t(th), C)[0]
    np.testing.assert_array_equal(TC.mask_fusion(a, b).numpy(),
                                  np.asarray(JC.mask_fusion(jnp.asarray(a.numpy()),
                                                            jnp.asarray(b.numpy()))))
    label = np.random.default_rng(4).integers(0, C, size=pred.shape)
    got = TC.pseudo_label_accuracy(a, _t(label))
    want = JC.pseudo_label_accuracy(jnp.asarray(a.numpy()), jnp.asarray(label))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-6)


# ---------------------------------------------------------------------------
# BCLDeepLab
# ---------------------------------------------------------------------------
def _model_vars(hw, pair, seed):
    return draw_variables(lambda: BCLDeepLab(num_classes=C, layers=SMALL, pair=pair, base=B,
                                             dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)), True, True), seed)


@pytest.mark.parametrize("source", [True, False])
def test_bcl_deeplab_pair_matches_flax(source):
    """The pair variant on either stem at 33x33: train-mode logits and
    features and the running statistics, the port in float32 against flax
    in float64 (flax's float32 batch variance is the less exact side,
    tests/test_torch_backbones.py); eval mode; the gradients in float64 on
    both sides (FrozenBatchNorm's affine takes none)."""
    hw = 33
    v = _model_vars(hw, True, 5)
    x = np.random.default_rng(6).normal(size=(BS, hw, hw, 3))
    w = [np.random.default_rng(7).normal(size=s) for s in ((BS, hw, hw, C), (BS, 5, 5, 4 * C))]
    with jax.enable_x64():
        jm = BCLDeepLab(num_classes=C, layers=SMALL, pair=True, base=B, dtype=jnp.float64)
        v64 = f64(v)

        def fwd(p, train):
            return jm.apply({**v64, "params": p}, jnp.asarray(x), train, source,
                            mutable=["batch_stats"])
        (tr, upd) = jax.jit(lambda p: fwd(p, True))(v64["params"])
        ev = jax.jit(lambda bs: jm.apply({**v64, "batch_stats": bs}, jnp.asarray(x), False,
                                         source))(upd["batch_stats"])
        grads = jax.jit(jax.grad(lambda p: sum(jnp.sum(o * ww) for o, ww in
                                                zip(fwd(p, True)[0], w))))(v64["params"])
        tr, upd, ev, grads = np_tree(tr), np_tree(upd), np_tree(ev), np_tree(grads)
    port = load_flax_weights(TBCLDeepLab(C, layers=SMALL, pair=True, base=B),
                             np_tree(v["params"]), np_tree(v["batch_stats"])).float()
    got = port.train()(_t(x).float(), source=source)
    assert tuple(got[0].shape) == (BS, hw, hw, C) and tuple(got[1].shape) == (BS, 5, 5, 4 * C)
    for g, ww in zip(got, tr):
        np.testing.assert_allclose(g.detach().numpy(), ww, rtol=1e-4, atol=1e-5)
    assert_tree_close(state_dict_to_flax(port)["batch_stats"], upd["batch_stats"], 1e-4, 1e-5,
                      "bcl batch_stats")
    with torch.no_grad():
        got_ev = port.eval()(_t(x).float(), source=source)
    for g, ww in zip(got_ev, ev):
        np.testing.assert_allclose(g.numpy(), ww, rtol=1e-4, atol=1e-5)
    port = load_flax_weights(TBCLDeepLab(C, layers=SMALL, pair=True, base=B),
                             np_tree(v["params"]), np_tree(v["batch_stats"])).double().train()
    out = port(_t(x), source=source)
    sum((o * _t(ww)).sum() for o, ww in zip(out, w)).backward()
    assert_grads_close(grads_as_flax(port), grads, "bcl grads")


# ---------------------------------------------------------------------------
# two bcl steps
# ---------------------------------------------------------------------------
H = 32


def _cfg(cls, recipe):
    cfg = cls()
    cfg.method = "bcl"
    cfg = recipe(cfg)
    cfg.model.dtype = "float32"
    cfg.data.dataset = "synthetic"
    cfg.model.layers, cfg.model.base = SMALL, B
    cfg.model.num_classes = C
    cfg.data.bs, cfg.data.crop, cfg.data.num_workers = BS, H, 1
    return cfg


@pytest.fixture(scope="module")
def steps():
    v = _model_vars(H, False, 11)
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(2):
        plabel = rng.integers(0, C, size=(BS, H, H)).astype(np.int32)
        plabel[:, :5] = 255
        batches.append({"img_s": rng.normal(size=(BS, H, H, 3)),
                        "lab_s": rng.integers(0, C, size=(BS, H, H)).astype(np.int32),
                        "img_t": rng.normal(0.5, 2.0, size=(BS, H, H, 3)),
                        "plabel_t": plabel})
    sched = {"lr": 8e-4}
    cfg = _cfg(Config, apply_recipe)
    want = []
    with jax.enable_x64():
        model = BCLDeepLab(num_classes=C, layers=SMALL, base=B, dtype=jnp.float64)
        tx = make_optimizer("sgd", cfg.optim.lr, momentum=cfg.optim.momentum,
                            weight_decay=cfg.optim.weight_decay)
        v64 = f64(v)
        state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                           seg=NetState(params=v64["params"], batch_stats=v64["batch_stats"],
                                        opt_state=tx.init(v64["params"])))
        step = make_bcl_step(cfg, model, {"seg": tx})
        for b in batches:
            state, m = step(state, {k: jnp.asarray(a) for k, a in b.items()},
                            {"lr": jnp.asarray(sched["lr"], jnp.float64)})
            want.append({"m": {k: float(a) for k, a in m.items()},
                         "params": np_tree(state.seg.params),
                         "bs": np_tree(state.seg.batch_stats)})
    tr = TTrainer(_cfg(TConfig, t_apply_recipe), device="cpu")
    s = tr.state
    load_flax_weights(s.seg, np_tree(v["params"]), np_tree(v["batch_stats"]))
    s.seg.double()
    got = []
    for b in batches:
        m = tr.step_fn(s, {k: _t(a) for k, a in b.items()}, sched)
        flax = state_dict_to_flax(s.seg)
        got.append({"m": {k: float(a) for k, a in m.items()}, "params": flax["params"],
                    "bs": flax["batch_stats"]})
    return want, got


@pytest.mark.parametrize("i", [0, 1])
def test_bcl_step_metrics_match_jax(steps, i):
    want, got = steps[0][i]["m"], steps[1][i]["m"]
    assert set(got) == set(want) == {"seg_s", "seg_t_pseudo", "loss_ent", "metric_loss"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("i", [0, 1])
def test_bcl_step_parameters_and_statistics_match_jax(steps, i):
    want, got = steps[0][i], steps[1][i]
    assert_tree_close(got["params"], want["params"], 1e-4, 1e-6, f"step {i} params")
    assert_tree_close(got["bs"], want["bs"], 1e-4, 1e-5, f"step {i} batch_stats")
