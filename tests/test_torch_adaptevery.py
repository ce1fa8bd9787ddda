"""AdaptEvery in the port against the JAX package: the BatchNorm at one value
per channel, PointNet (``PointNetCls`` with the feature transform, its
regulariser), ``ResNetUNetPoint``, the Chamfer loss, and two
``adaptevery`` steps from the same weights, batches and dropout masks, on
the CPU.

Flax variables are drawn with numpy and carried across by
``slcl_torch.utils.convert``. Sizes are the JAX CLI rehearsal's:
``ResNetUNetPoint`` with one block a stage at base 8 (the decoder scaled as
the JAX trainer scales it) at 64x64, batch 2, the PointNet at base 8 on
the 300 points the trainer regresses. Dropout is on with the test's masks
(``tests/torch_extra_common.py``): the three ``d_point`` passes of a step
share theirs on both sides. The JAX step drops ``d_point``'s updated
running statistics; the port must leave them as they were.

Forwards in float32 at rtol 1e-4 / atol 1e-5; gradients and the steps in
float64 on both sides (``jax.enable_x64``, the port's modules
``.double()``; both keep the losses in float32), for the reasons of
tests/test_torch_ddfseg.py, with its tolerances: gradients rtol 1e-4 with
an atol of 1e-5 of the tensor's largest entry; metrics, statistics and the
discriminators rtol 1e-4 / atol 1e-5; the segmentor's parameters rtol 1e-4
/ atol 1e-6.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_extra_common import (assert_grads_close, assert_tree_close, draw_variables, f64,
                                grads_as_flax, jax_masks, np_tree, port_masks, port_pass_draw)

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.models.common import BatchNorm as TBatchNorm
from slcl_torch.models.common import dropout_pass
from slcl_torch.models.pointnet import PointNetCls as TPointNetCls
from slcl_torch.models.pointnet import feature_transform_regularizer as t_ftr
from slcl_torch.models.resnet_unet import ResNetUNetPoint as TResNetUNetPoint
from slcl_torch.ops import losses as TL
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.train.trainer import Trainer as TTrainer
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models import UncertaintyDiscriminator
from slcl_tpu.models.pointnet import PointNetCls, feature_transform_regularizer
from slcl_tpu.models.resnet_unet import ResNetUNetPoint
from slcl_tpu.ops import losses as L
from slcl_tpu.train.state import NetState, TrainState, make_optimizer
from slcl_tpu.train.steps_extra import make_adaptevery_step

torch.set_num_threads(1)

H, BS, C, B, NP = 64, 2, 4, 8, 300
SMALL = (1, 1, 1, 1)
DEC = tuple(max(2, B * 4 >> i) for i in range(5))      # the JAX trainer's at base 8
KEYS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}


# ---------------------------------------------------------------------------
# BatchNorm at one value per channel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 6), (1, 6, 1, 1)])
def test_batchnorm_one_value_per_channel_matches_flax(shape):
    """At n = 1 ``F.batch_norm`` raises; flax normalises to the bias, takes
    the batch variance as 0 and updates its running statistics. The port's
    BatchNorm gives flax's output, statistics and gradients."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    scale, bias = 1.0 + 0.1 * rng.normal(size=6), 0.1 * rng.normal(size=6)
    mean0, var0 = 0.1 * rng.normal(size=6), np.abs(rng.normal(size=6)) + 0.5
    v = {"params": {"scale": jnp.asarray(scale, jnp.float32),
                    "bias": jnp.asarray(bias, jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(mean0, jnp.float32),
                         "var": jnp.asarray(var0, jnp.float32)}}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))          # flax's channels last
    (want, upd) = bn.apply(v, xj, mutable=["batch_stats"])
    w = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    gx, gp = jax.grad(lambda x, p: jnp.sum(bn.apply({**v, "params": p}, x,
                                                    mutable=["batch_stats"])[0] * w),
                      argnums=(0, 1))(xj, v["params"])

    port = TBatchNorm(6)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port.train()(xt)
    (got * torch.from_numpy(np.moveaxis(w, -1, 1))).sum().backward()
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1).reshape(-1, 6)[0],
                               bias.astype(np.float32), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1), np.asarray(gx), atol=1e-7)
    np.testing.assert_allclose(port.weight.grad.numpy(), np.asarray(gp["scale"]), atol=1e-7)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# PointNet, ResNetUNetPoint, Chamfer
# ---------------------------------------------------------------------------
def _pointnet_vars(ft, seed, n=NP):
    return draw_variables(lambda: PointNetCls(k=1, feature_transform=ft, base=B).init(
        KEYS, jnp.zeros((1, n, 3)), True), seed)


@pytest.mark.parametrize("ft,bs", [(True, 2), (False, 1)])
def test_pointnet_matches_flax(ft, bs):
    """Train mode (dropout on, the test's mask; at batch 1 the layers after
    the max over points see one value per channel) and eval mode, the port
    in float32 against flax in float64; the gradients in float64 on both
    sides; the running statistics after the train pass; the
    feature-transform regulariser."""
    v = _pointnet_vars(ft, 3)
    pts = np.random.default_rng(4).normal(size=(bs, 40, 3)).astype(np.float32)
    with jax.enable_x64():
        # the reference in float64: flax's float32 batch variance over two
        # clouds is 8e-4 off after the transform nets, the port's 2e-6
        jm = PointNetCls(k=1, feature_transform=ft, base=B, dtype=jnp.float64)
        x64 = jnp.asarray(pts, jnp.float64)
        with jax_masks():
            (tr, upd) = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
                f64(v), x64)
        # eval on the running statistics the train pass left
        ev = jax.jit(lambda v, x: jm.apply(v, x, False))(
            {**f64(v), "batch_stats": upd["batch_stats"]}, x64)
        tr, upd, ev = np_tree(tr), np_tree(upd), np_tree(ev)
    port = load_flax_weights(TPointNetCls(k=1, feature_transform=ft, base=B),
                             np_tree(v["params"]), np_tree(v["batch_stats"])).float()
    with dropout_pass(port_pass_draw):
        got_tr = port.train()(torch.from_numpy(pts))
    with torch.no_grad():
        got_ev = port.eval()(torch.from_numpy(pts))
    for got, want in ((got_tr, tr), (got_ev, ev)):
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert_tree_close(state_dict_to_flax(port)["batch_stats"], upd["batch_stats"],
                      1e-4, 1e-5, "pointnet batch_stats")
    if ft:
        np.testing.assert_allclose(float(t_ftr(got_tr[2].detach())),
                                   float(feature_transform_regularizer(tr[2])), rtol=1e-5)
    with jax.enable_x64():
        jm64 = PointNetCls(k=1, feature_transform=ft, base=B, dtype=jnp.float64)
        v64 = f64(v)

        def loss(p):
            out, _ = jm64.apply({**v64, "params": p}, jnp.asarray(pts, jnp.float64), True,
                                mutable=["batch_stats"])
            return jnp.sum(out[0]) + jnp.sum(out[1] ** 2)
        with jax_masks():
            want_g = np_tree(jax.jit(jax.grad(loss))(v64["params"]))
    port = load_flax_weights(TPointNetCls(k=1, feature_transform=ft, base=B),
                             np_tree(v["params"]), np_tree(v["batch_stats"])).double().train()
    with dropout_pass(port_pass_draw):
        out = port(torch.from_numpy(pts).double())
    (out[0].sum() + (out[1] ** 2).sum()).backward()
    got_g = grads_as_flax(port)
    assert_grads_close(got_g, want_g, "pointnet grads")


def _resnet_point_vars(seed):
    return draw_variables(lambda: ResNetUNetPoint(
        num_classes=C, layers=SMALL, base=B, decoder_channels=DEC,
        dtype=jnp.float32).init(KEYS, jnp.zeros((1, H, H, 3)), True), seed)


def test_resnet_unet_point_matches_flax():
    """Train-mode outputs (segmentation heads, features, vertices) and the
    running statistics, and the gradients of a weighted sum of them, in
    float64 on both sides (flax's float32 batch variance is the less exact
    side, tests/test_torch_backbones.py)."""
    v = _resnet_point_vars(5)
    x = np.random.default_rng(6).normal(size=(BS, H, H, 3))
    rng = np.random.default_rng(7)
    with jax.enable_x64():
        jm = ResNetUNetPoint(num_classes=C, layers=SMALL, base=B, decoder_channels=DEC,
                             dtype=jnp.float64)
        v64 = f64(v)

        def fwd(p):
            (out, vert), upd = jm.apply({**v64, "params": p}, jnp.asarray(x), True,
                                        mutable=["batch_stats"])
            return (out.pred, out.aux, out.dcdr_ft, vert), upd["batch_stats"]
        outs, stats = jax.jit(fwd)(v64["params"])
        ws = [rng.normal(size=o.shape) for o in outs]
        grads = jax.jit(jax.grad(lambda p: sum(jnp.sum(o * w) for o, w in
                                                zip(fwd(p)[0], ws))))(v64["params"])
        outs, stats, grads = np_tree(outs), np_tree(stats), np_tree(grads)
    port = load_flax_weights(TResNetUNetPoint(C, NP, layers=SMALL, base=B,
                                              decoder_channels=DEC),
                             np_tree(v["params"]), np_tree(v["batch_stats"])).double()
    out, vert = port.train()(torch.from_numpy(x))
    got = (out.pred, out.aux, out.dcdr_ft, vert)
    assert tuple(vert.shape) == (BS, NP, 3)
    for g, w in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4, atol=1e-5)
    assert_tree_close(state_dict_to_flax(port)["batch_stats"], stats, 1e-4, 1e-5,
                      "resnet_unet_point batch_stats")
    sum((g * torch.from_numpy(w)).sum() for g, w in zip(got, ws)).backward()
    got_g = grads_as_flax(port)
    assert_grads_close(got_g, grads, "resnet_unet_point grads")


def test_chamfer_and_pairwise_distances_match_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(3, 50, 3)).astype(np.float32)
    b = rng.normal(size=(3, 40, 3)).astype(np.float32)
    b[0, :5] = a[0, :5]                              # coincident points: d = 0
    np.testing.assert_allclose(TL.batch_pairwise_dist(torch.from_numpy(a),
                                                      torch.from_numpy(b)).numpy(),
                               np.asarray(L.batch_pairwise_dist(a, b)), rtol=1e-5, atol=1e-5)
    ta = torch.from_numpy(a).requires_grad_(True)
    got = TL.chamfer_loss(ta, torch.from_numpy(b))
    got.backward()
    want, g = jax.value_and_grad(L.chamfer_loss)(jnp.asarray(a), jnp.asarray(b))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# two adaptevery steps
# ---------------------------------------------------------------------------
def _cfg(cls, recipe):
    cfg = cls()
    cfg.method = "adaptevery"
    cfg = recipe(cfg)
    cfg.model.dtype = "float32"
    cfg.data.dataset = "synthetic"
    cfg.model.layers, cfg.model.base = SMALL, B
    cfg.data.bs, cfg.data.crop, cfg.data.num_workers = BS, H, 1
    return cfg


@pytest.fixture(scope="module")
def steps():
    seg_v = _resnet_point_vars(11)
    d_vs = [draw_variables(lambda: UncertaintyDiscriminator(base=B, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, H, C))), s) for s in (12, 13, 14)]
    # the discriminators' kernels at their init scale, N(0, 0.02)
    d_vs = [jax.tree.map(lambda a: a * 0.02 * np.sqrt(np.prod(a.shape[:-1])), d) for d in d_vs]
    p_v = _pointnet_vars(False, 15)
    rng = np.random.default_rng(21)
    batches = [{"img_s": rng.normal(size=(BS, H, H, 3)),
                "lab_s": rng.integers(0, C, size=(BS, H, H)).astype(np.int32),
                "vert_s": rng.normal(size=(BS, NP, 3)),
                "img_t": rng.normal(0.5, 2.0, size=(BS, H, H, 3))} for _ in range(2)]
    sched = {"lr": 8e-4, "lr_dis": 1e-4}
    cfg = _cfg(Config, apply_recipe)
    want = []
    with jax.enable_x64():
        model = ResNetUNetPoint(num_classes=C, layers=SMALL, base=B, decoder_channels=DEC,
                                dtype=jnp.float64)
        ds = [UncertaintyDiscriminator(base=B, dtype=jnp.float64) for _ in range(3)]
        d_point = PointNetCls(k=1, base=B, dtype=jnp.float64)
        tx = make_optimizer(cfg.optim.optimizer, cfg.optim.lr, momentum=cfg.optim.momentum,
                            weight_decay=cfg.optim.weight_decay)
        txd = [make_optimizer("adam", cfg.optim.lr_dis, betas=(cfg.adv.mmt1, cfg.adv.mmt))
               for _ in range(4)]
        sv = f64(seg_v)
        nets = [NetState(params=f64(d["params"]), batch_stats={},
                         opt_state=t.init(f64(d["params"]))) for d, t in zip(d_vs, txd)]
        pv = f64(p_v)
        pnet = NetState(params=pv["params"], batch_stats=pv["batch_stats"],
                        opt_state=txd[3].init(pv["params"]))
        state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                           seg=NetState(params=sv["params"], batch_stats=sv["batch_stats"],
                                        opt_state=tx.init(sv["params"])),
                           d_main=nets[0], d_aux=nets[1],
                           extra={"d_ent": nets[2], "d_point": pnet})
        step = make_adaptevery_step(cfg, model, *ds, d_point,
                                    {"seg": tx, "d_main": txd[0], "d_aux": txd[1],
                                     "d_ent": txd[2], "d_point": txd[3]})
        with jax_masks():
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                                {k: jnp.asarray(v, jnp.float64) for k, v in sched.items()})
                want.append({"m": {k: float(v) for k, v in m.items()},
                             "seg": np_tree(state.seg.params),
                             "bs": np_tree(state.seg.batch_stats),
                             "d_main": np_tree(state.d_main.params),
                             "d_aux": np_tree(state.d_aux.params),
                             "d_ent": np_tree(state.extra["d_ent"].params),
                             "d_point": np_tree(state.extra["d_point"].params),
                             "d_point_bs": np_tree(state.extra["d_point"].batch_stats)})

    tr = TTrainer(_cfg(TConfig, t_apply_recipe), device="cpu")
    s = tr.state
    load_flax_weights(s.seg, np_tree(seg_v["params"]), np_tree(seg_v["batch_stats"]))
    for net, d in zip((s.d_main, s.d_aux, s.d_ent), d_vs):
        load_flax_weights(net, np_tree(d["params"]))
    load_flax_weights(s.d_point, np_tree(p_v["params"]), np_tree(p_v["batch_stats"]))
    for name in ("seg", "d_main", "d_aux", "d_ent", "d_point"):
        getattr(s, name).double()
    tstep = t_build_step(tr.cfg, draw_dropout=port_masks)
    got = []
    for b in batches:
        m = tstep(s, {k: torch.from_numpy(v) for k, v in b.items()}, sched)
        flax_point = state_dict_to_flax(s.d_point)
        got.append({"m": {k: float(v) for k, v in m.items()},
                    "seg": state_dict_to_flax(s.seg)["params"],
                    "bs": state_dict_to_flax(s.seg)["batch_stats"],
                    **{k: state_dict_to_flax(getattr(s, k))["params"]
                       for k in ("d_main", "d_aux", "d_ent")},
                    "d_point": flax_point["params"], "d_point_bs": flax_point["batch_stats"]})
    return want, got, np_tree(p_v["batch_stats"])


@pytest.mark.parametrize("i", [0, 1])
def test_adaptevery_step_metrics_match_jax(steps, i):
    want, got = steps[0][i]["m"], steps[1][i]["m"]
    assert set(got) == set(want) == {"seg_s", "seg_s_aux", "loss_point", "loss_adv",
                                     "loss_adv_aux", "loss_adv_ent", "loss_adv_point"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("i", [0, 1])
def test_adaptevery_step_parameters_and_statistics_match_jax(steps, i):
    want, got = steps[0][i], steps[1][i]
    assert_tree_close(got["seg"], want["seg"], 1e-4, 1e-6, f"step {i} segmentor")
    assert_tree_close(got["bs"], want["bs"], 1e-4, 1e-5, f"step {i} batch_stats")
    for k in ("d_main", "d_aux", "d_ent", "d_point"):
        assert_tree_close(got[k], want[k], 1e-4, 1e-5, f"step {i} {k}")


@pytest.mark.parametrize("i", [0, 1])
def test_d_point_running_statistics_stay_unchanged(steps, i):
    """Both sides keep the PointNet's running statistics where they started."""
    want, got, start = steps[0][i], steps[1][i], steps[2]
    assert_tree_close(want["d_point_bs"], start, 0.0, 0.0, "jax d_point batch_stats")
    assert_tree_close(got["d_point_bs"], start, 0.0, 0.0, "port d_point batch_stats")
