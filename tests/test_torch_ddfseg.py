"""DDFSeg in the port against the JAX package: DDFNet, SegDecoder and
PatchGAN (with and without its aux head) from numpy-drawn flax variables
carried across by ``slcl_torch.utils.convert``, forward and gradients, and
two ``ddfseg`` steps (generator and the three discriminators) from the same
weights, batches and dropout masks, on the CPU.

Sizes are the JAX CLI rehearsal's: a slim DDFNet with ``filters=4
style_filters=4 ngf=8`` at 32x32, batch 2. Dropout is on, with one mask per
(module path, call within a pass) on both sides (``tests/
torch_extra_common.py``), so the three SegDecoder passes of a step share
their masks on both sides.

Gradients and the steps are held in float64 on both sides (``jax.
enable_x64``, the port's modules ``.double()``; both keep the losses and the
attention's two products in float32): float32 rounding through a conv net of
this depth moves Adam's first, sign-like update of a parameter whose
gradient is near zero (a conv bias before a norm) by up to the learning
rate. Tolerances: outputs, metrics, BatchNorm statistics and
discriminator parameters rtol 1e-4 / atol 1e-5, the generator's parameters
rtol 1e-4 / atol 1e-6 (the precedent of tests/test_torch_step.py); PatchGAN
in float32 rtol 1e-4 / atol 1e-5; gradients as tests/test_torch_rain_model.py
holds them (rtol 1e-4, atol 1e-5 of the tensor's largest entry, error norm
1e-4 of its norm): the float32 attention products differ in their
summation order between the two sides, which leaves up to 2.5e-6 of a
tensor's largest entry on the gradients behind them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_extra_common import (assert_grads_close, assert_tree_close, draw_variables, f64,
                                grads_as_flax, jax_masks, np_tree, port_masks, port_pass_draw)

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.models.common import dropout_pass
from slcl_torch.models.ddfseg import DDFSeg as TDDFSeg
from slcl_torch.models.discriminators import PatchGAN as TPatchGAN
from slcl_torch.train.trainer import Trainer as TTrainer
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models.ddfseg import DDFNet, SegDecoder
from slcl_tpu.models.discriminators import PatchGAN
from slcl_tpu.train.state import NetState, TrainState, make_optimizer
from slcl_tpu.train.steps_extra import make_ddfseg_step

torch.set_num_threads(1)

H, BS, C = 32, 2, 4
SLIM = dict(filters=4, style_filters=4, ngf=8, slim=True)
KEYS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}


def _ddf_vars(seed=0):
    x = jnp.zeros((1, H, H, 3))
    return draw_variables(lambda: DDFNet(**SLIM, dtype=jnp.float32).init(KEYS, x, x, True),
                          seed)


def _seg_vars(seed=1):
    x = jnp.zeros((1, H // 8, H // 8, 32 * SLIM["filters"]))
    return draw_variables(lambda: SegDecoder(C, ngf=8, slim=True, dtype=jnp.float32).init(
        KEYS, x, True), seed)


def _patch_vars(ch, aux, seed):
    return draw_variables(lambda: PatchGAN(aux=aux, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, H, ch))), seed)


def _port_gen(dv, sv):
    port = TDDFSeg(C, **SLIM)
    load_flax_weights(port.ddfnet, np_tree(dv["params"]), np_tree(dv["batch_stats"]))
    load_flax_weights(port.segdecoder, np_tree(sv["params"]))
    return port.double()


def _images(seed, n=BS):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, H, H, 3)), rng.normal(0.3, 1.5, size=(n, H, H, 3)))


@pytest.fixture(scope="module")
def ddf():
    """DDFNet + SegDecoder in train mode (dropout on, the test's masks) and
    eval mode, float64 on both sides: outputs, running statistics after the
    train pass, and the gradients of a fixed weighted sum of every output."""
    dv, sv = _ddf_vars(), _seg_vars()
    xs, xt = _images(3)
    rng = np.random.default_rng(4)
    keys = ("content_s", "content_t", "fake_img_s_t", "fake_img_t_s", "recon_imgs",
            "recon_imgt", "recon_content_s", "style_s_from_t", "style_t_from_s")
    with jax.enable_x64():
        net = DDFNet(**SLIM, dtype=jnp.float64)
        seg = SegDecoder(C, ngf=8, slim=True, dtype=jnp.float64)
        v64, s64 = f64(dv), f64(sv)
        weights = None

        def fwd(p, sp, bs, a, b):
            out, upd = net.apply({"params": p, "batch_stats": bs}, a, b, True,
                                 mutable=["batch_stats"])
            out["pred"] = seg.apply({"params": sp}, out["content_t"], True)
            return out, upd["batch_stats"]

        def loss(p, sp, bs, a, b, w):
            out, _ = fwd(p, sp, bs, a, b)
            return sum(jnp.sum(out[k] * w[k]) for k in w)

        with jax_masks():
            out, stats = jax.jit(fwd)(v64["params"], s64["params"], v64["batch_stats"],
                                      jnp.asarray(xs), jnp.asarray(xt))
            weights = {k: rng.normal(size=out[k].shape) for k in out}
            grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                v64["params"], s64["params"], v64["batch_stats"], jnp.asarray(xs),
                jnp.asarray(xt), {k: jnp.asarray(w) for k, w in weights.items()})
        # the eval path on the running statistics the train pass left
        ev = jax.jit(lambda p, sp, bs, a: seg.apply(
            {"params": sp}, net.apply({"params": p, "batch_stats": bs}, a, False,
                                      method="content_s"), False))(
            v64["params"], s64["params"], stats, jnp.asarray(xs))
    want = {"out": np_tree(out), "stats": np_tree(stats), "eval": np.asarray(ev),
            "grads": np_tree(grads)}

    port = _port_gen(dv, sv).train()
    with dropout_pass(port_pass_draw):
        got = port.ddfnet(torch.from_numpy(xs), torch.from_numpy(xt))
    with dropout_pass(port_pass_draw):
        got["pred"] = port.segdecoder(got["content_t"])
    total = sum((got[k] * torch.from_numpy(w)).sum() for k, w in weights.items())
    total.backward()
    grads_p = {"ddfnet": {k: v.grad for k, v in port.ddfnet.named_parameters()},
               "segdecoder": {k: v.grad for k, v in port.segdecoder.named_parameters()}}
    stats_p = state_dict_to_flax(port.ddfnet)["batch_stats"]
    with torch.no_grad():
        ev_p = port.eval()(torch.from_numpy(xs)).pred
    return want, {"out": {k: v.detach().numpy() for k, v in got.items()},
                  "stats": stats_p, "eval": ev_p.numpy(), "grads": grads_p,
                  "port": port}


@pytest.mark.parametrize("key", ["content_s", "content_t", "fake_img_s_t", "fake_img_t_s",
                                 "recon_imgs", "recon_imgt", "recon_content_s",
                                 "style_s_from_t", "style_t_from_s", "pred"])
def test_ddfnet_train_outputs_match_flax(ddf, key):
    want, got = ddf
    np.testing.assert_allclose(got["out"][key], want["out"][key], rtol=1e-4, atol=1e-5)


def test_ddfnet_running_stats_and_eval_path_match_flax(ddf):
    want, got = ddf
    assert_tree_close(got["stats"], want["stats"], 1e-4, 1e-5, "ddfnet batch_stats")
    assert got["eval"].shape == (BS, H, H, C)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("part", ["ddfnet", "segdecoder"])
def test_ddfnet_and_segdecoder_gradients_match_flax(ddf, part):
    """Every parameter's gradient, the attention's ``gamma`` and the
    transposed convs' (flipped) kernels included."""
    want, got = ddf
    grads = grads_as_flax(getattr(got["port"], part), got["grads"][part])
    if part == "ddfnet":
        assert "gamma" in grads["encoders"]["_Attention_0"]
    assert_grads_close(grads, want["grads"][0 if part == "ddfnet" else 1], f"{part} grads")


@pytest.mark.parametrize("aux", [False, True])
def test_patchgan_matches_flax(aux):
    """Forward in float32 and the parameters' gradients in float64; the
    instance norms' epsilon is flax's default 1e-6."""
    ch = 1 if aux else C
    v = _patch_vars(ch, aux, 5 + aux)
    x = np.random.default_rng(7).normal(size=(BS, H, H, ch))
    jm = PatchGAN(aux=aux, dtype=jnp.float32)
    want = jm.apply(v, jnp.asarray(x, jnp.float32))
    port = load_flax_weights(TPatchGAN(ch, aux=aux), np_tree(v["params"]))
    assert isinstance(port.in1, torch.nn.GroupNorm) and port.in1.eps == 1e-6
    got = port(torch.from_numpy(x).float())
    for g, w in zip(got if aux else (got,), want if aux else (want,)):
        assert tuple(g.shape) == w.shape == (BS, 2, 2, 1)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    with jax.enable_x64():
        jm64 = PatchGAN(aux=aux, dtype=jnp.float64)

        def loss(p):
            out = jm64.apply({"params": p}, jnp.asarray(x))
            return sum(jnp.sum(o * (i + 1.0)) for i, o in
                       enumerate(out if aux else (out,)))
        want_g = np_tree(jax.grad(loss)(f64(v["params"])))
    port = port.double()
    out = port(torch.from_numpy(x))
    sum(((o * (i + 1.0)).sum() for i, o in enumerate(out if aux else (out,)))).backward()
    got_g = grads_as_flax(port)
    assert_grads_close(got_g, want_g, "patchgan grads")


# ---------------------------------------------------------------------------
# two ddfseg steps
# ---------------------------------------------------------------------------
def _cfg(cls, recipe):
    cfg = cls()
    cfg.method = "ddfseg"
    cfg = recipe(cfg)
    cfg.model.dtype = "float32"
    cfg.data.dataset = "synthetic"
    cfg.data.bs, cfg.data.crop, cfg.data.num_workers = BS, H, 1
    for k, v in SLIM.items():
        setattr(cfg.ddfseg, k, v)
    return cfg


@pytest.fixture(scope="module")
def steps():
    """Two steps of each side from the same variables, batches and masks:
    per step the metrics and every network's parameters and statistics. The
    attention's ``gamma`` starts at flax's 0 (the module test holds it
    away from 0): its float32 products then reach the first step through
    ``gamma``'s own gradient alone, and the second at a ``gamma`` of the
    learning rate's size."""
    dv, sv = _ddf_vars(), _seg_vars()
    dv = jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if path[-1].key == "gamma" else a, dv)
    dvs = [_patch_vars(1, False, 11), _patch_vars(1, True, 12), _patch_vars(C, False, 13)]
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(2):
        xs, xt = _images(int(rng.integers(1 << 30)))
        batches.append({"img_s": xs, "lab_s": rng.integers(0, C, size=(BS, H, H)).astype(np.int32),
                        "img_t": xt})
    sched = {"lr": 2e-4, "lr_dis": 1e-4}
    cfg = _cfg(Config, apply_recipe)
    want = []
    with jax.enable_x64():
        ddfnet = DDFNet(**SLIM, dtype=jnp.float64)
        segdec = SegDecoder(C, ngf=8, slim=True, dtype=jnp.float64)
        d_t, d_s, d_seg = (PatchGAN(dtype=jnp.float64), PatchGAN(aux=True, dtype=jnp.float64),
                           PatchGAN(dtype=jnp.float64))
        tx = make_optimizer("adam", cfg.optim.lr)
        tx_d = [make_optimizer("adam", cfg.optim.lr_dis, betas=(cfg.adv.mmt1, cfg.adv.mmt))
                for _ in range(3)]
        dv64, sv64 = f64(dv), f64(sv)
        params = {"ddfnet": dv64["params"], "segdecoder": sv64["params"]}
        nets = [NetState(params=f64(d["params"]), batch_stats={},
                         opt_state=t.init(f64(d["params"]))) for d, t in zip(dvs, tx_d)]
        state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                           seg=NetState(params=params,
                                        batch_stats={"ddfnet": dv64["batch_stats"],
                                                     "segdecoder": {}},
                                        opt_state=tx.init(params)),
                           d_main=nets[0], d_aux=nets[1], extra={"d_seg": nets[2]})
        step = make_ddfseg_step(cfg, ddfnet, segdec, d_s, d_t, d_seg,
                                {"seg": tx, "d_main": tx_d[0], "d_aux": tx_d[1],
                                 "d_seg": tx_d[2]})
        with jax_masks():
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                                {k: jnp.asarray(v, jnp.float64) for k, v in sched.items()})
                want.append({"m": {k: float(v) for k, v in m.items()},
                             "seg": np_tree(state.seg.params),
                             "bs": np_tree(state.seg.batch_stats["ddfnet"]),
                             "d_main": np_tree(state.d_main.params),
                             "d_aux": np_tree(state.d_aux.params),
                             "d_seg": np_tree(state.extra["d_seg"].params)})

    tr = TTrainer(_cfg(TConfig, t_apply_recipe), device="cpu")
    s = tr.state
    load_flax_weights(s.seg.ddfnet, np_tree(dv["params"]), np_tree(dv["batch_stats"]))
    load_flax_weights(s.seg.segdecoder, np_tree(sv["params"]))
    for net, d in zip((s.d_main, s.d_aux, s.d_seg), dvs):
        load_flax_weights(net, np_tree(d["params"]))
    for net in (s.seg, s.d_main, s.d_aux, s.d_seg):
        net.double()
    from slcl_torch.train.steps import build_step
    tstep = build_step(tr.cfg, draw_dropout=port_masks)
    got = []
    for b in batches:
        m = tstep(s, {k: torch.from_numpy(v) for k, v in b.items()}, sched)
        got.append({"m": {k: float(v) for k, v in m.items()},
                    "seg": {"ddfnet": state_dict_to_flax(s.seg.ddfnet)["params"],
                            "segdecoder": state_dict_to_flax(s.seg.segdecoder)["params"]},
                    "bs": state_dict_to_flax(s.seg.ddfnet)["batch_stats"],
                    **{k: state_dict_to_flax(getattr(s, k))["params"]
                       for k in ("d_main", "d_aux", "d_seg")}})
    return want, got


@pytest.mark.parametrize("i", [0, 1])
def test_ddfseg_step_metrics_match_jax(steps, i):
    want, got = steps[0][i]["m"], steps[1][i]["m"]
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("i", [0, 1])
def test_ddfseg_step_parameters_and_statistics_match_jax(steps, i):
    want, got = steps[0][i], steps[1][i]
    assert_tree_close(got["seg"], want["seg"], 1e-4, 1e-6, f"step {i} generator")
    assert_tree_close(got["bs"], want["bs"], 1e-4, 1e-5, f"step {i} batch_stats")
    for k in ("d_main", "d_aux", "d_seg"):
        assert_tree_close(got[k], want[k], 1e-4, 1e-5, f"step {i} {k}")
