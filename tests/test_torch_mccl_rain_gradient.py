"""MCCL + RAIN at ``rain.style_alpha=0.5``: which gradient is right.

The port's and the JAX step's segmentor gradients part by 5-7% there
(``tests/test_torch_step_mccl_rain.py`` holds that run on its metrics
alone), and JAX's two-cotangent ``vjp`` was suspected (ROADMAP queue 3). This file holds both
gradients to the derivative of the JAX step's own loss, in float64 on both
sides (``jax.enable_x64``; the port's modules ``.double()``), at the
``mccl`` preset with the style net on, the seg losses alone in the total
(``warm`` 0, ``rain.consist_w`` 0; the ascent off) and SGD at lr 1 without
weight decay, so that one step's parameter change is minus the gradient.

The JAX step's loss, ``seg_s + seg_style``, is a function of the
parameters and of the segmentor's input batch, [stylised blend, source].
The two packages make that input with the style net, whose AdaIN
statistics and losses stay in float32 on both sides, so their inputs part
by float32 rounding (measured 3.0e-6). Held:

- JAX's loss rebuilt from its own modules (``DRUNet.apply``,
  ``losses.loss_calc``) at JAX's input equals the step's reported
  ``seg_s + seg_style`` (rtol 1e-6: the metrics are float32);
- directional central differences of that loss along three seeded random
  unit directions of the segmentor's parameters agree with each package's
  gradient dotted with the direction, each at its own input. A difference
  is a least-squares fit of the odd part ``(L(t) - L(-t)) / 2 = g t + c
  t^3`` over 16 steps up to ``h`` = 0.02; its error is taken from step
  halving (the same fit up to h / 2). The loss is rough at this scale:
  the slope over +-h differs from the gradient at the point by 2.9-9.2%
  on both sides alike, so the tolerance is twice the halving error plus
  10% of the slope, and the differences cannot part two gradients 5-7%
  apart;
- ``jax.grad`` of that one loss (no ``vjp`` of two cotangents) at each
  package's input equals the package's gradient: JAX's step to 1e-9
  (measured 4e-15), the port's to 1e-4 (measured 2e-6) of the largest
  entry of each leaf.

So neither autograd is wrong. At this input the gradient of the seg losses
moves by 13.6% (max over leaves) between the two inputs 3e-6 apart; the
packages' 5-7% and a one-entry central difference (step 1e-3) were that
sensitivity. ``style_alpha=1`` shows it less (1e-5 between the packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rain_common as C
from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models.rain import RAIN as TRAIN
from slcl_torch.train.state import create_train_state
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models.drunet import DRUNet
from slcl_tpu.models.rain import RAIN
from slcl_tpu.ops import losses as JL
from slcl_tpu.train.state import create_train_state as j_create_train_state
from slcl_tpu.train.steps import build_step
from slcl_tpu.train.steps_rain import stylized_to_gray3

torch.set_num_threads(1)

H, W, BS, SIZES = C.H, C.W, C.BS, C.SIZES
ALPHA = 0.5
SCHED = {"lr": 1.0, "lr_dis": 1e-4, "warm": 0.0, "fresh": 1.0, "eps_on": 0.0}
FD_H, FD_N = 0.02, 16


def _cfg(cls, recipe):
    cfg = cls()
    cfg.method = "mccl"
    cfg = recipe(cfg)
    cfg.data.crop, cfg.data.bs = H, BS
    for k, v in SIZES.items():
        setattr(cfg.model, k, v)
    cfg.rain.enabled, cfg.rain.update_eps = True, True
    cfg.rain.style_alpha, cfg.rain.consist_w = ALPHA, 0.0
    cfg.optim.weight_decay = 0.0
    return cfg


@pytest.fixture(scope="module")
def run():
    cfg, tcfg = _cfg(Config, apply_recipe), _cfg(TConfig, t_apply_recipe)
    assert not cfg.contrastive.seg_pseudo and cfg.optim.optimizer == "sgd"
    seg_v = C.draw_variables(lambda: DRUNet(**SIZES, phead=True, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), True), 1)
    params = C.rain_params(4, H)
    rng = np.random.default_rng(7)
    batch = {"img_s": rng.normal(0.5, 0.25, size=(BS, H, W, 3)).astype(np.float32),
             "lab_s": rng.integers(0, 4, size=(BS, H, W)).astype(np.int32),
             "img_t": rng.normal(0.4, 0.3, size=(BS, H, W, 3)).astype(np.float32),
             "img_t_aug": rng.normal(0.4, 0.3, size=(BS, H, W, 3)).astype(np.float32)}
    with jax.enable_x64(True):
        f64 = jnp.float64
        state, txs = j_create_train_state(cfg, C.Preset(C.f64_tree(seg_v, f64)),
                                          sample_shape=(1, H, W, 3),
                                          centroids=jnp.zeros((4, SIZES["filters"]), f64))
        rain_model, p64 = RAIN(dtype=f64), C.f64_tree(params, f64)
        state = state.replace(extra={"rain": p64}, sampling=jnp.zeros((1, 512), f64))
        model = DRUNet(**SIZES, phead=True, dtype=f64)
        step = build_step(cfg, model, txs, rain_model=rain_model)
        jb = {k: jnp.asarray(v, f64 if v.dtype == np.float32 else None)
              for k, v in batch.items()}
        _, part, key = jax.random.split(state.rng, 3)
        content, style = jb["img_s"][0:1], jb["img_t"][0:1]
        noise = C.jax_noise(rain_model, p64, content, style, key)
        new, metrics = step(state, jb, {k: jnp.asarray(v, jnp.float32) for k, v in SCHED.items()})
        theta0 = C.np_tree(state.seg.params)
        g_jax = jax.tree.map(lambda a, b: a - b, theta0, C.np_tree(new.seg.params))

        @jax.jit
        def jax_input(p):
            # the step's own stylisation: a fresh sampling, then the blend
            _, fresh = rain_model.apply({"params": p}, content, style, None,
                                        method="style_transfer", rngs={"noise": key})
            sty, _ = rain_model.apply({"params": p}, content, style, fresh,
                                      method="style_transfer", rngs={"noise": key})
            sty = ALPHA * stylized_to_gray3(sty) + (1 - ALPHA) * jb["img_s"][:1]
            return jnp.concatenate([sty, jb["img_s"]], 0)

        x_jax = jax_input(p64)

    # the port: its input captured, its gradient from the step's SGD move
    seg = load_flax_weights(TDRUNet(phead=True, **SIZES).double().to(
        memory_format=torch.channels_last), seg_v["params"], seg_v["batch_stats"])
    tstate = create_train_state(tcfg, seg, centroids=torch.zeros(4, SIZES["filters"],
                                                                 dtype=torch.float64))
    tstate.rain = load_flax_weights(TRAIN().double(), params).requires_grad_(False).eval()
    tstate.sampling = torch.zeros(1, 512, dtype=torch.float64)
    tstep = t_build_step(
        tcfg, draw_assign=lambda m, P, dev: torch.from_numpy(
            np.array(C.jax_randint(part, m, P), np.int32)),
        draw_noise=lambda shape, dev: torch.from_numpy(noise))
    seen = []
    hook = seg.register_forward_pre_hook(
        lambda m, args: None if seen else seen.append(args[0].detach().clone()))
    before = state_dict_to_flax(seg)["params"]
    tstep(tstate, {k: torch.from_numpy(v).double() if v.dtype == np.float32
                   else torch.from_numpy(v) for k, v in batch.items()}, SCHED)
    hook.remove()
    g_port = jax.tree.map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
                          before, state_dict_to_flax(seg)["params"])
    return {"theta0": theta0, "g_jax": g_jax, "g_port": g_port, "x_jax": np.asarray(x_jax),
            "x_port": seen[0].numpy(), "metrics": {k: float(v) for k, v in metrics.items()},
            "model": model, "bstats": state.seg.batch_stats, "lab": batch["lab_s"]}


def _loss(run, x):
    """The JAX step's loss at input ``x``: its source forward and its two
    seg losses (CE + Jaccard on the source, on the stylised image)."""
    model, bstats = run["model"], run["bstats"]
    lab = jnp.asarray(run["lab"])

    def loss(theta):
        out, _ = model.apply({"params": theta, "batch_stats": bstats}, x, True,
                             mutable=["batch_stats"])
        return (JL.loss_calc(out.pred[1:], lab, jaccard=True)
                + JL.loss_calc(out.pred[:1], lab[:1], jaccard=True))
    return jax.jit(loss)


def _leaves(tree, like):
    """``tree``'s leaves in the order of ``like``'s paths."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(like)[0]:
        node = tree
        for p in path:
            node = node[p.key]
        out.append(np.asarray(node, np.float64))
    return out


def test_inputs_part_by_float32_rounding_and_the_loss_is_the_steps(run):
    assert np.abs(run["x_port"] - run["x_jax"]).max() < 1e-5
    with jax.enable_x64(True):
        got = float(_loss(run, jnp.asarray(run["x_jax"]))(C.f64_tree(run["theta0"])))
    m = run["metrics"]
    assert got == pytest.approx(m["seg_s"] + m["seg_style"], rel=1e-6)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_each_gradient_is_jax_grad_of_the_steps_loss_at_its_input(run, side):
    with jax.enable_x64(True):
        grad = jax.grad(_loss(run, jnp.asarray(run[f"x_{side}"])))(C.f64_tree(run["theta0"]))
    tol = 1e-9 if side == "jax" else 1e-4
    for path, want in jax.tree_util.tree_flatten_with_path(C.np_tree(grad))[0]:
        node = run[f"g_{side}"]
        for p in path:
            node = node[p.key]
        scale = np.abs(want).max()
        if scale == 0:      # conv1_1 and the projection head: no gradient
            assert np.abs(node).max() == 0, jax.tree_util.keystr(path)
            continue
        assert np.abs(node - want).max() <= tol * scale, jax.tree_util.keystr(path)


def _fd_slope(loss, theta, d, h, n):
    """Slope of ``loss`` along ``d`` from central differences at steps
    h k / n, k = 1..n: a least-squares fit of (L(t) - L(-t)) / 2 = g t + c t^3."""
    flat, tdef = jax.tree.flatten(theta)
    ts = h * np.arange(1, n + 1) / n
    ys = []
    for t in ts:
        up = jax.tree.unflatten(tdef, [a + t * b for a, b in zip(flat, d)])
        dn = jax.tree.unflatten(tdef, [a - t * b for a, b in zip(flat, d)])
        ys.append((float(loss(up)) - float(loss(dn))) / 2)
    return np.linalg.lstsq(np.stack([ts, ts ** 3], 1), np.array(ys), rcond=None)[0][0]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_central_differences_of_the_steps_loss_match_each_gradient(run, side):
    """The slope over +-h agrees with the gradient at the point within the
    halving error plus 10% of the slope: the loss is rough at this scale
    (measured 2.9-9.2%, both sides alike), so the differences cannot part
    the two gradients, which are 5-7% apart."""
    with jax.enable_x64(True):
        theta = C.f64_tree(run["theta0"])
        loss = _loss(run, jnp.asarray(run[f"x_{side}"]))
        flat = jax.tree.leaves(theta)
        g = _leaves(run[f"g_{side}"], run["theta0"])
        rng = np.random.default_rng(0)
        for k in range(3):
            d = [rng.normal(size=a.shape) for a in flat]
            norm = np.sqrt(sum((x ** 2).sum() for x in d))
            d = [x / norm for x in d]
            full = _fd_slope(loss, theta, d, FD_H, FD_N)
            half = _fd_slope(loss, theta, d, FD_H / 2, FD_N // 2)
            tol = 2 * abs(full - half) + 0.1 * abs(half)
            dot = sum((a * b).sum() for a, b in zip(g, d))
            assert abs(dot - half) <= tol, (side, k, dot, full, half, tol)


def test_the_gradient_is_that_sensitive_to_the_input(run):
    """``jax.grad`` of the same loss at the two inputs (3e-6 apart) parts by
    more than 5% of a leaf's largest entry (measured 13.6%): the whole gap
    between the packages."""
    with jax.enable_x64(True):
        theta = C.f64_tree(run["theta0"])
        grads = [C.np_tree(jax.grad(_loss(run, jnp.asarray(run[f"x_{s}"])))(theta))
                 for s in ("jax", "port")]
    worst = max(np.abs(a - b).max() / np.abs(a).max()
                for a, b in zip(jax.tree.leaves(grads[0]), jax.tree.leaves(grads[1]))
                if np.abs(a).max() > 0)
    assert worst > 0.05
