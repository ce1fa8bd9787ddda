"""Helpers shared by the RAIN parity tests of the port (``test_torch_*rain*``):
numpy-drawn variables at a flax module's shapes, the JAX step's RAIN noise,
tree comparisons, and the MCCL + RAIN runs of
``test_torch_step_mccl_rain*.py`` (see the first of them)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models.rain import RAIN as TRAIN
from slcl_torch.train.state import create_train_state
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models.drunet import DRUNet
from slcl_tpu.models.rain import RAIN, calc_feat_mean_std
from slcl_tpu.train.state import create_train_state as j_create_train_state
from slcl_tpu.train.steps import build_step


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def f64_tree(tree, dtype=jnp.float64):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def draw_variables(init, seed):
    """Variables drawn with numpy at the shapes ``init()`` gives under
    ``jax.eval_shape`` (flax's op-by-op ``init`` takes tens of seconds on the
    CPU): He-normal kernels, BatchNorm scales 1 + 0.1 N(0, 1), variances
    |N(0, 1)| + 0.5, means and biases 0.01 N(0, 1)."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, n = path[-1].key, rng.normal(size=leaf.shape)
        if name == "kernel":
            n = n * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        elif name == "var":
            n = np.abs(n) + 0.5
        else:
            n = 0.01 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def rain_params(seed, size=64):
    x = jnp.zeros((1, size, size, 3))
    return draw_variables(lambda: RAIN().init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, x, x),
        seed)["params"]


@functools.partial(jax.jit, static_argnums=0)
def _noise(model, params, content, style, key):
    _, samp = model.apply({"params": params}, content, style, None,
                          method="style_transfer", rngs={"noise": key})
    stats = calc_feat_mean_std(model.apply({"params": params}, style, method="encode"))
    inter = model.apply({"params": params}, stats, method=lambda m, s: m.fc_encoder(s))
    return (samp - inter[:, :512]) / inter[:, 512:]


def jax_noise(model, params, content, style, key):
    """The noise flax draws in ``RAIN.style_transfer`` / ``RAIN.losses``
    under ``rngs={'noise': key}`` (both draw the same), recovered as
    ``(sampling - mean) / std`` from the net's ``fc_encoder``."""
    return np.array(_noise(model, params, content, style, key))


@functools.partial(jax.jit, static_argnums=(1, 2))
def jax_randint(key, m, parts):
    return jax.random.randint(key, (m,), 0, parts)


class Preset:
    """Stands in for a flax module in ``create_train_state``: its ``init``
    returns the given variables."""

    def __init__(self, variables):
        self.variables = variables

    def init(self, *args):
        return self.variables


def assert_tree_close(got, want, rtol, atol, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")
    assert len(jax.tree.leaves(got)) == len(flat_w), what


# ---- MCCL + RAIN runs ----------------------------------------------------
H = W = 64
BS = 2
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2)
RUNS = {"default": {},
        "mulstyle": {"mulstyle": True},
        "mulstyle2": {"mulstyle2": True},
        "mulstyle2_clip": {"mulstyle2": True, "eps_clip": 3.0, "lr_eps": 300.0},
        "style_alpha": {"style_alpha": 0.5, "eps_on": 0.0},
        "concat_forward": {"concat_forward": True, "eps_clip": 3.0, "lr_eps": 300.0}}
RAIN_BASE = {"enabled": True, "update_eps": True}
_SECTION = {"concat_forward": "contrastive", "lr_eps": "optim"}
DIAGNOSTICS = {"seg_style", "loss_consist", "style_hist_d", "style_mean", "style_std",
               "src_mean", "eps_step_norm", "sampling_norm", "seg_style_val",
               *(f"dice_{t}_c{k}" for t in ("style", "src") for k in (1, 2, 3))}


def _mccl_cfg(cls, recipe, run):
    cfg = cls()
    cfg.method = "mccl"
    cfg = recipe(cfg)
    cfg.data.crop, cfg.data.bs = H, BS
    for k, v in SIZES.items():
        setattr(cfg.model, k, v)
    for k, v in {**RAIN_BASE, **RUNS[run]}.items():
        if k != "eps_on":
            setattr(getattr(cfg, _SECTION.get(k, "rain")), k, v)
    return cfg


def _rain_pair(rain_cfg, img_s, img_t):
    if rain_cfg.mulstyle2:
        return img_s, img_t[0:1]
    if rain_cfg.mulstyle:
        return img_s, img_t
    return img_s[0:1], img_t[0:1]


def mccl_rain_iterations(run):
    """Two epsilon iterations of one batch, JAX's and the port's, in float64,
    and JAX's in float32: per iteration (JAX's metrics, the port's, JAX's
    state, the port's, JAX's float32 metrics, its float32 state)."""
    out = _mccl_rain_iterations(run, True)
    return [o + f for o, f in zip(out, _mccl_rain_iterations(run, False))]


def _mccl_rain_iterations(run, x64):
    cfg = _mccl_cfg(Config, apply_recipe, run)
    tcfg = _mccl_cfg(TConfig, t_apply_recipe, run)
    assert cfg.model.phead and cfg.contrastive.part == 2 and cfg.rain.enabled
    n_sty = BS if cfg.rain.mulstyle and not cfg.rain.mulstyle2 else 1
    seg_v = draw_variables(lambda: DRUNet(**SIZES, phead=True, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), True), 1)
    params = rain_params(4, H)
    seg = load_flax_weights(TDRUNet(phead=True, **SIZES).double().to(
        memory_format=torch.channels_last), seg_v["params"], seg_v["batch_stats"])
    tstate = create_train_state(tcfg, seg, centroids=torch.zeros(4, SIZES["filters"],
                                                                 dtype=torch.float64))
    tstate.rain = load_flax_weights(TRAIN().double(), params).requires_grad_(False).eval()
    tstate.sampling = torch.zeros(n_sty, 512, dtype=torch.float64)
    draw = {}

    def jax_draw(m, P, device):
        ids = jax_randint(draw["part"], m, P)
        return torch.from_numpy(np.array(ids, np.int32)).to(device)

    tstep = t_build_step(tcfg, draw_assign=jax_draw,
                         draw_noise=lambda shape, dev: torch.from_numpy(draw["noise"]).to(dev))
    rng = np.random.default_rng(7)
    batch = {"img_s": rng.normal(0.5, 0.25, size=(BS, H, W, 3)).astype(np.float32),
             "lab_s": rng.integers(0, 4, size=(BS, H, W)).astype(np.int32),
             "img_t": rng.normal(0.4, 0.3, size=(BS, H, W, 3)).astype(np.float32),
             "img_t_aug": rng.normal(0.4, 0.3, size=(BS, H, W, 3)).astype(np.float32)}
    tb = {k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
          for k, v in batch.items()}
    out = []
    with jax.enable_x64(x64):
        f64 = jnp.float64 if x64 else jnp.float32
        state, txs = j_create_train_state(cfg, Preset(f64_tree(seg_v, f64)),
                                          sample_shape=(1, H, W, 3),
                                          centroids=jnp.zeros((4, SIZES["filters"]), f64))
        rain_model, p64 = RAIN(dtype=f64), f64_tree(params, f64)
        state = state.replace(extra={"rain": p64}, sampling=jnp.zeros((n_sty, 512), f64))
        step = build_step(cfg, DRUNet(**SIZES, phead=True, dtype=f64), txs,
                          rain_model=rain_model)
        jb = {k: jnp.asarray(v, f64 if v.dtype == np.float32 else None)
              for k, v in batch.items()}
        for fresh in (1.0, 0.0):
            sched = {"lr": 8e-4, "lr_dis": 1e-4, "warm": 1.0, "fresh": fresh,
                     "eps_on": RUNS[run].get("eps_on", 1.0)}
            _, draw["part"], rng_noise = jax.random.split(state.rng, 3)
            draw["noise"] = jax_noise(rain_model, p64,
                                      *_rain_pair(cfg.rain, jb["img_s"], jb["img_t"]),
                                      rng_noise)
            # float32 scalars: JAX's two cotangents must match the dtypes of
            # the total and the stylised seg loss, which its losses keep in
            # float32
            state, jm = step(state, jb, {k: jnp.asarray(v, jnp.float32)
                                         for k, v in sched.items()})
            jrec = ({k: float(v) for k, v in jm.items()},
                    np_tree({"seg": state.seg.params, "bs": state.seg.batch_stats,
                             "centroids": state.centroids, "sampling": state.sampling}))
            if not x64:
                out.append(jrec)
                continue
            tm = tstep(tstate, tb, sched)
            out.append((jrec[0], {k: float(v) for k, v in tm.items()}, jrec[1],
                        {"seg": state_dict_to_flax(tstate.seg),
                         "centroids": tstate.centroids.double().numpy().copy(),
                         "sampling": tstate.sampling.numpy().copy()}))
    return out


def _close(got, want, floor, rtol, atol, what):
    """|got - want| <= atol + rtol |want| + max |floor - want| elementwise: the
    float32 JAX run ``floor`` beside the float64 ``want``."""
    got, want, floor = (np.asarray(a, np.float64) for a in (got, want, floor))
    lim = atol + rtol * np.abs(want) + np.abs(floor - want).max()
    bad = np.abs(got - want) > lim
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} off, max |err| "
                           f"{np.abs(got - want).max():.3g}, JAX float32's "
                           f"{np.abs(floor - want).max():.3g}")


def check_metrics(out, run, i):
    want, got, _, _, floor, _ = out[i]
    assert set(got) == set(want) == set(floor) and DIAGNOSTICS <= set(got)
    for k in want:
        _close(got[k], want[k], floor[k], 1e-4, 1e-5, f"{run} iteration {i} {k}")
    if RUNS[run].get("eps_clip"):
        # the clip binds: the unclipped step is longer than 3
        assert got["eps_step_norm"] == pytest.approx(3.0, rel=1e-5)
    elif RUNS[run].get("eps_on", 1.0) == 0.0:
        assert got["eps_step_norm"] == 0.0


def check_state(out, run, i):
    _, _, want, got, _, floor = out[i]
    n_sty = BS if RUNS[run].get("mulstyle") else 1
    assert got["sampling"].shape == want["sampling"].shape == (n_sty, 512)
    _close(got["sampling"], want["sampling"], floor["sampling"], 1e-4, 1e-5,
           f"{run} iteration {i} sampling")
    for key, rtol, atol in (("seg", 1e-4, 1e-6), ("bs", 1e-4, 1e-5)):
        flat_w = jax.tree_util.tree_flatten_with_path(want[key])[0]
        for (path, w), f in zip(flat_w, jax.tree.leaves(floor[key])):
            node = got["seg"]["params" if key == "seg" else "batch_stats"]
            for p in path:
                node = node[p.key]
            _close(node, w, f, rtol, atol, f"{run} iteration {i} {key} "
                   f"{jax.tree_util.keystr(path)}")
    _close(got["centroids"], want["centroids"], floor["centroids"], 1e-4, 1e-5,
           f"{run} iteration {i} centres")
