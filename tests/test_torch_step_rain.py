"""RAIN's own steps on the port against ``slcl_tpu/train/steps_rain.py``, on
the CPU, from the same weights (the RAIN net's drawn with numpy, DRUNet's
from flax's init, both moved to torch), batches, ``sched`` and noise: the
noise the JAX step draws (``jax.random.split(state.rng)``, then flax's
``make_rng``) is recovered as ``(sampling - mean) / std`` from its
``fc_encoder`` and handed to the port through ``build_step(...,
draw_noise=)``.

- ``pretrain_rain``, two Adam steps: the four losses, the parameters after
  each step, the encoder unchanged. In float64 on both sides
  (``jax.enable_x64``, the port's module in double): Adam's first update is
  ``lr * g / (|g| + eps)``, which turns a float32 rounding difference in a
  small gradient entry into a difference of up to ``2 * lr``, and the
  pretraining gradient runs through two VGG passes (see
  ``tests/test_torch_rain_model.py``). The JAX side keeps its statistics in
  float32.
- ``rain``, a fresh iteration then a carried one with the ascent on: the
  metrics, the sampling, the segmentor parameters and the BatchNorm
  statistics; in float64 on both sides too, since the ascent's gradient
  runs back through the style net's decoder, where the CPU's float32
  convolutions (oneDNN) are 1e-3 off in relative terms (both packages'
  losses still accumulate in float32).
- ``clip_step_norm`` on non-finite input, and ``stylized_branch_triggers``
  against JAX's on the same histories.

Tolerances as ``tests/test_torch_step_mccl.py``: metrics rtol 1e-4 / atol
1e-5, parameters rtol 1e-4 / atol 1e-6, running statistics and the
sampling rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models.rain import RAIN as TRAIN
from slcl_torch.train import steps as t_steps
from slcl_torch.train.state import create_pretrain_rain_state, create_train_state
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.train.trainer import stylized_branch_triggers as t_triggers
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config
from slcl_tpu.models.drunet import DRUNet
from slcl_tpu.models.rain import RAIN, calc_feat_mean_std
from slcl_tpu.train import steps as j_steps
from slcl_tpu.train.state import NetState, TrainState, make_optimizer
from slcl_tpu.train.state import create_train_state as j_create_train_state
from slcl_tpu.train.steps_rain import make_pretrain_rain_step, make_rain_seg_step
from slcl_tpu.train.trainer import stylized_branch_triggers as j_triggers

torch.set_num_threads(1)

H = W = 64
BS = 2
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def rain_params(seed=0):
    """RAIN weights drawn with numpy at flax's shapes: He-normal kernels,
    small biases (flax's op-by-op init of the VGG pair takes ~13 s on the CPU)."""
    x = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a: RAIN().init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, a, a), x)
    rng = np.random.default_rng(seed)

    def draw(leaf):
        if len(leaf.shape) == 1:
            return rng.normal(0.0, 0.01, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0.0, np.sqrt(2.0 / fan_in), leaf.shape).astype(np.float32)

    return jax.tree.map(draw, shapes["params"])


def jax_noise(model, params, content, style, key):
    """The noise of ``style_transfer``/``losses`` under ``rngs={'noise': key}``."""
    _, samp = model.apply({"params": params}, content, style, None,
                          method="style_transfer", rngs={"noise": key})
    stats = calc_feat_mean_std(model.apply({"params": params}, style, method="encode"))
    inter = model.apply({"params": params}, stats, method=lambda m, s: m.fc_encoder(s))
    return np.array((samp - inter[:, :512]) / inter[:, 512:])


def _assert_tree_close(got, want, rtol, atol, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")
    assert len(jax.tree.leaves(got)) == len(flat_w), what


def _images(rng, n, mean=0.5, std=0.25):
    return rng.normal(mean, std, size=(n, H, W, 3)).astype(np.float32)


# ---- pretrain_rain -----------------------------------------------------
LR_PRETRAIN = 1e-4


@pytest.fixture(scope="module")
def pretrain_runs():
    params = rain_params(1)
    cfg = Config()
    cfg.method = "pretrain_rain"
    tcfg = TConfig()
    tcfg.method = "pretrain_rain"
    tcfg.optim.lr = LR_PRETRAIN
    rng = np.random.default_rng(3)
    batches = [{"img_s": _images(rng, BS), "img_t": _images(rng, 1, 0.4, 0.3)}
               for _ in range(2)]
    out = []
    with jax.enable_x64():
        model = RAIN(dtype=jnp.float64)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        tx = make_optimizer("adam", LR_PRETRAIN)
        state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(4),
                           seg=NetState(params=p64, batch_stats={},
                                        opt_state=tx.init(p64)))
        step = make_pretrain_rain_step(cfg, model, {"seg": tx})
        port = load_flax_weights(TRAIN().double(), _np(p64))
        tstate = create_pretrain_rain_state(tcfg, port)
        draw = {}
        tstep = t_build_step(tcfg, draw_noise=lambda shape, dev: torch.from_numpy(
            draw["noise"]).to(dev))
        sched = {"lr": jnp.asarray(LR_PRETRAIN, jnp.float64)}
        for b in batches:
            jb = {k: jnp.asarray(v, jnp.float64) for k, v in b.items()}
            _, rng_noise = jax.random.split(state.rng)
            draw["noise"] = jax_noise(model, state.seg.params, jb["img_s"], jb["img_t"],
                                      rng_noise)
            assert draw["noise"].shape == (1, 512)
            state, jm = step(state, jb, sched)
            tm = tstep(tstate, {k: torch.from_numpy(v).double() for k, v in b.items()},
                       {"lr": LR_PRETRAIN})
            out.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()},
                        _np(state.seg.params), state_dict_to_flax(tstate.seg)["params"]))
    return params, out


@pytest.mark.parametrize("i", [0, 1])
def test_pretrain_rain_losses_match(pretrain_runs, i):
    _, out = pretrain_runs
    want, got, _, _ = out[i]
    assert set(got) == set(want) == {"loss_c", "loss_s", "loss_l", "loss_r"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("i", [0, 1])
def test_pretrain_rain_parameters_match_and_encoder_is_unchanged(pretrain_runs, i):
    params, out = pretrain_runs
    _, _, want, got = out[i]
    _assert_tree_close(got, want, 1e-4, 1e-6, f"pretrain step {i}")
    for a, b in zip(jax.tree.leaves(got["encoder"]), jax.tree.leaves(params["encoder"])):
        np.testing.assert_array_equal(a, b)
    for part in ("decoder", "fc_encoder", "fc_decoder"):
        moved = [not np.array_equal(a, b) for a, b in
                 zip(jax.tree.leaves(got[part]), jax.tree.leaves(params[part]))]
        assert all(moved), part


# ---- rain (segmentation with RAIN) -------------------------------------
class _Preset:
    """Stands in for a flax module in ``create_train_state``: its ``init``
    returns the given variables."""

    def __init__(self, variables):
        self.variables = variables

    def init(self, *args):
        return self.variables


@pytest.fixture(scope="module")
def rain_runs():
    params = rain_params(2)
    cfg = Config()
    cfg.method = "rain"
    tcfg = TConfig()
    tcfg.method = "rain"
    for c in (cfg, tcfg):
        c.rain.enabled = True
        for k, v in SIZES.items():
            setattr(c.model, k, v)
    seg_v = DRUNet(**SIZES, dtype=jnp.float32).init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, H, W, 3)), True)
    seg = load_flax_weights(TDRUNet(**SIZES).double().to(memory_format=torch.channels_last),
                            _np(seg_v["params"]), _np(seg_v["batch_stats"]))
    tstate = create_train_state(tcfg, seg)
    tstate.rain = load_flax_weights(TRAIN().double(), _np(params)).requires_grad_(False).eval()
    tstate.sampling = torch.zeros(1, 512, dtype=torch.float64)
    draw = {}
    tstep = t_build_step(tcfg, draw_noise=lambda shape, dev: torch.from_numpy(
        draw["noise"]).to(dev))
    rng = np.random.default_rng(5)
    batch = {"img_s": _images(rng, BS), "lab_s": rng.integers(0, 4, (BS, H, W)).astype(np.int32),
             "img_t": _images(rng, BS, 0.4, 0.3)}
    tb = {k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
          for k, v in batch.items()}
    out = []
    with jax.enable_x64():
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        state, txs = j_create_train_state(cfg, _Preset(f64(seg_v)), sample_shape=(1, H, W, 3))
        rain_model, p64 = RAIN(dtype=jnp.float64), f64(params)
        state = state.replace(extra={"rain": p64}, sampling=jnp.zeros((1, 512), jnp.float64))
        step = make_rain_seg_step(cfg, DRUNet(**SIZES, dtype=jnp.float64), rain_model, txs)
        jb = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else None)
              for k, v in batch.items()}
        for fresh, eps_on in ((1.0, 0.0), (0.0, 1.0)):
            sched = {"lr": 1e-3, "fresh": fresh, "eps_on": eps_on}
            _, rng_noise = jax.random.split(state.rng)
            draw["noise"] = jax_noise(rain_model, p64, jb["img_s"][0:1], jb["img_t"][0:1],
                                      rng_noise)
            state, jm = step(state, jb, {k: jnp.asarray(v, jnp.float64)
                                         for k, v in sched.items()})
            tm = tstep(tstate, tb, sched)
            out.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()},
                        _np({"seg": state.seg.params, "bs": state.seg.batch_stats,
                             "sampling": state.sampling}),
                        {"seg": state_dict_to_flax(tstate.seg),
                         "sampling": tstate.sampling.numpy().copy()}))
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_rain_step_metrics_and_sampling_match(rain_runs, i):
    want, got, want_state, got_state = rain_runs[i]
    assert set(got) == set(want) == {"seg", "loss_consist"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k
    np.testing.assert_allclose(got_state["sampling"], want_state["sampling"],
                               rtol=1e-4, atol=1e-5)
    if i == 1:      # the ascent moved the carried sampling
        assert not np.allclose(rain_runs[1][2]["sampling"], rain_runs[0][2]["sampling"])


@pytest.mark.parametrize("i", [0, 1])
def test_rain_step_parameters_and_running_stats_match(rain_runs, i):
    _, _, want, got = rain_runs[i]
    _assert_tree_close(got["seg"]["params"], want["seg"], 1e-4, 1e-6, f"rain step {i}")
    _assert_tree_close(got["seg"]["batch_stats"], want["bs"], 1e-4, 1e-5,
                       f"rain step {i} batch_stats")


# ---- plain pieces ------------------------------------------------------
@pytest.mark.parametrize("case", ["finite_over", "finite_under", "inf", "nan", "all_inf"])
def test_clip_step_norm_matches_jax(case):
    rng = np.random.default_rng(8)
    v = rng.normal(0.0, {"finite_under": 0.01}.get(case, 5.0), size=(2, 512)).astype(np.float32)
    if case == "inf":
        v[0, 3], v[1, 7] = np.inf, -np.inf
    elif case == "nan":
        v[1, 0] = np.nan
    elif case == "all_inf":
        v[:] = np.inf
    got = t_steps.clip_step_norm(torch.from_numpy(v), 3.0).numpy()
    want = np.asarray(j_steps.clip_step_norm(jnp.asarray(v), 3.0))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.linalg.norm(got) <= 3.0 * (1 + 1e-6)


def _history(style, src, epochs=6):
    return [{"epoch": e, **{f"dice_style_c{c}": style[c - 1] for c in (1, 2, 3)},
             **{f"dice_src_c{c}": src[c - 1] for c in (1, 2, 3)}} for e in range(epochs)]


@pytest.mark.parametrize("history", [
    _history((0.01, 0.3, 0.02), (0.9, 0.9, 0.5)),        # class 1 triggers, 3 not
    _history((0.4, 0.3, 0.2), (0.95, 0.9, 0.9)),         # healthy
    _history((0.0, 0.0, 0.0), (0.99, 0.99, 0.99), 4),    # the window is incomplete
    [{"epoch": e, "val_dice": 0.5} for e in range(6)],   # no RAIN diagnostics
])
def test_stylized_branch_triggers_match_jax(history):
    assert t_triggers(history) == j_triggers(history)
