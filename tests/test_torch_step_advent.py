"""Port parity of the protocol's other steps: two ``advent`` steps
(DRUNet multilvl, both discriminators, the direct entropy and class-prior
terms switched on) and one ``baseline`` step (CE + Jaccard with the aux
head) in the port against the JAX package's ``create_train_state`` +
``build_step``, from the same weights, batches and ``sched``, on the CPU in
f32; plus AdvEnt's two optional losses against jnp in value and gradient.

Tolerances are tests/test_torch_step.py's, for the same reasons: metrics
rtol 1e-4 / atol 1e-5; segmentor parameters rtol 1e-4 / atol 1e-6;
discriminators and BatchNorm running statistics rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models import UncertaintyDiscriminator as TDisc
from slcl_torch.ops import losses as TL
from slcl_torch.train.state import create_train_state as t_create_train_state
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models import UncertaintyDiscriminator, build_segmentor
from slcl_tpu.ops import losses as L
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)

H = W = 32
BS = 2
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2)
STEPS = {"advent": 2, "baseline": 1}


def _cfg(cls, recipe, method):
    cfg = cls()
    cfg.method = method
    cfg = recipe(cfg)
    cfg.model.multilvl = True
    cfg.model.dtype = "float32"
    cfg.data.crop, cfg.data.bs = H, BS
    cfg.adv.w_ent, cfg.adv.w_prior = 0.5, 1.0
    for k, v in SIZES.items():
        setattr(cfg.model, k, v)
    return cfg


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _assert_tree_close(got, want, rtol, atol, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")
    assert len(jax.tree.leaves(got)) == len(flat_w), what


def _run(method):
    cfg = _cfg(Config, apply_recipe, method)
    adversarial = method != "baseline"
    model = build_segmentor(cfg.model)
    disc = UncertaintyDiscriminator(dtype=jnp.float32) if adversarial else None
    disc_aux = UncertaintyDiscriminator(dtype=jnp.float32) if adversarial else None
    state, txs = create_train_state(cfg, model, disc=disc, disc_aux=disc_aux,
                                    sample_shape=(1, H, W, 3))
    step = build_step(cfg, model, txs, disc, disc_aux)

    tcfg = _cfg(TConfig, t_apply_recipe, method)
    seg = load_flax_weights(TDRUNet(multilvl=True, **SIZES).to(
        memory_format=torch.channels_last), _np(state.seg.params),
        _np(state.seg.batch_stats))
    d_main = load_flax_weights(TDisc(), _np(state.d_main.params)) if adversarial else None
    d_aux = load_flax_weights(TDisc(), _np(state.d_aux.params)) if adversarial else None
    tstate = t_create_train_state(tcfg, seg, disc=d_main, disc_aux=d_aux)
    tstep = t_build_step(tcfg)

    rng = np.random.default_rng(11)
    sched = {"lr": 8e-4, "lr_dis": 1e-4, "warm": 1.0}
    jsched = {k: jnp.asarray(v, jnp.float32) for k, v in sched.items()}
    out = []
    for _ in range(STEPS[method]):
        # target images drawn from another distribution than the source: with
        # both N(0, 1) the discriminator's source and target gradients nearly
        # cancel, and Adam's first step (lr * sign(g)) then follows f32 noise
        batch = {"img_s": rng.normal(size=(BS, H, W, 3)).astype(np.float32),
                 "lab_s": rng.integers(0, 4, size=(BS, H, W)).astype(np.int32),
                 "img_t": rng.normal(0.5, 2.0, size=(BS, H, W, 3)).astype(np.float32)}
        state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jsched)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, sched)
        want = {"seg": state.seg.params, "bs": state.seg.batch_stats}
        got = {"seg": state_dict_to_flax(tstate.seg)}
        if adversarial:
            want.update(d_main=state.d_main.params, d_aux=state.d_aux.params)
            got.update(d_main=state_dict_to_flax(tstate.d_main)["params"],
                       d_aux=state_dict_to_flax(tstate.d_aux)["params"])
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()}, _np(want), got))
    return out


@pytest.fixture(scope="module")
def runs():
    return {m: _run(m) for m in STEPS}


CASES = [(m, i) for m, n in STEPS.items() for i in range(n)]


@pytest.mark.parametrize("method,i", CASES)
def test_metrics_match(runs, method, i):
    want, got, _, _ = runs[method][i]
    assert set(got) == set(want)
    if method == "advent":
        assert {"loss_ent", "loss_prior", "loss_adv_aux", "loss_dis_aux"} <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("method,i", CASES)
def test_parameters_and_running_stats_match(runs, method, i):
    _, _, want, got = runs[method][i]
    _assert_tree_close(got["seg"]["params"], want["seg"], 1e-4, 1e-6, f"{method} {i} seg")
    _assert_tree_close(got["seg"]["batch_stats"], want["bs"], 1e-4, 1e-5,
                       f"{method} {i} batch_stats")
    for part in ("d_main", "d_aux"):
        if part in want:
            _assert_tree_close(got[part], want[part], 1e-4, 1e-5, f"{method} {i} {part}")


@pytest.mark.parametrize("name", ["entropy_mean", "entropy_sum", "class_prior"])
def test_advent_optional_losses_match_jnp(rng, name):
    logits = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    prior = (0.9146, 0.0253, 0.0309, 0.0292)

    def port(x):
        p = torch.softmax(x, dim=-1)
        if name == "class_prior":
            return TL.loss_class_prior(p, prior, 5.0)
        return TL.loss_entropy(p, 1e-7, mode=name.split("_")[1])

    def ref(x):
        p = jax.nn.softmax(x, axis=-1)
        if name == "class_prior":
            return L.loss_class_prior(p, jnp.asarray(prior), 5.0)
        return L.loss_entropy(p, 1e-7, mode=name.split("_")[1])

    x = torch.from_numpy(logits).requires_grad_(True)
    got = port(x)
    (g,) = torch.autograd.grad(got, x)
    want, gw = jax.value_and_grad(ref)(jnp.asarray(logits))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=1e-4, atol=1e-7)
