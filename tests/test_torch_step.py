"""The slice as a whole: two ``slcl`` steps (DRUNet multilvl, CNR, both
discriminators) in the port against two steps of the JAX package's
``create_train_state`` + ``build_step``, from the same weights, batches and
``sched``, on the CPU in f32.

Compared after each step: every metric, the segmentor parameters, the
BatchNorm running statistics, both discriminators' parameters and the EMA
class centres. Two steps exercise SGD momentum and Adam's moments.

Tolerances (the same f32 computation, with convolutions and reductions
summed in another order by XLA and by PyTorch; none looser than rtol 1e-3 /
atol 1e-4):
  metrics          rtol 1e-4, atol 1e-5
  segmentor params rtol 1e-4, atol 1e-6 (an SGD step of lr 8e-4 moves them
                   by ~1e-4 or less; a relative 1e-2 error in that move stays
                   inside atol)
  discriminators   rtol 1e-4, atol 1e-5 (Adam's first steps move every
                   parameter by up to lr_dis = 1e-4 whatever the size of its
                   gradient; where |g| is near Adam's eps 1e-8, f32 noise in g
                   changes that step by a few 1e-2 of lr_dis: 1.4e-6 measured)
  running stats    rtol 1e-4, atol 1e-5
  centres          rtol 1e-4, atol 1e-5
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
from slcl_torch.train.state import create_train_state as t_create_train_state
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models import UncertaintyDiscriminator, build_segmentor
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)

H = W = 32
BS = 2
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2)


def _cfg(cls, recipe):
    cfg = cls()
    cfg.method = "slcl"
    cfg = recipe(cfg)
    cfg.model.multilvl = True
    cfg.model.dtype = "float32"
    cfg.data.crop, cfg.data.bs = H, BS
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


@pytest.fixture(scope="module")
def runs():
    cfg = _cfg(Config, apply_recipe)
    assert cfg.contrastive.CNR and cfg.model.multilvl
    model = build_segmentor(cfg.model)
    disc = UncertaintyDiscriminator(dtype=jnp.float32)
    disc_aux = UncertaintyDiscriminator(dtype=jnp.float32)
    zeros = jnp.zeros((cfg.model.num_classes, cfg.model.filters), jnp.float32)
    state, txs = create_train_state(cfg, model, disc=disc, disc_aux=disc_aux,
                                    sample_shape=(1, H, W, 3), centroids=zeros)
    step = build_step(cfg, model, txs, disc, disc_aux)

    tcfg = _cfg(TConfig, t_apply_recipe)
    seg = load_flax_weights(TDRUNet(multilvl=True, **SIZES).to(
        memory_format=torch.channels_last), _np(state.seg.params),
        _np(state.seg.batch_stats))
    d_main = load_flax_weights(TDisc(), _np(state.d_main.params))
    d_aux = load_flax_weights(TDisc(), _np(state.d_aux.params))
    tstate = t_create_train_state(tcfg, seg, disc=d_main, disc_aux=d_aux,
                                  centroids=torch.zeros(4, SIZES["filters"]))
    tstep = t_build_step(tcfg)

    rng = np.random.default_rng(7)
    sched = {"lr": 8e-4, "lr_dis": 1e-4, "warm": 1.0}
    jsched = {k: jnp.asarray(v, jnp.float32) for k, v in sched.items()}
    out = []
    for _ in range(2):
        batch = {"img_s": rng.normal(size=(BS, H, W, 3)).astype(np.float32),
                 "lab_s": rng.integers(0, 4, size=(BS, H, W)).astype(np.int32),
                 "img_t": rng.normal(size=(BS, H, W, 3)).astype(np.float32)}
        state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jsched)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, sched)
        out.append((
            {k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()},
            _np({"seg": state.seg.params, "bs": state.seg.batch_stats,
                 "d_main": state.d_main.params, "d_aux": state.d_aux.params,
                 "centroids": state.centroids}),
            {"seg": state_dict_to_flax(tstate.seg), "d_main": state_dict_to_flax(
                tstate.d_main)["params"], "d_aux": state_dict_to_flax(
                tstate.d_aux)["params"], "centroids": tstate.centroids.numpy().copy()}))
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_metrics_match(runs, i):
    want, got, _, _ = runs[i]
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("part", ["seg", "d_main", "d_aux"])
def test_parameters_match(runs, i, part):
    _, _, want, got = runs[i]
    got_tree = got[part]["params"] if part == "seg" else got[part]
    atol = 1e-6 if part == "seg" else 1e-5
    _assert_tree_close(got_tree, want[part], 1e-4, atol, f"step {i} {part}")


@pytest.mark.parametrize("i", [0, 1])
def test_running_stats_and_centres_match(runs, i):
    _, _, want, got = runs[i]
    _assert_tree_close(got["seg"]["batch_stats"], want["bs"], 1e-4, 1e-5,
                       f"step {i} batch_stats")
    np.testing.assert_allclose(got["centroids"], want["centroids"], rtol=1e-4, atol=1e-5)
