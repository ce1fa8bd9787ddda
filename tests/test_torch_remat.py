"""``model.remat`` on the port (``train/steps.py::seg_forward``): the
``slcl`` and ``mccl`` steps rematerialised (``full``: the whole forward
recomputed; ``dots``: convolution and matrix-product outputs kept) against
the same steps without remat, and one ``slcl`` step with remat against the
JAX package's step with the same mode (its ``_remat_wrap``).

Tolerances: against the run without remat, parameters, BatchNorm running
statistics, class centres and every metric within atol 1e-6 in float32
(the recompute runs the forward's own ops on the same inputs; measured
equal). Against JAX, ``tests/test_torch_step.py``'s tolerances.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.data import SyntheticCardiacDataset
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models import UncertaintyDiscriminator as TDisc
from slcl_torch.train.state import create_train_state as t_create_train_state
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.train.steps import remat_mode
from slcl_torch.train.trainer import Trainer
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models import UncertaintyDiscriminator, build_segmentor
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)

H = W = 32
BS = 2
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2)


def _tcfg(method: str, remat: str, dtype: str = "float32") -> TConfig:
    cfg = TConfig()
    cfg.method = method
    cfg = t_apply_recipe(cfg)
    cfg.model.multilvl = method == "slcl"
    cfg.model.dtype = dtype
    cfg.model.remat = remat
    cfg.data.crop, cfg.data.bs = H, BS
    for k, v in SIZES.items():
        setattr(cfg.model, k, v)
    return cfg


def _batches(method: str):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        b = {"img_s": rng.normal(size=(BS, H, W, 3)).astype(np.float32),
             "lab_s": rng.integers(0, 4, size=(BS, H, W)).astype(np.int64),
             "img_t": rng.normal(size=(BS, H, W, 3)).astype(np.float32)}
        if method == "mccl":
            b["img_t_aug"] = rng.normal(size=(BS, H, W, 3)).astype(np.float32)
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


def _run(method: str, remat: str, dtype: str = "float32"):
    """Two steps from the seed's init: per step the metrics, the segmentor's
    state (parameters and running statistics) and the centres."""
    tiny = {k: SyntheticCardiacDataset(2, H, "mr", i)
            for i, k in enumerate(("train_s", "train_t", "valid_t", "test_t"))}
    trainer = Trainer(_tcfg(method, remat, dtype), datasets=tiny, device="cpu")
    sched = {"lr": 8e-4, "lr_dis": 1e-4, "warm": 1.0, "fresh": 1.0, "eps_on": 0.0}
    out = []
    for batch in _batches(method):
        m = trainer.step_fn(trainer.state, batch, sched)
        out.append(({k: float(v) for k, v in m.items()},
                    copy.deepcopy(trainer.state.seg.state_dict()),
                    trainer.state.centroids.clone()))
    return out


@pytest.fixture(scope="module")
def runs():
    out = {(method, mode): _run(method, mode)
           for method in ("slcl", "mccl") for mode in ("", "full", "dots")}
    # the recipes' bf16 autocast: the target forward reuses no cast weight
    # of the source forward inside a checkpointed region
    out.update({("slcl_bf16", mode): _run("slcl", mode, "bfloat16")
                for mode in ("", "full", "dots")})
    return out


@pytest.mark.parametrize("method", ["slcl", "mccl", "slcl_bf16"])
@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_steps_equal_the_steps_without_it(runs, method, mode):
    base, got = runs[(method, "")], runs[(method, mode)]
    before = None
    for i, ((m0, sd0, c0), (m1, sd1, c1)) in enumerate(zip(base, got)):
        assert set(m0) == set(m1)
        for k in m0:
            assert m1[k] == pytest.approx(m0[k], rel=0, abs=1e-6), (i, k)
        assert set(sd0) == set(sd1)
        for k in sd0:
            torch.testing.assert_close(sd1[k], sd0[k], rtol=0, atol=1e-6, msg=f"{i} {k}")
        torch.testing.assert_close(c1, c0, rtol=0, atol=1e-6)
        # the running statistics moved this step, exactly as without remat
        # (one update a forward, none from the recompute)
        stats = {k: v for k, v in sd1.items() if k.endswith("running_mean")}
        assert stats
        if before is not None:
            assert all(not torch.equal(v, before[k]) for k, v in stats.items())
        before = stats


def test_remat_mode_values():
    assert [remat_mode(v) for v in ("", "false", "off", "0", False, "full", "true",
                                    True, "dots")] == ["", "", "", "", "", "full",
                                                        "full", "full", "dots"]
    with pytest.raises(ValueError, match="model.remat"):
        remat_mode("sometimes")


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_slcl_step_matches_jax(mode):
    cfg = Config()
    cfg.method = "slcl"
    cfg = apply_recipe(cfg)
    cfg.model.multilvl, cfg.model.dtype, cfg.model.remat = True, "float32", mode
    cfg.data.crop, cfg.data.bs = H, BS
    for k, v in SIZES.items():
        setattr(cfg.model, k, v)
    model = build_segmentor(cfg.model)
    disc = UncertaintyDiscriminator(dtype=jnp.float32)
    disc_aux = UncertaintyDiscriminator(dtype=jnp.float32)
    zeros = jnp.zeros((cfg.model.num_classes, cfg.model.filters), jnp.float32)
    state, txs = create_train_state(cfg, model, disc=disc, disc_aux=disc_aux,
                                    sample_shape=(1, H, W, 3), centroids=zeros)
    step = build_step(cfg, model, txs, disc, disc_aux)

    tcfg = _tcfg("slcl", mode)
    seg = load_flax_weights(TDRUNet(multilvl=True, **SIZES).to(
        memory_format=torch.channels_last), _np(state.seg.params), _np(state.seg.batch_stats))
    tstate = t_create_train_state(
        tcfg, seg, disc=load_flax_weights(TDisc(), _np(state.d_main.params)),
        disc_aux=load_flax_weights(TDisc(), _np(state.d_aux.params)),
        centroids=torch.zeros(4, SIZES["filters"]))
    tstep = t_build_step(tcfg)
    sched = {"lr": 8e-4, "lr_dis": 1e-4, "warm": 1.0}
    batch = {k: v.numpy().astype(np.int32 if k == "lab_s" else np.float32)
             for k, v in _batches("slcl")[0].items()}
    state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                     {k: jnp.asarray(v, jnp.float32) for k, v in sched.items()})
    tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, sched)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-5), k
    got = state_dict_to_flax(tstate.seg)
    for part, want, atol in (("params", state.seg.params, 1e-6),
                             ("batch_stats", state.seg.batch_stats, 1e-5)):
        flat = jax.tree_util.tree_flatten_with_path(_np(want))[0]
        for path, w in flat:
            node = got[part]
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, w, rtol=1e-4, atol=atol,
                                       err_msg=f"{part} {jax.tree_util.keystr(path)}")
    np.testing.assert_allclose(tstate.centroids.numpy(), np.asarray(state.centroids),
                               rtol=1e-4, atol=1e-5)


def test_remat_recomputes_what_its_mode_says():
    """The ops the backward runs, counted by a dispatch mode: no remat
    recomputes nothing; ``dots`` recomputes the elementwise work
    (LeakyReLU) but no convolution; ``full`` recomputes both. The gradients
    equal those without remat."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    from slcl_torch.train.steps import seg_forward

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] += 1
            return func(*args, **(kwargs or {}))

    aten = torch.ops.aten
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, H, W, 3)).astype(np.float32))
    seen, grads = {}, {}
    for mode in ("", "dots", "full"):
        seg = TDRUNet(multilvl=True, generator=torch.Generator().manual_seed(0),
                      **SIZES).to(memory_format=torch.channels_last).train()
        out = seg_forward(seg, x, mode)
        with Count() as count:
            (out.pred.square().mean() + out.dcdr_ft.mean()).backward()
        seen[mode] = (count.ops[aten.convolution.default], count.ops[aten.leaky_relu.default])
        grads[mode] = [p.grad.clone() for p in seg.parameters() if p.grad is not None]
    assert seen[""] == (0, 0), seen
    assert seen["dots"][0] == 0 and seen["dots"][1] > 0, seen
    assert seen["full"][0] > 0 and seen["full"][1] > 0, seen
    for mode in ("dots", "full"):
        for g0, g1 in zip(grads[""], grads[mode]):
            torch.testing.assert_close(g1, g0, rtol=0, atol=1e-6)
