"""Data parallelism of the port (``slcl_torch/parallel/mesh.py``) on the CPU
over gloo, after ``tests/test_parallel.py``: a step in W processes, each
holding its rows of the global batch, equals the step on the global batch.

Two steps each of ``mpscl``, ``mccl`` (two partitions, soft weights, CNR),
MCCL + RAIN with the epsilon ascent, and ``bcl`` at W = 2 (DRUNet filters 8,
BCL's slim DeepLab; 16x16, global batch 8), in float64 (the losses keep
float32), are held

- against JAX's step sharded over two devices (``make_mesh(2)`` with
  ``shard_batch``) under ``jax.enable_x64``, from the port's initial
  weights converted to flax, with JAX's own rMC assignment and RAIN noise
  handed to the port's ranks through ``build_step(..., draw_assign=,
  draw_noise=)``: every metric, every network's parameters and BatchNorm
  statistics (the discriminator's too), the centres and the sampling;
- and against the port's one-process step on the same global batches,
  with the port's own draws (the global batch's draw, each rank keeping
  its rows): every metric and the whole state.

Tolerances are JAX's data-parallel ones (``tests/test_parallel.py``):
parameters, statistics, centres and the sampling rtol 1e-4 / atol 1e-6;
metrics rel 1e-5 (abs 1e-6). In float32 the ascent's gradient through the
segmentor and the style net rounds differently in the two runs by up to
2e-3 of its norm, and Adam's first steps turn the rounding of a gradient
that is exactly zero into a step of +-lr; float64 shows both to be rounding.
FSDP and the checkpoints across process counts: ``test_torch_parallel_fsdp.py``.

The ranks are spawned processes that import ``tests/torch_parallel_common.py``
(torch and slcl_torch only), one thread each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_common as C
from torch_extra_common import assert_tree_close
from torch_rain_common import Preset, jax_noise, jax_randint

from slcl_torch.parallel.dryrun import spawn
from slcl_torch.utils.convert import state_dict_to_flax
from slcl_tpu.config import Config
from slcl_tpu.models import UncertaintyDiscriminator
from slcl_tpu.models.deeplabv2 import BCLDeepLab
from slcl_tpu.models.drunet import DRUNet
from slcl_tpu.models.rain import RAIN
from slcl_tpu.parallel.mesh import make_mesh, replicate_state, shard_batch
from slcl_tpu.train.state import NetState, TrainState, create_train_state, make_optimizer
from slcl_tpu.train.steps import build_step
from slcl_tpu.train.steps_extra import make_bcl_step

torch.set_num_threads(1)
MOD = "torch_parallel_common"
METHODS = ("mpscl", "mccl", "mccl_rain", "bcl")
F64 = torch.float64


def _jax_cfg(tcfg) -> Config:
    """JAX's Config with every field of the port's ``tcfg``."""
    cfg = Config()
    for sec, val in vars(tcfg).items():
        if hasattr(val, "__dataclass_fields__"):
            for k, v in vars(val).items():
                setattr(getattr(cfg, sec), k, v)
        else:
            setattr(cfg, sec, val)
    return cfg


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


def _jax_steps(method: str, trainer, batches, scheds):
    """JAX's sharded steps from ``trainer``'s initial state: per step the
    metrics and the state in flax's layout; and the draws it made (the rMC
    assignment and RAIN's noise of the global batch)."""
    cfg, s = _jax_cfg(trainer.cfg), trainer.state
    f64 = jnp.float64
    draws = {}
    with jax.enable_x64():
        seg_v = _f64(state_dict_to_flax(s.seg))
        if method == "bcl":
            m = cfg.model
            model = BCLDeepLab(num_classes=m.num_classes, layers=tuple(m.layers), base=m.base,
                               dtype=f64)
            tx = make_optimizer("sgd", cfg.optim.lr, momentum=cfg.optim.momentum,
                                weight_decay=cfg.optim.weight_decay)
            state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                               seg=NetState(params=seg_v["params"],
                                            batch_stats=seg_v["batch_stats"],
                                            opt_state=tx.init(seg_v["params"])))
            step = make_bcl_step(cfg, model, {"seg": tx})
        else:
            m = cfg.model
            model = DRUNet(filters=m.filters, n_block=m.n_block,
                           bottleneck_depth=m.bottleneck_depth, n_class=m.num_classes,
                           multilvl=m.multilvl, phead=m.phead, dtype=f64)
            disc = None
            if s.d_main is not None:
                disc = UncertaintyDiscriminator(dtype=f64)
            state, txs = create_train_state(
                cfg, Preset(seg_v), disc=Preset(_f64(state_dict_to_flax(s.d_main)))
                if disc else None, sample_shape=(1, C.H, C.H, 3),
                centroids=jnp.asarray(s.centroids.numpy(), f64))
            rain = rain_p = None
            if s.rain is not None:
                rain, rain_p = RAIN(dtype=f64), _f64(state_dict_to_flax(s.rain)["params"])
                state = state.replace(extra={"rain": rain_p},
                                      sampling=jnp.asarray(s.sampling.numpy(), f64))
            step = build_step(cfg, model, txs, disc, None, rain_model=rain)
        mesh = make_mesh(2)
        out = []
        for b, sc in zip(batches, scheds):
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
            if cfg.method == "mccl":
                _, part, key = jax.random.split(state.rng, 3)
                draws.setdefault("assign", []).append(np.array(
                    jax_randint(part, C.B * C.H * C.H, cfg.contrastive.part), np.int32))
                if rain is not None:
                    draws.setdefault("noise", []).append(jax_noise(
                        rain, rain_p, jnp.asarray(b["img_s"][:1]),
                        jnp.asarray(b["img_t"][:1]), key))
            js = {k: jnp.asarray(sc[k], jnp.float64 if method == "bcl" else jnp.float32)
                  for k in sc}
            with mesh:
                state, metrics = step(replicate_state(state, mesh), shard_batch(b, mesh), js)
            tree = {"seg": _np({"params": state.seg.params,
                                "batch_stats": state.seg.batch_stats})}
            if state.d_main is not None:
                tree["d_main"] = _np({"params": state.d_main.params})
            for k in ("centroids", "sampling"):
                if getattr(state, k) is not None:
                    tree[k] = np.array(getattr(state, k), np.float64)
            out.append(({k: float(v) for k, v in metrics.items()}, tree))
    return out, draws


def _as_flax(trainer, arrays: dict) -> dict:
    """A ``state_arrays`` dict in flax's layout, through ``trainer``'s
    modules (left as they were)."""
    s, out = trainer.state, {}
    for name in ("seg", "d_main"):
        net = getattr(s, name)
        if net is None:
            continue
        saved = {k: v.clone() for k, v in net.state_dict().items()}
        net.load_state_dict({k[len(name) + 1:]: torch.from_numpy(v) for k, v in arrays.items()
                             if k.startswith(name + "/")})
        flax = state_dict_to_flax(net)
        out[name] = flax if name == "seg" else {"params": flax["params"]}
        net.load_state_dict(saved)
    for k in ("centroids", "sampling"):
        if k in arrays:
            out[k] = arrays[k]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per method: JAX's sharded steps, the port's ranks on JAX's draws, the
    port's ranks and one process on the port's own draws."""
    tmp = tmp_path_factory.mktemp("methods")
    own, jaxed, out = [], [], {}
    for m in METHODS:
        cfg, batches = C.small_cfg(m), C.batches(m, 2)
        scheds = [C.sched(m), {**C.sched(m), "fresh": 0.0}]
        trainer = C.build_trainer(cfg, str(tmp / f"init_{m}"), F64)
        jax_out, draws = _jax_steps(m, trainer, batches, scheds)
        out[m] = {"jax": jax_out, "trainer": trainer}
        own.append((m, cfg, batches, scheds, F64))
        jaxed.append((f"{m}@jax", cfg, batches, scheds, F64, draws))
    ranks = spawn(2, "methods_entry", (own + jaxed, str(tmp / "ranks")), module=MOD)
    one = C.methods_entry(None, own, str(tmp / "one"))
    for m in METHODS:
        out[m].update(ranks=[r[m] for r in ranks], ranks_jax=[r[f"{m}@jax"] for r in ranks],
                      one=one[m])
    return out


def _check_against_jax(run, step: int, what: str) -> None:
    want_m, want = run["jax"][step]
    for r, got in enumerate(run["ranks_jax"]):
        got = got["steps"][step]
        C.assert_metrics_close(got["metrics"], want_m, 1e-5, f"{what} rank {r}")
        flax = _as_flax(run["trainer"], got["state"])
        assert set(flax) == set(want), what
        for k, w in want.items():
            assert_tree_close(flax[k], w, 1e-4, 1e-6, f"{what} rank {r} {k}")


def test_mpscl_two_ranks_match_jax_sharded_step(runs):
    for step in range(2):
        _check_against_jax(runs["mpscl"], step, f"mpscl step {step}")


@pytest.mark.parametrize("rank", [0, 1])
def test_mpscl_two_ranks_match_one_process(runs, rank):
    for i in range(2):
        got, want = runs["mpscl"]["ranks"][rank]["steps"][i], runs["mpscl"]["one"]["steps"][i]
        C.assert_metrics_close(got["metrics"], want["metrics"], 1e-5, f"mpscl step {i}")
        C.assert_state_close(got["state"], want["state"], 1e-4, 1e-6, f"mpscl step {i}")


@pytest.mark.parametrize("method", ["mccl", "mccl_rain", "bcl"])
@pytest.mark.parametrize("step", [0, 1])
def test_method_two_ranks_match_jax_sharded_step(runs, method, step):
    run = runs[method]
    if method == "mccl_rain":
        assert run["jax"][step][0]["eps_step_norm"] > 0.0   # the ascent ran
    _check_against_jax(run, step, f"{method} step {step}")


@pytest.mark.parametrize("method", ["mccl", "mccl_rain", "bcl"])
@pytest.mark.parametrize("step", [0, 1])
def test_method_two_ranks_match_one_process(runs, method, step):
    run = runs[method]
    want = run["one"]["steps"][step]
    if method == "mccl_rain":
        assert want["metrics"]["eps_step_norm"] > 0.0   # the ascent ran
    for r, got in enumerate(run["ranks"]):
        got = got["steps"][step]
        C.assert_metrics_close(got["metrics"], want["metrics"], 1e-5, f"{method} rank {r}")
        C.assert_state_close(got["state"], want["state"], 1e-4, 1e-6, f"{method} rank {r}")
