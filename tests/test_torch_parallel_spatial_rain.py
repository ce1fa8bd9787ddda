"""Spatial partitioning of RAIN's paths on the port (``mesh.spatial`` with
``rain.enabled`` under MCCL, and ``method=rain``) on the CPU over gloo,
after ``tests/test_torch_parallel_spatial.py``.

- The style net's row-sharded operators at 2 and 4 model ranks against the
  unsharded ones, in float64 (rtol 1e-10): the 3x3 convolution on a
  reflect-padded input (``jnp.pad(mode='reflect')``) at each stage height
  VGG and its decoder meet at 224 and 16 rows, down to two rows over four
  ranks (bands of one row, whose mirrored row lies on the other rank, and
  empty bands) and three, seven and one-row-a-rank layouts; and AdaIN's
  moments (``models/rain.py::calc_mean_std``) on the bands, two passes
  summed over the model ranks, against the whole images' (one-row and
  empty bands too; rtol 1e-5 / atol 1e-6: the moments are float32, as in
  the JAX package): the output on every rank, the input band's gradient
  and the summed parameter gradients.
- ``mesh.first_rows`` on a ``2 x 2`` mesh: every rank holds data rank 0's
  band of its own model rank.
- Two steps of ``mccl_rain`` (the MCCL preset with the ascent,
  ``eps_iters=2``, ``eps_clip=3``) and ``rain_seg`` (``method=rain``) of
  ``slcl_torch.testing.SPATIAL_CELLS`` on DRUNet (filters 8, 16 rows, a
  global batch of 8) at ``1 x 2`` and ``2 x 2``, a fresh sampling then the
  carried one with the ascent on, in float64: against one process on the
  same global batches and against JAX's spatial step
  (``spatial_shard_batch`` on ``make_mesh(4, model_axis=2)``; ``rain``'s on
  ``make_mesh(2, model_axis=2)``, :data:`JAX_MESH`) from the port's
  initial weights, JAX's rMC draw and RAIN noise handed to the port's
  ranks. Every metric (rel 1e-5) and the whole state (rtol 1e-4 /
  atol 1e-6), the new ``sampling`` among it: a double-counted ascent
  gradient shows only there. The sampling against JAX's at atol 1e-5
  (``torch_parallel_common.JAX_ATOL``: one process already parts from
  JAX by 3.8e-6 there, both packages' AdaIN statistics being float32).
  Also ``mccl_rain`` with ``model.remat=dots`` at ``1 x 2`` (against its
  one process and JAX's step without remat) and with ``rain.mulstyle`` at
  ``2 x 2`` (against one process).

The ranks are spawned processes that import ``tests/torch_parallel_common.py``
(torch and slcl_torch only), one thread each.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_parallel_common as C
from test_torch_parallel import _f64, _jax_cfg, _np
from torch_rain_common import Preset, jax_noise, jax_randint

from slcl_torch.models.rain import calc_mean_std
from slcl_torch.parallel.dryrun import spawn
from slcl_torch.testing import configure_cell
from slcl_torch.utils.convert import flax_to_state_dict, state_dict_to_flax
from slcl_tpu.models.drunet import DRUNet
from slcl_tpu.models.rain import RAIN
from slcl_tpu.parallel.mesh import make_mesh, replicate_state, shard_batch, spatial_shard_batch
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)
MOD = "torch_parallel_common"
F64 = torch.float64


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------
def _op_cases():
    """(name, case) of every reflect convolution and moment case; the arrays
    are made from one seed."""
    rng = np.random.default_rng(11)
    n, c, w = 2, 3, 6
    cases = []
    # VGG's and its decoder's stage heights at 224 and 16 rows, and uneven
    # layouts: 2 rows over 4 ranks are bands of 1, 1, 0, 0
    for rows in (224, 112, 56, 28, 16, 8, 4, 3, 2, 7):
        cases.append((f"conv3_reflect_h{rows}",
                      {"kind": "conv", "padding_mode": "reflect", "x": rng.normal(
                          size=(n, c, rows, w)), "w": rng.normal(size=(4, c, 3, 3)),
                       "b": rng.normal(size=4), "stride": 1, "padding": 1, "dilation": 1,
                       "g": rng.normal(size=(n, 4, rows, w))}))
    for rows in (16, 4, 2, 1):
        cases.append((f"mean_std_h{rows}",
                      {"kind": "mean_std", "x": rng.normal(size=(n, c, rows, w)) + 0.5,
                       "g": rng.normal(size=(n, 1, 1, 2 * c))}))
    return cases


OPS = _op_cases()


def _plain(case):
    """The unsharded operator: (output, input gradient, parameter gradients)."""
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    if case["kind"] == "mean_std":
        y = torch.cat(calc_mean_std(x.permute(0, 2, 3, 1)), dim=-1)
        (y * torch.from_numpy(case["g"])).sum().backward()
        return y.detach().numpy(), x.grad.numpy(), {}
    w = torch.from_numpy(case["w"]).requires_grad_(True)
    b = torch.from_numpy(case["b"]).requires_grad_(True)
    y = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w, b)
    (y * torch.from_numpy(case["g"])).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), {"weight": w.grad.numpy(),
                                                "bias": b.grad.numpy()}


@pytest.fixture(scope="module")
def op_runs():
    cases = [c for _, c in OPS]
    return {m: spawn(m, "spatial_ops_entry", (cases,), model_axis=m, module=MOD, spatial=True)
            for m in (2, 4)}


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("i", range(len(OPS)), ids=[name for name, _ in OPS])
def test_style_net_operator_matches_unsharded(op_runs, ranks, i):
    name, case = OPS[i]
    y, dx, dparams = _plain(case)
    got = [r[i] for r in op_runs[ranks]]
    # the moments are taken in float32, as the JAX package takes them: their
    # sums in another order round apart by float32's epsilon
    rtol, atol = (1e-5, 1e-6) if case["kind"] == "mean_std" else (1e-10, 1e-12)
    if case["kind"] == "mean_std":
        # the whole images' moments on every model rank
        for g in got:
            np.testing.assert_allclose(g["y"], y, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_allclose(np.concatenate([g["y"] for g in got], axis=2), y,
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got], axis=2), dx,
                               rtol=rtol, atol=atol, err_msg=name)
    for k, want in dparams.items():
        np.testing.assert_allclose(sum(g["dparams"][k] for g in got), want, rtol=1e-10,
                                   atol=1e-12, err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# JAX's RAIN steps
# ---------------------------------------------------------------------------
def rain_scheds():
    """A fresh sampling, then the carried one, the ascent on in both."""
    s = C.sched("mccl_rain")
    return [s, {**s, "fresh": 0.0}]


def jax_rain_steps(trainer, batches, scheds, n_dev: int = 1, model_axis: int = 1,
                   spatial: bool = False):
    """JAX's step of ``trainer``'s method (``mccl`` with RAIN, or ``rain``)
    on DRUNet from ``trainer``'s initial state in float64, on
    ``make_mesh(n_dev, model_axis)`` (``spatial_shard_batch`` with
    ``spatial``, else ``shard_batch``; no mesh at one device): per step
    (metrics, the state as the port's ``state_arrays``), and the draws it
    made (``assign``: the global batch's rMC ids; ``noise``: RAIN's noise
    of the stylised batch), for ``torch_parallel_common.use_draws``."""
    cfg, s = _jax_cfg(trainer.cfg), trainer.state
    cfg.mesh.spatial = spatial
    per_image = cfg.rain.mulstyle and not cfg.rain.mulstyle2
    draws = {}
    out = []
    with jax.enable_x64():
        f64 = jnp.float64
        m = cfg.model
        model = DRUNet(filters=m.filters, n_block=m.n_block,
                       bottleneck_depth=m.bottleneck_depth, n_class=m.num_classes,
                       multilvl=m.multilvl, phead=m.phead, dtype=f64)
        h = cfg.data.crop
        state, txs = create_train_state(
            cfg, Preset(_f64(state_dict_to_flax(s.seg))), sample_shape=(1, h, h, 3),
            centroids=None if s.centroids is None else jnp.asarray(s.centroids.numpy(), f64))
        rain, rain_p = RAIN(dtype=f64), _f64(state_dict_to_flax(s.rain)["params"])
        state = state.replace(extra={"rain": rain_p},
                              sampling=jnp.asarray(s.sampling.numpy(), f64))
        step = build_step(cfg, model, txs, None, None, rain_model=rain)
        mesh = make_mesh(n_dev, model_axis=model_axis) if n_dev > 1 else None
        rain_arrays = {f"rain/{k}": v.numpy().copy() for k, v in s.rain.state_dict().items()}
        for b, sc in zip(batches, scheds):
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
            n = b["img_s"].shape[0] if per_image else 1
            if cfg.method == "mccl":
                _, part, key = jax.random.split(state.rng, 3)
                draws.setdefault("assign", []).append(np.array(
                    jax_randint(part, b["img_t"].size // 3, cfg.contrastive.part), np.int32))
            else:
                _, key = jax.random.split(state.rng)
            draws.setdefault("noise", []).append(jax_noise(
                rain, rain_p, jnp.asarray(b["img_s"][:n]), jnp.asarray(b["img_t"][:n]), key))
            # float32 sched scalars under x64: MCCL + RAIN's two cotangents
            # must match its losses' float32
            js = {k: jnp.asarray(sc[k], jnp.float32) for k in sc}
            if mesh is None:
                state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, js)
            else:
                with mesh:
                    shard = spatial_shard_batch if spatial else shard_batch
                    state, metrics = step(replicate_state(state, mesh), shard(b, mesh), js)
            sd = flax_to_state_dict(s.seg, _np(state.seg.params), _np(state.seg.batch_stats))
            arrays = {f"seg/{k}": np.asarray(v, np.float64) for k, v in sd.items()}
            arrays.update(rain_arrays)
            arrays["sampling"] = np.array(state.sampling, np.float64)
            if state.centroids is not None:
                arrays["centroids"] = np.array(state.centroids, np.float64)
            out.append(({k: float(v) for k, v in metrics.items()}, arrays))
    return out, draws


def rain_run(name: str, tmp, n_dev: int = 1, model_axis: int = 1, spatial: bool = False):
    """The spec of the port's run of the ``SPATIAL_CELLS`` cell ``name`` on
    JAX's draws (for ``compare_entry``) and the file of JAX's steps on
    ``make_mesh(n_dev, model_axis)``."""
    cfg, batches, _ = C.spatial_run(name)
    trainer = C.build_trainer(cfg, str(tmp / f"init_{name}"), F64)
    jax_out, draws = jax_rain_steps(trainer, batches, rain_scheds(), n_dev, model_axis,
                                    spatial)
    path = tmp / f"jax_{name}.pt"
    torch.save(jax_out, path)
    return (name, cfg, batches, rain_scheds(), F64, draws), str(path)


def _check(rec, what, jax: bool = True):
    """A ``compare_entry`` record: metrics (rel 1e-5) and the whole state,
    the sampling among it, as one process's and JAX's."""
    C.assert_metrics_close(rec["metrics"], rec["want_metrics"], 1e-5, what)
    assert not rec["errors"], f"{what}: {rec['errors'][:8]}"
    if jax:
        C.assert_metrics_close(rec["metrics"], rec["jax_metrics"], 1e-5, f"{what} jax")
        assert not rec["jax_errors"], f"{what} jax: {rec['jax_errors'][:8]}"


# the mesh of JAX's spatial step of each cell, (devices, model axis): JAX's
# step is the global batch's on any mesh, so the port's 1 x 2 and 2 x 2
# ranks are held against one run of it. rain_seg's at (1, 2): XLA's SPMD
# partitioner aborts compiling JAX's float64 rain step on the (2, 2) mesh
# ("Check failed: ShapeUtil::IsScalarWithElementType"; its float32 step
# compiles there)
JAX_MESH = {"mccl_rain": (4, 2), "rain_seg": (2, 2)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per cell: the port's spec on JAX's draws and the file of JAX's
    spatial steps (:data:`JAX_MESH`)."""
    tmp = tmp_path_factory.mktemp("rain_jax")
    return {name: rain_run(name, tmp, *JAX_MESH[name], True) for name in JAX_MESH}


@pytest.fixture(scope="module")
def runs_1x2(jax_runs, tmp_path_factory):
    """``mccl_rain`` and ``rain_seg`` at 1 x 2 on JAX's draws, against one
    process and JAX's spatial step; ``mccl_rain`` with ``dots``."""
    tmp = tmp_path_factory.mktemp("rain12")
    specs = [jax_runs[name][0] for name in JAX_MESH]
    expected = {name: jax_runs[name][1] for name in JAX_MESH}
    dots = copy.deepcopy(specs[0][1])
    dots.model.remat = "dots"
    specs.append(("mccl_rain_dots", dots, *specs[0][2:]))
    expected["mccl_rain_dots"] = expected["mccl_rain"]
    return spawn(2, "spatial_rain_entry", (specs, str(tmp / "ranks"), expected),
                 model_axis=2, module=MOD, spatial=True)


@pytest.fixture(scope="module")
def runs_2x2(jax_runs, tmp_path_factory):
    """``mccl_rain`` and ``rain_seg`` at 2 x 2 on JAX's draws, against one
    process and JAX's spatial step; ``mccl_rain`` with ``rain.mulstyle`` on
    its own draws against one process; and ``first_rows``."""
    tmp = tmp_path_factory.mktemp("rain22")
    specs = [jax_runs[name][0] for name in JAX_MESH]
    expected = {name: jax_runs[name][1] for name in JAX_MESH}
    cfg, batches, _ = C.spatial_run("mccl_rain")
    configure_cell(cfg, "mccl_rain_mulstyle")
    specs.append(("mccl_rain_mulstyle", cfg, batches, rain_scheds(), F64))
    return spawn(4, "spatial_rain_entry", (specs, str(tmp / "ranks"), expected),
                 model_axis=2, module=MOD, spatial=True)


@pytest.mark.parametrize("name", ["mccl_rain", "rain_seg", "mccl_rain_dots"])
@pytest.mark.parametrize("step", [0, 1])
def test_1x2_rain_step_matches_one_process_and_jax(runs_1x2, name, step):
    for r, got in enumerate(runs_1x2):
        rec = got["runs"][name][step]
        if name != "rain_seg":
            assert rec["metrics"]["eps_step_norm"] > 0.0      # the ascent ran
        _check(rec, f"{name} step {step} rank {r}")


@pytest.mark.parametrize("name", ["mccl_rain", "rain_seg", "mccl_rain_mulstyle"])
@pytest.mark.parametrize("step", [0, 1])
def test_2x2_rain_step_matches_one_process_and_jax(runs_2x2, name, step):
    for r, got in enumerate(runs_2x2):
        rec = got["runs"][name][step]
        if name != "rain_seg":
            assert rec["metrics"]["eps_step_norm"] > 0.0
        _check(rec, f"{name} step {step} rank {r}", jax=name != "mccl_rain_mulstyle")


def test_first_rows_sends_data_rank_zero_band_of_each_model_rank(runs_2x2):
    for r, got in enumerate(runs_2x2):
        d, m = divmod(r, 2)
        assert tuple(got["first_rows"]["rank"]) == (d, m)
        np.testing.assert_array_equal(got["first_rows"]["first"], [[0.0, float(m)]])
