"""Spatial partitioning of the port (``mesh.spatial``: ``parallel/spatial.py``
and the pixel group of ``parallel/mesh.py``) on the CPU over gloo, after
``tests/test_parallel.py::test_spatial_partitioning_matches_single_device``.

- The row-sharded operators at 2 and 4 model ranks against the unsharded
  ones, in float64: each stage shape that DRUNet (16 and 224 rows) and the
  ``UncertaintyDiscriminator`` (224 -> 113 -> 57 -> 29 -> 15 -> 8, 16 ->
  9 -> 5 -> 3 -> 2 -> 2) produce: the 'same' 3x3 convolution at dilations
  1, 2, 4 and 8 (a halo wider than a band: 8 rows against bands of 7, 4, 2
  or 1), the discriminator's 4x4 stride-2 pad-2 convolution (uneven bands
  from the first stage on, empty ones at 3 and 2 rows over 4 ranks), the
  2x2 max-pool (a band of 7 rows), the nearest 2x upsample, the
  ``align_corners`` bilinear resize on global coordinates and BatchNorm's
  moments: the output, the input's gradient and the summed parameter
  gradients (rtol 1e-10), and BatchNorm's running statistics.
- Two steps of ``baseline``, ``adaptseg``, ``advent``, ``mpscl``, ``slcl``
  (multilvl + CNR) and ``mccl`` (two partitions, soft weights, CNR) at
  ``1 x 2`` (one data rank, each image's 16 rows split over two model
  ranks) against one process on the same global batches, in float64:
  every metric (rel 1e-5) and the whole state (rtol 1e-4 / atol 1e-6), the
  data-parallel tolerances of ``tests/test_torch_parallel.py``.
- ``mpscl`` at ``2 x 2`` (a ``make_mesh(4, model_axis=2)`` mesh) against
  JAX's spatial step on the conftest's virtual CPU devices
  (``spatial_shard_batch`` and ``replicate_state``) from the port's initial
  weights under ``jax.enable_x64``, and against one process; and the same
  with FSDP (``mesh.fsdp_min_size`` 1024) against one process.
- The rMC draw: each rank keeps the global draw's pixels of its data rank's
  images and its band of their rows.
- Refusals: every network or method the port does not split raises
  ``NotImplementedError`` naming both; an image height that the model
  ranks do not divide raises ``ValueError`` naming H and the ranks; a mesh
  that does not split rows under ``mesh.spatial=true`` raises.

The ranks are spawned processes that import ``tests/torch_parallel_common.py``
(torch and slcl_torch only), one thread each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_parallel_common as C
from test_torch_parallel import _as_flax, _f64, _jax_cfg, _np
from torch_extra_common import assert_tree_close
from torch_rain_common import Preset

from slcl_torch.models.common import BatchNorm
from slcl_torch.parallel.dryrun import spawn
from slcl_torch.utils.convert import state_dict_to_flax
from slcl_tpu.models import UncertaintyDiscriminator
from slcl_tpu.models.drunet import DRUNet
from slcl_tpu.parallel.mesh import make_mesh, replicate_state, spatial_shard_batch
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)
MOD = "torch_parallel_common"
F64 = torch.float64
METHODS = ("baseline", "adaptseg", "advent", "mpscl", "slcl", "mccl")


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------
def _op_cases():
    """(name, case) of every operator and stage shape; the arrays are made
    from one seed."""
    rng = np.random.default_rng(7)
    n, c, w = 2, 3, 6
    cases = []

    def arr(*shape):
        return rng.normal(size=shape)

    for rows in (16, 8, 14, 7, 4, 3):
        for d in (1, 2, 4, 8):
            cases.append((f"conv3_d{d}_h{rows}",
                          {"kind": "conv", "x": arr(n, c, rows, w), "w": arr(4, c, 3, 3),
                           "b": arr(4), "stride": 1, "padding": d, "dilation": d,
                           "g": arr(n, 4, rows, w)}))
    for rows in (224, 113, 57, 29, 15, 8, 16, 9, 5, 3, 2):
        out = (rows + 4 - 3 - 1) // 2 + 1
        cols = (w + 4 - 3 - 1) // 2 + 1
        cases.append((f"disc4_h{rows}",
                      {"kind": "conv", "x": arr(1, 2, rows, w), "w": arr(3, 2, 4, 4),
                       "stride": 2, "padding": 2, "dilation": 1,
                       "g": arr(1, 3, out, cols)}))
    for rows in (16, 14, 28, 8):
        cases.append((f"max_pool_h{rows}", {"kind": "max_pool", "x": arr(n, c, rows, w),
                                             "g": arr(n, c, rows // 2, w // 2)}))
    for rows in (7, 4, 14, 3):
        cases.append((f"nearest_h{rows}", {"kind": "nearest", "x": arr(n, c, rows, w),
                                            "g": arr(n, c, 2 * rows, 2 * w)}))
    for rows, out in ((8, 16), (112, 224), (7, 14), (5, 16)):
        cases.append((f"bilinear_h{rows}_{out}",
                      {"kind": "bilinear", "x": arr(n, c, rows, w), "size": (out, 2 * w),
                       "g": arr(n, c, out, 2 * w)}))
    for rows in (16, 7, 3):
        cases.append((f"batchnorm_h{rows}", {"kind": "batchnorm", "x": arr(n, c, rows, w),
                                              "g": arr(n, c, rows, w)}))
    return cases


OPS = _op_cases()


def _plain(case):
    """The unsharded operator: (output, input gradient, parameter
    gradients, buffers)."""
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    params, module = {}, None
    kind = case["kind"]
    if kind == "conv":
        w = torch.from_numpy(case["w"]).requires_grad_(True)
        params["weight"] = w
        if "b" in case:
            params["bias"] = torch.from_numpy(case["b"]).requires_grad_(True)
        y = F.conv2d(x, w, params.get("bias"), case["stride"], case["padding"],
                     case["dilation"])
    elif kind == "max_pool":
        y = F.max_pool2d(x, 2, 2)
    elif kind == "nearest":
        y = F.interpolate(x, scale_factor=2, mode="nearest")
    elif kind == "bilinear":
        y = F.interpolate(x, size=case["size"], mode="bilinear", align_corners=True)
    else:
        module = BatchNorm(x.shape[1]).double()
        params = dict(module.named_parameters())
        # F.batch_norm's path at one process: the two-pass moments
        y = module(x)
    (y * torch.from_numpy(case["g"])).sum().backward()
    buffers = ({n: t.numpy() for n, t in module.named_buffers()} if module is not None
               else {})
    return (y.detach().numpy(), x.grad.numpy(),
            {k: p.grad.numpy() for k, p in params.items()}, buffers)


@pytest.fixture(scope="module")
def op_runs():
    cases = [c for _, c in OPS]
    return {m: spawn(m, "spatial_ops_entry", (cases,), model_axis=m, module=MOD, spatial=True)
            for m in (2, 4)}


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("i", range(len(OPS)), ids=[name for name, _ in OPS])
def test_row_sharded_operator_matches_unsharded(op_runs, ranks, i):
    name, case = OPS[i]
    y, dx, dparams, buffers = _plain(case)
    got = [r[i] for r in op_runs[ranks]]
    # the bands concatenate to the unsharded output and input gradient
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got], axis=2), y,
                               rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got], axis=2), dx,
                               rtol=1e-10, atol=1e-12, err_msg=name)
    # each rank's parameter gradient is its band's share
    for k, want in dparams.items():
        np.testing.assert_allclose(sum(g["dparams"][k] for g in got), want, rtol=1e-10,
                                   atol=1e-12, err_msg=f"{name} {k}")
    for k, want in buffers.items():
        for g in got:
            np.testing.assert_allclose(g["buffers"][k], want, rtol=1e-10, atol=1e-12,
                                       err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------
def _specs(methods, fsdp=False):
    out = []
    for m in methods:
        cfg, batches = C.spatial_cfg(m, fsdp), C.batches("mpscl" if m == "slcl" else m, 2)
        out.append((m, cfg, batches, [C.sched(m), {**C.sched(m), "fresh": 0.0}], F64))
    return out


@pytest.fixture(scope="module")
def steps_1x2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp12")
    specs = _specs(METHODS)
    ranks = spawn(2, "methods_entry", (specs, str(tmp / "ranks")), model_axis=2,
                  module=MOD, spatial=True)
    one = C.methods_entry(None, specs, str(tmp / "one"))
    return ranks, one


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("step", [0, 1])
def test_1x2_step_matches_one_process(steps_1x2, method, step):
    ranks, one = steps_1x2
    want = one[method]["steps"][step]
    for r, got in enumerate(ranks):
        got = got[method]["steps"][step]
        C.assert_metrics_close(got["metrics"], want["metrics"], 1e-5, f"{method} rank {r}")
        C.assert_state_close(got["state"], want["state"], 1e-4, 1e-6, f"{method} rank {r}")


def _jax_spatial_steps(trainer, batches, scheds):
    """JAX's ``mpscl`` step on a (2, 2) mesh with spatial_shard_batch, from
    ``trainer``'s initial weights, in float64: per step the metrics and the
    state in flax's layout."""
    cfg, s = _jax_cfg(trainer.cfg), trainer.state
    cfg.mesh.spatial = True
    with jax.enable_x64():
        f64 = jnp.float64
        m = cfg.model
        model = DRUNet(filters=m.filters, n_block=m.n_block,
                       bottleneck_depth=m.bottleneck_depth, n_class=m.num_classes,
                       multilvl=m.multilvl, phead=m.phead, dtype=f64)
        disc = UncertaintyDiscriminator(dtype=f64)
        state, txs = create_train_state(
            cfg, Preset(_f64(state_dict_to_flax(s.seg))),
            disc=Preset(_f64(state_dict_to_flax(s.d_main))), sample_shape=(1, C.H, C.H, 3),
            centroids=jnp.asarray(s.centroids.numpy(), f64))
        step = build_step(cfg, model, txs, disc, None)
        mesh = make_mesh(4, model_axis=2)
        out = []
        for b, sc in zip(batches, scheds):
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
            js = {k: jnp.asarray(sc[k], jnp.float32) for k in sc}
            with mesh:
                sharded = spatial_shard_batch(b, mesh)
                assert any("model" in (v.sharding.spec or ()) for v in sharded.values())
                state, metrics = step(replicate_state(state, mesh), sharded, js)
            tree = {"seg": _np({"params": state.seg.params,
                                "batch_stats": state.seg.batch_stats}),
                    "d_main": _np({"params": state.d_main.params}),
                    "centroids": np.array(state.centroids, np.float64)}
            out.append(({k: float(v) for k, v in metrics.items()}, tree))
    return out


@pytest.fixture(scope="module")
def steps_2x2(tmp_path_factory):
    """``mpscl`` at 2 x 2: replicated and with FSDP in four ranks, one
    process, JAX's spatial step; and each rank's rMC pixels and the
    refusals under the same mesh."""
    tmp = tmp_path_factory.mktemp("sp22")
    cfg = C.spatial_cfg("mpscl")
    batches = C.batches("mpscl", 2)
    scheds = [C.sched("mpscl"), {**C.sched("mpscl"), "fresh": 0.0}]
    trainer = C.build_trainer(cfg, str(tmp / "init"), F64)
    jax_out = _jax_spatial_steps(trainer, batches, scheds)
    specs = [("replicated", cfg, batches, scheds, F64),
             ("fsdp", C.spatial_cfg("mpscl", fsdp=True), batches, scheds, F64)]
    ranks = spawn(4, "spatial_2x2_entry", (specs, str(tmp / "ranks")), model_axis=2,
                  module=MOD, spatial=True)
    one = C.methods_entry(None, specs[:1], str(tmp / "one"))["replicated"]
    return {"jax": jax_out, "trainer": trainer, "ranks": [r["methods"] for r in ranks],
            "one": one, "checks": [r["checks"] for r in ranks]}


@pytest.mark.parametrize("step", [0, 1])
def test_2x2_mpscl_matches_jax_spatial_step(steps_2x2, step):
    want_m, want = steps_2x2["jax"][step]
    for r, got in enumerate(steps_2x2["ranks"]):
        got = got["replicated"]["steps"][step]
        C.assert_metrics_close(got["metrics"], want_m, 1e-5, f"rank {r}")
        flax = _as_flax(steps_2x2["trainer"], got["state"])
        assert set(flax) == set(want)
        for k, w in want.items():
            assert_tree_close(flax[k], w, 1e-4, 1e-6, f"rank {r} {k}")


@pytest.mark.parametrize("kind", ["replicated", "fsdp"])
@pytest.mark.parametrize("step", [0, 1])
def test_2x2_mpscl_matches_one_process(steps_2x2, kind, step):
    want = steps_2x2["one"]["steps"][step]
    for r, got in enumerate(steps_2x2["ranks"]):
        got = got[kind]["steps"][step]
        if kind == "fsdp":
            assert got["sharded"] > 0
        C.assert_metrics_close(got["metrics"], want["metrics"], 1e-5, f"{kind} rank {r}")
        C.assert_state_close(got["state"], want["state"], 1e-4, 1e-6, f"{kind} rank {r}")


def test_rmc_draw_keeps_the_ranks_pixels(steps_2x2):
    """Rank (d, m) of the 2 x 2 mesh keeps data rank d's images and model
    rank m's band of their rows, flattened as its own tensors are."""
    grid = np.arange(C.B * C.H * C.H, dtype=np.int32).reshape(C.B, C.H, C.H)
    b, h = C.B // 2, C.H // 2
    for r, got in enumerate(steps_2x2["checks"]):
        d, m = divmod(r, 2)
        assert tuple(got["shape"]) == (C.B, C.H, C.H)
        np.testing.assert_array_equal(got["pixels"],
                                      grid[d * b:(d + 1) * b, m * h:(m + 1) * h].reshape(-1))


@pytest.mark.parametrize("name", ["resnet50", "unet", "deeplabv2", "rain", "ddfseg",
                                  "adaptevery", "bcl", "remat"])
def test_unported_network_or_method_raises(steps_2x2, name):
    net = {"resnet50": "'resnet50'", "unet": "'unet'", "deeplabv2": "'deeplabv2'",
           "rain": "with the RAIN style net", "ddfseg": "'DDFSeg'",
           "adaptevery": "'ResNetUNetPoint'", "bcl": "'BCLDeepLab'",
           "remat": "model.remat=full"}[name]
    method = {"resnet50": "slcl", "unet": "baseline", "deeplabv2": "advent", "rain": "mccl",
              "remat": "mpscl"}.get(name, name)
    for got in steps_2x2["checks"]:
        kind, msg = got[name]
        assert kind == "NotImplementedError" and "mesh.spatial" in msg, msg
        assert net in msg and f"method {method!r}" in msg, msg


def test_indivisible_rows_and_mismatched_mesh_raise(steps_2x2):
    for got in steps_2x2["checks"]:
        kind, msg = got["odd_rows"]
        assert kind == "ValueError" and "H=17" in msg and "2 model ranks" in msg, msg
        kind, msg = got["mismatch"]
        assert kind == "ValueError" and "mesh.spatial=False" in msg, msg
        # DRUNet's mpscl ran on a band of 8 of the 16 rows
        assert got["local_rows"] == C.H // 2
        assert all(np.isfinite(v) for v in got["step"].values())
