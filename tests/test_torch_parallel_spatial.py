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
  moments; and those of the published backbones (ResNetUNet, UNet,
  DeepLabV2 at 224 and 16 rows): the 7x7 stride-2 stems, ResNetUNet's
  strided 3x3, the strided 1x1 ``down_conv`` / caffe ``conv1`` (which
  exchanges nothing where the bands line up), DeepLabV2's dilated 3x3 and
  its ASPP's dilations 6-24 on 29 and 3 rows (halos wider than any band),
  the stems' 3x3 stride-2 max-pools, floor and ceil, on post-ReLU inputs
  with all-zero windows (``-inf`` rows outside the image, so the arg-max
  and the gradient's route are the unsharded pool's), UNet's 2x2 stride-2
  transposed convolution (14 rows over 4 ranks: a band reads its
  neighbour's last row) and FrozenBatchNorm: the output, the input's
  gradient and the summed parameter gradients (rtol 1e-10), and the
  BatchNorms' running statistics.
- Two steps of ``baseline``, ``adaptseg``, ``advent``, ``mpscl``, ``slcl``
  (multilvl + CNR) and ``mccl`` (two partitions, soft weights, CNR) on
  DRUNet, and of the runs of ``slcl_torch.testing.SPATIAL_CELLS``
  (``slcl`` and the ``mccl`` preset on a small ResNetUNet, ``baseline`` on
  UNet at base 8, ``advent`` and ``adaptseg`` on DeepLabV2 with one block
  a stage, DRUNet's ``slcl`` with ``model.remat`` ``full`` and ``dots``)
  at ``1 x 2`` (one data rank, each image's rows split over two model
  ranks) against one process on the same global batches, in float64:
  every metric (rel 1e-5) and the whole state (rtol 1e-4 / atol 1e-6), the
  data-parallel tolerances of ``tests/test_torch_parallel.py``. The runs
  are compared with one process inside the ranks (``compare_entry``).
- ``mpscl`` on DRUNet and ``slcl`` on the small ResNetUNet at ``2 x 2`` (a
  ``make_mesh(4, model_axis=2)`` mesh) against JAX's spatial step on the
  conftest's virtual CPU devices (``spatial_shard_batch`` and
  ``replicate_state``) from the port's initial weights under
  ``jax.enable_x64``, and against one process; and the same with FSDP
  against one process.
- The rMC draw: each rank keeps the global draw's pixels of its data rank's
  images and its band of their rows.
- Refusals: DeepLabV2 under a contrastive method keeps its ``ValueError``;
  an image height that the model ranks do not divide raises ``ValueError``
  naming H and the ranks; a mesh that does not split rows under
  ``mesh.spatial=true`` raises. (RAIN's cells:
  ``test_torch_parallel_spatial_rain.py``; DDFSeg, AdaptEvery and BCL:
  ``test_torch_parallel_spatial_extra.py``.)

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

from slcl_torch.models.common import BatchNorm, FrozenBatchNorm
from slcl_torch.parallel.dryrun import spawn
from slcl_torch.parallel.spatial import bounds
from slcl_torch.utils.convert import flax_to_state_dict, state_dict_to_flax
from slcl_tpu.models import UncertaintyDiscriminator
from slcl_tpu.models.drunet import DRUNet
from slcl_tpu.models.resnet_unet import ResNetUNet
from slcl_tpu.parallel.mesh import make_mesh, replicate_state, spatial_shard_batch
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)
MOD = "torch_parallel_common"
F64 = torch.float64
METHODS = ("baseline", "adaptseg", "advent", "mpscl", "slcl", "mccl")
# the published backbones and model.remat (slcl_torch.testing.SPATIAL_CELLS)
RUNS = tuple(C.SPATIAL_SIZES)


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
    # the published backbones (ResNetUNet, UNet, DeepLabV2 at 224 and 16 rows)
    def conv(name, rows, k, stride, pad, dil=1, bias=False):
        out = (rows + 2 * pad - dil * (k - 1) - 1) // stride + 1
        cols = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
        case = {"kind": "conv", "x": arr(n, c, rows, w), "w": arr(4, c, k, k),
                "stride": stride, "padding": pad, "dilation": dil, "g": arr(n, 4, out, cols)}
        if bias:
            case["b"] = arr(4)
        cases.append((f"{name}_h{rows}", case))

    for rows in (224, 16):                  # the 7x7 stride-2 stems
        conv("stem7", rows, 7, 2, 3)
    for rows in (56, 28, 14, 4, 2):         # ResNetUNet's strided 3x3 (conv2)
        conv("conv3_s2", rows, 3, 2, 1)
    for rows in (56, 28, 14, 57, 4, 2, 5):  # down_conv / the caffe conv1: 1x1 stride 2
        conv("conv1_s2", rows, 1, 2, 0)
    for rows in (29, 3):                    # DeepLabV2's dilated layers 3-4 and the ASPP
        for d in (2, 4):
            conv(f"conv3_d{d}", rows, 3, 1, d)
        for d in (6, 12, 18, 24):
            conv(f"aspp_d{d}", rows, 3, 1, d, bias=True)
    for ceil, sizes in ((False, (112, 8, 57, 7, 3, 2)), (True, (112, 8, 57, 7, 3, 2))):
        for rows in sizes:                  # the stems' 3x3 stride-2 pools, post-ReLU
            x = np.maximum(arr(n, c, rows, w) - 0.8, 0.0)
            out = F.max_pool2d(torch.from_numpy(x), 3, 2, 1, ceil_mode=ceil).shape
            cases.append((f"pool3_{'ceil' if ceil else 'floor'}_h{rows}",
                          {"kind": "max_pool3", "ceil": ceil, "x": x,
                           "g": arr(*out)}))
    for rows in (14, 28, 56, 112, 1, 2, 4, 8, 7):   # UNet's 2x2 stride-2 up-convs
        cases.append((f"conv_transpose_h{rows}",
                      {"kind": "conv_transpose", "x": arr(n, c, rows, w),
                       "w": arr(c, 4, 2, 2), "b": arr(4), "g": arr(n, 4, 2 * rows, 2 * w)}))
    for rows in (16, 7, 3):                 # DeepLabV2's norms
        cases.append((f"frozen_batchnorm_h{rows}",
                      {"kind": "batchnorm", "frozen": True, "x": arr(n, c, rows, w),
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
    elif kind == "max_pool3":
        y = F.max_pool2d(x, 3, 2, 1, ceil_mode=case["ceil"])
    elif kind == "conv_transpose":
        w = torch.from_numpy(case["w"]).requires_grad_(True)
        b = torch.from_numpy(case["b"]).requires_grad_(True)
        params = {"weight": w, "bias": b}
        y = F.conv_transpose2d(x, w, b, 2)
    elif kind == "nearest":
        y = F.interpolate(x, scale_factor=2, mode="nearest")
    elif kind == "bilinear":
        y = F.interpolate(x, size=case["size"], mode="bilinear", align_corners=True)
    else:
        module = (FrozenBatchNorm if case.get("frozen") else BatchNorm)(x.shape[1]).double()
        params = dict(module.named_parameters())
        # F.batch_norm's path at one process: the two-pass moments
        y = module(x)
    (y * torch.from_numpy(case["g"])).sum().backward()
    buffers = ({n: t.numpy() for n, t in module.named_buffers()} if module is not None
               else {})
    # FrozenBatchNorm's affine takes no gradient
    return (y.detach().numpy(), x.grad.numpy(),
            {k: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
             for k, p in params.items()}, buffers)


def _bands_line_up(case, ranks):
    """A 1x1 strided convolution whose every output band reads only its own
    input band: it must exchange nothing."""
    rows = case["x"].shape[2]
    s = case["stride"]
    bi, bo = bounds(rows, ranks), bounds((rows - 1) // s + 1, ranks)
    return all(bo[m] == bo[m + 1] or (s * bo[m] >= bi[m] and s * (bo[m + 1] - 1) < bi[m + 1])
               for m in range(ranks))


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
    if name.startswith("conv1_s2"):
        exchanges = {g["exchanges"] for g in got}
        assert exchanges == ({0} if _bands_line_up(case, ranks) else {2}), (name, exchanges)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------
def _scheds(method):
    return [C.sched(method), {**C.sched(method), "fresh": 0.0}]


def _specs(methods, fsdp=False):
    out = []
    for m in methods:
        cfg, batches = C.spatial_cfg(m, fsdp), C.batches("mpscl" if m == "slcl" else m, 2)
        out.append((m, cfg, batches, _scheds(m), F64))
    return out


def _run_specs(names, fsdp=False, suffix=""):
    """Specs of the runs of ``slcl_torch.testing.SPATIAL_CELLS``."""
    out = []
    for name in names:
        cfg, batches, shallow = C.spatial_run(name, fsdp)
        out.append((name + suffix, cfg, batches, _scheds(cfg.method), F64, None, shallow))
    return out


@pytest.fixture(scope="module")
def steps_1x2(tmp_path_factory):
    """The DRUNet methods at 1 x 2 and one process; the runs of
    ``SPATIAL_CELLS`` each compared with one process in the ranks
    (``compare_entry``)."""
    tmp = tmp_path_factory.mktemp("sp12")
    specs = _specs(METHODS)
    ranks = spawn(2, "spatial_1x2_entry", (specs, _run_specs(RUNS), str(tmp / "ranks")),
                  model_axis=2, module=MOD, spatial=True)
    one = C.methods_entry(None, specs, str(tmp / "one"))
    return ranks, one


def _check_compared(rec, what):
    """A ``compare_entry`` record: metrics (rel 1e-5) and state as one
    process's."""
    C.assert_metrics_close(rec["metrics"], rec["want_metrics"], 1e-5, what)
    assert not rec["errors"], f"{what}: {rec['errors'][:8]}"


@pytest.mark.parametrize("method", METHODS + RUNS)
@pytest.mark.parametrize("step", [0, 1])
def test_1x2_step_matches_one_process(steps_1x2, method, step):
    ranks, one = steps_1x2
    for r, got in enumerate(ranks):
        if method in RUNS:
            _check_compared(got["runs"][method][step], f"{method} rank {r}")
            continue
        want = one[method]["steps"][step]
        got = got["methods"][method]["steps"][step]
        C.assert_metrics_close(got["metrics"], want["metrics"], 1e-5, f"{method} rank {r}")
        C.assert_state_close(got["state"], want["state"], 1e-4, 1e-6, f"{method} rank {r}")


def _port_arrays(trainer, tree) -> dict:
    """A state tree in flax's layout as ``state_arrays`` of ``trainer``'s
    networks, float64 (the inverse of ``_as_flax``)."""
    out = {}
    for name in ("seg", "d_main", "d_aux"):
        if name in tree:
            sd = flax_to_state_dict(getattr(trainer.state, name), tree[name]["params"],
                                    tree[name].get("batch_stats"))
            out.update({f"{name}/{k}": np.asarray(v, np.float64) for k, v in sd.items()})
    out["centroids"] = np.asarray(tree["centroids"], np.float64)
    return out


def _jax_spatial_steps(trainer, batches, scheds):
    """JAX's step of ``trainer``'s method (``mpscl`` on DRUNet, ``slcl`` on
    ResNetUNet) on a (2, 2) mesh with spatial_shard_batch, from
    ``trainer``'s initial weights, in float64: per step the metrics and the
    state in flax's layout."""
    cfg, s = _jax_cfg(trainer.cfg), trainer.state
    cfg.mesh.spatial = True
    with jax.enable_x64():
        f64 = jnp.float64
        m = cfg.model
        if m.backbone == "resnet50":
            model = ResNetUNet(num_classes=m.num_classes, layers=tuple(m.layers), base=m.base,
                               multilvl=m.multilvl, phead=m.phead, feat_dim=m.filters,
                               dtype=f64)
        else:
            model = DRUNet(filters=m.filters, n_block=m.n_block,
                           bottleneck_depth=m.bottleneck_depth, n_class=m.num_classes,
                           multilvl=m.multilvl, phead=m.phead, dtype=f64)
        disc = UncertaintyDiscriminator(dtype=f64)
        disc_aux = UncertaintyDiscriminator(dtype=f64) if s.d_aux is not None else None
        h = trainer.cfg.data.crop
        state, txs = create_train_state(
            cfg, Preset(_f64(state_dict_to_flax(s.seg))),
            disc=Preset(_f64(state_dict_to_flax(s.d_main))),
            disc_aux=None if disc_aux is None else Preset(_f64(state_dict_to_flax(s.d_aux))),
            sample_shape=(1, h, h, 3), centroids=jnp.asarray(s.centroids.numpy(), f64))
        step = build_step(cfg, model, txs, disc, disc_aux)
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
            if disc_aux is not None:
                tree["d_aux"] = _np({"params": state.d_aux.params})
            out.append(({k: float(v) for k, v in metrics.items()}, tree))
    return out


@pytest.fixture(scope="module")
def steps_2x2(tmp_path_factory):
    """``mpscl`` on DRUNet and ``slcl`` (multilvl + CNR) on ResNetUNet at
    2 x 2: replicated and with FSDP in four ranks, one process, JAX's
    spatial step; and each rank's rMC pixels and the refusals under the
    same mesh."""
    tmp = tmp_path_factory.mktemp("sp22")
    cfg = C.spatial_cfg("mpscl")
    batches = C.batches("mpscl", 2)
    scheds = _scheds("mpscl")
    trainer = C.build_trainer(cfg, str(tmp / "init"), F64)
    jax_out = _jax_spatial_steps(trainer, batches, scheds)
    # ResNetUNet, compared in the ranks (compare_entry) with one process and
    # with JAX's steps in the port's layout; FSDP shards its modules of
    # 65,536 parameters or more
    resnet = _run_specs(["resnet50_slcl"]) + _run_specs(["resnet50_slcl"], True, "_fsdp")
    resnet[1][1].mesh.fsdp_min_size = 65536
    r_trainer = C.build_trainer(resnet[0][1], str(tmp / "init_resnet"), F64)
    r_jax = [(m, _port_arrays(r_trainer, tree))
             for m, tree in _jax_spatial_steps(r_trainer, *resnet[0][2:4])]
    torch.save(r_jax, tmp / "jax_resnet50_slcl.pt")
    specs = [("replicated", cfg, batches, scheds, F64),
             ("fsdp", C.spatial_cfg("mpscl", fsdp=True), batches, scheds, F64)]
    ranks = spawn(4, "spatial_2x2_entry",
                  (specs, str(tmp / "ranks"), resnet,
                   {"resnet50_slcl": str(tmp / "jax_resnet50_slcl.pt")}),
                  model_axis=2, module=MOD, spatial=True)
    one = C.methods_entry(None, specs[:1], str(tmp / "one"))["replicated"]
    return {"jax": jax_out, "trainer": trainer, "ranks": [r["methods"] for r in ranks],
            "runs": [r["runs"] for r in ranks], "one": one,
            "checks": [r["checks"] for r in ranks]}


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


@pytest.mark.parametrize("step", [0, 1])
def test_2x2_resnet50_slcl_matches_jax_spatial_step(steps_2x2, step):
    for r, got in enumerate(steps_2x2["runs"]):
        rec = got["resnet50_slcl"][step]
        C.assert_metrics_close(rec["metrics"], rec["jax_metrics"], 1e-5, f"rank {r}")
        assert not rec["jax_errors"], f"rank {r}: {rec['jax_errors'][:8]}"


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


@pytest.mark.parametrize("kind", ["resnet50_slcl", "resnet50_slcl_fsdp"])
@pytest.mark.parametrize("step", [0, 1])
def test_2x2_resnet50_slcl_matches_one_process(steps_2x2, kind, step):
    for r, got in enumerate(steps_2x2["runs"]):
        rec = got[kind][step]
        if kind.endswith("fsdp"):
            assert rec["sharded"] > 0
        _check_compared(rec, f"{kind} rank {r}")


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


def test_deeplabv2_contrastive_keeps_its_value_error(steps_2x2):
    """DeepLabV2's 2048-wide features under ``slcl`` raise as without a mesh."""
    for got in steps_2x2["checks"]:
        kind, msg = got["deeplabv2_slcl"]
        assert kind == "ValueError" and "model.filters=2048" in msg, msg


def test_indivisible_rows_and_mismatched_mesh_raise(steps_2x2):
    for got in steps_2x2["checks"]:
        kind, msg = got["odd_rows"]
        assert kind == "ValueError" and "H=17" in msg and "2 model ranks" in msg, msg
        kind, msg = got["mismatch"]
        assert kind == "ValueError" and "mesh.spatial=False" in msg, msg
        # DRUNet's mpscl ran on a band of 8 of the 16 rows
        assert got["local_rows"] == C.H // 2
        assert all(np.isfinite(v) for v in got["step"].values())
