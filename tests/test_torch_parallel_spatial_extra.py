"""Spatial partitioning of DDFSeg, AdaptEvery and BCL on the port
(``mesh.spatial`` with ``method=ddfseg``, ``adaptevery``, ``bcl``, each on
its own network) on the CPU over gloo, after
``tests/test_torch_parallel_spatial.py``.

- The row-sharded operators these networks add, at 2 and 4 model ranks
  against the unsharded ones, in float64 (rtol 1e-10): DDFSeg's 3x3
  stride-2 transposed convolution (padding 1, output padding 1) at 7, 14,
  28 and 56 rows (a band reads one row of the next, 7 rows over 4 ranks are
  bands of 2, 2, 2, 1); the instance norm, affine (DDFSeg's, eps 1e-5) and
  not (PatchGAN's, eps 1e-6), on the uneven bands of 26 and 27 rows;
  DDFSeg's whole SAGAN ``_Attention`` (train mode: its BatchNorms' batch
  moments and running statistics, dropout masks drawn at the global rows)
  at 28 and 8 rows (pooled bands of one row at 4 ranks); the PatchGAN with
  its aux head at 32 and 40 rows (empty bands at 4 ranks); the output, the
  input's gradient and the summed parameter gradients; and the nearest
  resize of integer labels on global coordinates, 224 -> 29 and 64 -> 9
  (equal).
- Two steps of ``ddfseg`` (slim 4/4/8 at 32 rows, dropout on: the step's
  own masks, drawn at the global rows), ``adaptevery`` and ``bcl`` (one
  block a stage at base 8, 64 rows; ``bcl`` after a pseudo-label round run
  on whole images, its labels the steps' ``plabel_t``) at ``1 x 2`` against
  one process on the same global batches, in float64: every metric (rel
  1e-5), the whole state (rtol 1e-4 / atol 1e-6: the networks, the
  discriminators, ``d_point``'s running statistics) and every optimizer's
  state; the round's labels equal.
- The three methods at ``2 x 2`` (``make_mesh(4, model_axis=2)``) against
  one process as above and against JAX's spatial step
  (``spatial_shard_batch`` and ``replicate_state`` under
  ``jax.enable_x64``) from the same weights, with the tests' dropout masks
  on both sides (JAX's through its interceptor,
  ``tests/torch_extra_common.py``; the port's through ``draw_dropout``):
  ``bcl`` (SGD) in every metric and the whole state at both steps;
  ``ddfseg`` and ``adaptevery`` in every metric of the first step only
  (:data:`JAX_STATE`). Their Adam steps part from JAX's at a few entries
  whose gradient is within the float32 losses' rounding of zero, where
  Adam's first, sign-like step turns another summation order into up to a
  learning rate (with every ``JAX_STATE`` true: DDFSeg's
  ``encodert._ResBlock_0`` and ``encoders._ResBlock_0`` convolutions by
  7.6e-5 and 5.8e-5 at lr 2e-4; ``d_point``'s STN layers by 2e-4, opposite
  moves of lr_dis 1e-4): the packages' own orders, not the bands', since
  the port's 2 x 2 step holds to its one process there.
  ``tests/test_torch_ddfseg.py`` and ``tests/test_torch_adaptevery.py``
  hold the two packages' one-process steps on other draws. ``bcl`` with
  FSDP against one process.
- Weights are drawn as the parity tests draw them (:func:`draw_weights`).

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
from test_torch_parallel import _f64, _jax_cfg, _np
from torch_extra_common import jax_masks, mask

from slcl_torch.config import Config, apply_recipe
from slcl_torch.models.common import dropout_pass
from slcl_torch.parallel.dryrun import spawn
from slcl_torch.parallel.spatial import resize_labels
from slcl_torch.utils.convert import flax_to_state_dict, state_dict_to_flax
from slcl_tpu.models import UncertaintyDiscriminator
from slcl_tpu.models.ddfseg import DDFNet, SegDecoder
from slcl_tpu.models.deeplabv2 import BCLDeepLab
from slcl_tpu.models.discriminators import PatchGAN
from slcl_tpu.models.pointnet import PointNetCls
from slcl_tpu.models.resnet_unet import ResNetUNetPoint
from slcl_tpu.parallel.mesh import make_mesh, replicate_state, spatial_shard_batch
from slcl_tpu.train.state import NetState, TrainState, make_optimizer
from slcl_tpu.train.steps_extra import make_adaptevery_step, make_bcl_step, make_ddfseg_step

torch.set_num_threads(1)
MOD = "torch_parallel_common"
F64 = torch.float64
METHODS = ("ddfseg", "adaptevery", "bcl")


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------
def _op_cases():
    """(name, case) of every operator case; the arrays are made from one seed."""
    rng = np.random.default_rng(19)
    n, w = 2, 5
    cases = []
    for rows in (7, 14, 28, 56):
        cases.append((f"conv_transpose3_s2_h{rows}", {
            "kind": "conv_transpose", "x": rng.normal(size=(n, 3, rows, w)),
            "w": rng.normal(size=(3, 4, 3, 3)), "b": rng.normal(size=4), "stride": 2,
            "padding": 1, "output_padding": 1, "g": rng.normal(size=(n, 4, 2 * rows, 2 * w))}))
    for rows in (26, 27):
        for affine in (True, False):
            case = {"kind": "instance_norm", "eps": 1e-5 if affine else 1e-6,
                    "x": 2.0 * rng.normal(size=(n, 3, rows, w)) + 0.5,
                    "g": rng.normal(size=(n, 3, rows, w))}
            if affine:
                case.update(w=rng.normal(size=3), b=rng.normal(size=3))
            cases.append((f"instance_norm_{'affine' if affine else 'plain'}_h{rows}", case))
    for rows in (28, 8):
        cases.append((f"attention_h{rows}", {
            "kind": "attention", "ch": 16, "seed": rows, "x": rng.normal(size=(n, 16, rows, 6)),
            "g": rng.normal(size=(n, 16, rows, 6))}))
    for rows, out in ((224, 29), (64, 9)):
        labels = rng.integers(0, 5, size=(n, rows, rows)).astype(np.int32)
        labels[:, ::7] = 255
        cases.append((f"resize_labels_{rows}_to_{out}",
                       {"kind": "resize_labels", "labels": labels, "size": (out, out)}))
    for rows, rows_out in ((32, 2), (40, 3)):
        cases.append((f"patchgan_h{rows}", {
            "kind": "patchgan", "ch": 4, "seed": rows, "x": rng.normal(size=(n, 2, rows, 24)),
            "g": rng.normal(size=(n, 2, rows_out, 1))}))
    return cases


OPS = _op_cases()


def _plain(case):
    """The unsharded operator: (output, input gradient, parameter gradients,
    buffers)."""
    kind = case["kind"]
    if kind == "resize_labels":
        return resize_labels(torch.from_numpy(case["labels"]),
                             case["size"]).numpy(), None, {}, {}
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    params, module = {}, None
    if kind == "conv_transpose":
        params = {"weight": torch.from_numpy(case["w"]).requires_grad_(True),
                  "bias": torch.from_numpy(case["b"]).requires_grad_(True)}
        y = F.conv_transpose2d(x, params["weight"], params["bias"], 2, 1, 1)
    elif kind == "instance_norm":
        if "w" in case:
            params = {"weight": torch.from_numpy(case["w"]).requires_grad_(True),
                      "bias": torch.from_numpy(case["b"]).requires_grad_(True)}
        y = F.group_norm(x, x.shape[1], params.get("weight"), params.get("bias"),
                         case["eps"])
    else:
        module = C.extra_module(case)
        params = dict(module.named_parameters())
        if kind == "attention":
            with dropout_pass(C.mask_draw):
                y = module(x)
        else:
            y = torch.cat(module(x.permute(0, 2, 3, 1)), dim=-1).permute(0, 3, 1, 2)
    (y * torch.from_numpy(case["g"])).sum().backward()
    buffers = {} if module is None else {n: t.numpy() for n, t in module.named_buffers()}
    return (y.detach().numpy(), x.grad.numpy(),
            {k: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
             for k, p in params.items()}, buffers)


@pytest.fixture(scope="module")
def op_runs():
    cases = [c for _, c in OPS]
    return {m: spawn(m, "spatial_ops_entry", (cases,), model_axis=m, module=MOD, spatial=True)
            for m in (2, 4)}


def test_masks_are_the_jax_tests_masks():
    """The ranks' dropout masks are the ones JAX's interceptor draws."""
    for path, call in (("encoders/_Attention_0/conv_f/Dropout_0", 0), ("Dropout_1", 3)):
        np.testing.assert_array_equal(C.dropout_mask(path, call, (2, 5, 3), 0.75),
                                      mask(path, call, (2, 5, 3), 0.75))


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("i", range(len(OPS)), ids=[name for name, _ in OPS])
def test_extra_operator_matches_unsharded(op_runs, ranks, i):
    name, case = OPS[i]
    y, dx, dparams, buffers = _plain(case)
    got = [r[i] for r in op_runs[ranks]]
    # every layout is one of bounds(): the bands in rank order are the tensor
    axis = 1 if case["kind"] == "resize_labels" else 2
    out = np.concatenate([g["y"] for g in got], axis=axis)
    if case["kind"] == "resize_labels":
        np.testing.assert_array_equal(out, y, err_msg=name)
        return
    np.testing.assert_allclose(out, y, rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got], axis=2), dx,
                               rtol=1e-10, atol=1e-12, err_msg=name)
    assert set(got[0]["dparams"]) == set(dparams), name
    for k, want in dparams.items():
        np.testing.assert_allclose(sum(g["dparams"][k] for g in got), want, rtol=1e-10,
                                   atol=1e-12, err_msg=f"{name} {k}")
    for g in got:
        for k, want in buffers.items():
            np.testing.assert_allclose(g["buffers"][k], want, rtol=1e-10, atol=1e-12,
                                       err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------
# (crop, global batch) of each method's steps
SIZES = {"ddfseg": (32, 2), "adaptevery": (64, 2), "bcl": (64, 2)}
SCHEDS = {"ddfseg": {"lr": 2e-4, "lr_dis": 1e-4}, "adaptevery": {"lr": 8e-4, "lr_dis": 1e-4},
          "bcl": {"lr": 8e-4}}


def _cfg(method: str, data_axis: int = 1, fsdp: bool = False) -> Config:
    """``method`` on its own network at the sizes of :data:`SIZES`, f32, its
    rows split over two model ranks."""
    cfg = Config()
    cfg.method = method
    cfg = apply_recipe(cfg)
    cfg.model.dtype = "float32"
    cfg.data.dataset = "synthetic"
    cfg.data.num_workers = 1
    cfg.data.crop, cfg.data.bs = SIZES[method]
    cfg.data.eval_bs = cfg.data.bs
    cfg.optim.epochs = 1
    d = cfg.ddfseg
    d.filters, d.style_filters, d.ngf, d.slim = 4, 4, 8, True
    cfg.model.layers, cfg.model.base = (1, 1, 1, 1), 8
    cfg.mesh.model_axis, cfg.mesh.spatial = 2, True
    cfg.mesh.fsdp, cfg.mesh.fsdp_min_size = fsdp, 1024
    return cfg


def _spec(method: str, weights: str, name: str = "", draws: dict = None,
          options: dict = None, fsdp: bool = False):
    crop, bs = SIZES[method]
    return (name or method, _cfg(method, fsdp=fsdp), C.batches(method, 2, h=crop, bs=bs),
            [SCHEDS[method]] * 2, F64, draws, "",
            {"opt": True, "weights": weights, **(options or {})})


def draw_weights(trainer, seed: int) -> dict:
    """Every network of ``trainer`` drawn as ``tests/torch_extra_common.py::
    draw_variables`` draws flax variables: kernels N(0, 1) / sqrt(fan_in),
    norm scales 1 + 0.1 N(0, 1), biases and running means 0.1 N(0, 1),
    running variances |N(0, 1)| + 0.5; the attention's ``gamma`` 0, as
    ``tests/test_torch_ddfseg.py``'s steps start. The trainers' own init
    (N(0, 0.01) convolutions, twenty-odd deep) leaves the first layers'
    gradients within the float32 losses' rounding, which Adam's first,
    sign-like update turns into up to a learning rate between any two
    summation orders (the port's and JAX's). Loaded into the trainer;
    returns the whole state dicts by network."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("seg", "d_main", "d_aux", "d_seg", "d_ent", "d_point"):
        net = getattr(trainer.state, name)
        if net is None:
            continue
        sd = {}
        for k, v in net.state_dict().items():
            n = rng.normal(size=tuple(v.shape))
            if k.endswith("gamma"):
                a = np.zeros(v.shape)
            elif k.endswith("running_var"):
                a = np.abs(n) + 0.5
            elif k.endswith("weight") and v.dim() >= 2:
                a = n / np.sqrt(v[0].numel() if "ConvTranspose" not in k else v.shape[0] * v[0, 0].numel())
            elif k.endswith("weight"):
                a = 1.0 + 0.1 * n
            else:
                a = 0.1 * n
            sd[k] = torch.from_numpy(a).to(v.dtype)
        net.load_state_dict(sd)
        out[name] = sd
    return out


def weights_file(method: str, tmp) -> tuple:
    """(a trainer of ``method`` in float64 with :func:`draw_weights`, the file
    of those weights for ``steps_entry``)."""
    trainer = C.build_trainer(_cfg(method), str(tmp / f"init_{method}"), F64)
    path = tmp / f"weights_{method}.pt"
    torch.save(draw_weights(trainer, 31), path)
    return trainer, str(path)


# whether the 2 x 2 state is held to JAX's spatial step's (its metrics are
# at the first step): not under Adam, whose first, sign-like step turns the
# two packages' float32 rounding at near-zero gradients into up to a
# learning rate (the module docstring)
JAX_STATE = {"ddfseg": False, "adaptevery": False, "bcl": True}


def _check(rec, what, jax: str = "", step: int = 0):
    """A ``compare_entry`` record: metrics (rel 1e-5), the whole state and the
    optimizers' state as one process's; with ``jax`` (the method) also as
    JAX's spatial step's (:data:`JAX_STATE`)."""
    C.assert_metrics_close(rec["metrics"], rec["want_metrics"], 1e-5, what)
    assert not rec["errors"], f"{what}: {rec['errors'][:8]}"
    assert rec["opt_errors"] == [], f"{what} optimizers: {rec['opt_errors'][:8]}"
    if jax and (JAX_STATE[jax] or step == 0):
        C.assert_metrics_close(rec["metrics"], rec["jax_metrics"], 1e-5, f"{what} jax")
    if jax and JAX_STATE[jax]:
        assert not rec["jax_errors"], f"{what} jax: {rec['jax_errors'][:8]}"


@pytest.fixture(scope="module")
def runs_1x2(tmp_path_factory):
    """The three methods at 1 x 2 on their own draws against one process,
    ``bcl`` after a pseudo-label round."""
    tmp = tmp_path_factory.mktemp("extra12")
    specs = [_spec(m, weights_file(m, tmp)[1], options={"round_first": m == "bcl"})
             for m in METHODS]
    return spawn(2, "compare_entry", (specs, str(tmp / "ranks")), model_axis=2, module=MOD,
                 spatial=True)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("step", [0, 1])
def test_1x2_step_matches_one_process(runs_1x2, method, step):
    for r, got in enumerate(runs_1x2):
        rec = got[method][step]
        assert all(np.isfinite(v) for v in rec["metrics"].values())
        _check(rec, f"{method} step {step} rank {r}")
        if method == "bcl":
            assert rec["round_equal"], f"rank {r}: the pseudo-label round differs"


# ---------------------------------------------------------------------------
# JAX's spatial steps
# ---------------------------------------------------------------------------
def _jax_state(method, s, cfg):
    """(JAX's models, optimizers and TrainState) from the port's initial
    state ``s``, float64."""
    f64 = jnp.float64
    lr_d = make_optimizer("adam", cfg.optim.lr_dis, betas=(cfg.adv.mmt1, cfg.adv.mmt))

    def net(module, tx):
        v = _f64(state_dict_to_flax(module))
        return NetState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                        opt_state=tx.init(v["params"]))

    if method == "ddfseg":
        d = cfg.ddfseg
        models = (DDFNet(filters=d.filters, style_filters=d.style_filters, ngf=d.ngf,
                         slim=d.slim, dtype=f64),
                  SegDecoder(cfg.model.num_classes, ngf=d.ngf, slim=d.slim, dtype=f64),
                  PatchGAN(aux=True, dtype=f64), PatchGAN(dtype=f64), PatchGAN(dtype=f64))
        tx = make_optimizer("adam", cfg.optim.lr)
        dv, sv = _f64(state_dict_to_flax(s.seg.ddfnet)), _f64(state_dict_to_flax(s.seg.segdecoder))
        params = {"ddfnet": dv["params"], "segdecoder": sv["params"]}
        state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                           seg=NetState(params=params,
                                        batch_stats={"ddfnet": dv["batch_stats"],
                                                     "segdecoder": {}},
                                        opt_state=tx.init(params)),
                           d_main=net(s.d_main, lr_d), d_aux=net(s.d_aux, lr_d),
                           extra={"d_seg": net(s.d_seg, lr_d)})
        step = make_ddfseg_step(cfg, *models, {"seg": tx, "d_main": lr_d, "d_aux": lr_d,
                                               "d_seg": lr_d})
        return step, state
    m = cfg.model
    tx = make_optimizer(cfg.optim.optimizer if method == "adaptevery" else "sgd", cfg.optim.lr,
                        momentum=cfg.optim.momentum, weight_decay=cfg.optim.weight_decay)
    if method == "adaptevery":
        dec = tuple(max(2, m.base * 4 >> i) for i in range(5))
        model = ResNetUNetPoint(num_classes=m.num_classes, layers=tuple(m.layers), base=m.base,
                                decoder_channels=dec, dtype=f64)
        ds = [UncertaintyDiscriminator(base=m.base, dtype=f64) for _ in range(3)]
        state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                           seg=net(s.seg, tx), d_main=net(s.d_main, lr_d),
                           d_aux=net(s.d_aux, lr_d),
                           extra={"d_ent": net(s.d_ent, lr_d), "d_point": net(s.d_point, lr_d)})
        step = make_adaptevery_step(cfg, model, *ds, PointNetCls(k=1, base=m.base, dtype=f64),
                                    {"seg": tx, "d_main": lr_d, "d_aux": lr_d, "d_ent": lr_d,
                                     "d_point": lr_d})
        return step, state
    model = BCLDeepLab(num_classes=m.num_classes, layers=tuple(m.layers), base=m.base,
                       dtype=f64)
    state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                       seg=net(s.seg, tx))
    return make_bcl_step(cfg, model, {"seg": tx}), state


def _jax_arrays(method, s, state) -> dict:
    """JAX's state after a step as the port's ``state_arrays``."""
    def arrays(name, module, net):
        sd = flax_to_state_dict(module, _np(net.params), _np(net.batch_stats) or None)
        return {f"{name}/{k}": np.asarray(v, np.float64) for k, v in sd.items()}

    if method == "ddfseg":
        out = {}
        for part in ("ddfnet", "segdecoder"):
            sd = flax_to_state_dict(getattr(s.seg, part), _np(state.seg.params[part]),
                                    _np(state.seg.batch_stats[part]) or None)
            out.update({f"seg/{part}.{k}": np.asarray(v, np.float64) for k, v in sd.items()})
        out.update(arrays("d_main", s.d_main, state.d_main))
        out.update(arrays("d_aux", s.d_aux, state.d_aux))
        out.update(arrays("d_seg", s.d_seg, state.extra["d_seg"]))
        return out
    out = arrays("seg", s.seg, state.seg)
    if method == "adaptevery":
        out.update(arrays("d_main", s.d_main, state.d_main))
        out.update(arrays("d_aux", s.d_aux, state.d_aux))
        for k in ("d_ent", "d_point"):
            out.update(arrays(k, getattr(s, k), state.extra[k]))
    return out


def jax_spatial_steps(method, trainer, batches, scheds):
    """JAX's step of ``method`` on a (2, 2) mesh with spatial_shard_batch,
    from ``trainer``'s initial state, in float64, with the tests' dropout
    masks: per step (metrics, the state as ``state_arrays``)."""
    cfg, s = _jax_cfg(trainer.cfg), trainer.state
    out = []
    with jax.enable_x64(), jax_masks():
        step, state = _jax_state(method, s, cfg)
        mesh = make_mesh(4, model_axis=2)
        for b, sc in zip(batches, scheds):
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
            js = {k: jnp.asarray(v, jnp.float64) for k, v in sc.items()}
            with mesh:
                sharded = spatial_shard_batch(b, mesh)
                state, metrics = step(replicate_state(state, mesh), sharded, js)
            out.append(({k: float(v) for k, v in metrics.items()},
                        _jax_arrays(method, s, state)))
    return out


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory):
    """The three methods at 2 x 2 on the tests' masks against one process and
    JAX's spatial step; ``bcl`` with FSDP against one process."""
    tmp = tmp_path_factory.mktemp("extra22")
    specs, expected = [], {}
    for method in METHODS:
        trainer, weights = weights_file(method, tmp)
        spec = _spec(method, weights, draws={"dropout": True})
        path = tmp / f"jax_{method}.pt"
        torch.save(jax_spatial_steps(method, trainer, spec[2], spec[3]), path)
        specs.append(spec)
        expected[method] = str(path)
    specs.append(_spec("bcl", specs[-1][7]["weights"], "bcl_fsdp", fsdp=True))
    return spawn(4, "compare_entry", (specs, str(tmp / "ranks"), expected), model_axis=2,
                 module=MOD, spatial=True)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("step", [0, 1])
def test_2x2_step_matches_jax_spatial_step_and_one_process(runs_2x2, method, step):
    for r, got in enumerate(runs_2x2):
        _check(got[method][step], f"{method} step {step} rank {r}", jax=method, step=step)


@pytest.mark.parametrize("step", [0, 1])
def test_2x2_bcl_fsdp_matches_one_process(runs_2x2, step):
    for r, got in enumerate(runs_2x2):
        rec = got["bcl_fsdp"][step]
        assert rec["sharded"] > 0
        _check(rec, f"bcl fsdp step {step} rank {r}")
