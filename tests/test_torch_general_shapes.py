"""The shapes the JAX package trains beyond the published ones: any class
count C (``model.num_classes``), rMC partition count P
(``contrastive.part``) and feature width F (``model.filters``).

On the CUDA side a second, runtime-shape family of kernels takes them
(``csrc/general.cuh``, ``csrc/centroids_gen.cuh``); the card holds it to the
plain versions (``chip_smoke.py`` phase 2). Here, on the CPU:
- the plain versions at C in {2, 5, 8}, P in {1, 3, 4} and F in {20, 24,
  48, 128} against the jnp functions (``slcl_tpu.ops.losses`` /
  ``ops.centroids``, ``jax.grad``) and against the Pallas kernels in
  interpret mode (``mpcl_loss_fused``, ``mpcl_pseudo_fused``,
  ``pseudo_label_fused``, ``soft_centroids_fused`` at ``partition=3,
  num_classes=5`` among others), at the tolerances of tests/test_pallas.py
  and the port's kernel tests: MPCL value rel 1e-4 / gradient rtol 2e-3;
  the fused target branch value rel 1e-4 / gradient rtol 1e-3, atol 1e-6;
  pseudo-labels exact away from near ties; centroids rtol 1e-4 / atol 1e-5,
  ratio rel 1e-5, gradients rtol 2e-3; stddevs and their gradients as
  tests/test_torch_centroids_mccl.py holds them;
- two ``slcl`` steps at C = 5, F = 20 and two ``mccl`` + ``stdmin`` steps
  at P = 3, C = 5, F = 24 against the JAX steps from the same converted
  weights, batches, ``sched`` and (for mccl) JAX's rMC draw, at
  tests/test_torch_step.py's tolerances;
- ``route()`` for every class of shape, the shape limit and its message,
  the wrappers' refusal of a shape beyond it (before any CUDA call), and
  the Trainer's refusal at construction.
M = 2491 = 47 * 53 rows: no multiple of 4, of a warp or of a tile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models import UncertaintyDiscriminator as TDisc
from slcl_torch.ops import centroids as tcen
from slcl_torch.ops import cuda as K
from slcl_torch.ops.cuda import mpcl as K_mpcl
from slcl_torch.ops.cuda import mpcl_pseudo as K_mp
from slcl_torch.ops.cuda import soft_centroids as K_sc
from slcl_torch.ops.cuda.mpcl import mpcl_plain
from slcl_torch.ops.cuda.mpcl_pseudo import mpcl_pseudo_plain
from slcl_torch.train.state import create_train_state as t_create_train_state
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.train.trainer import Trainer, check_kernel_shapes
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models import UncertaintyDiscriminator, build_segmentor
from slcl_tpu.ops import centroids as cen
from slcl_tpu.ops import losses as L
from slcl_tpu.ops.pallas import (mpcl_loss_fused, mpcl_pseudo_fused, pseudo_label_fused,
                                 soft_centroids_fused)
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)

H, W = 47, 53
M = H * W
T, BASE_T, MARGIN, TH = 0.1, 1.0, 0.4, 0.25
# (C, F) of the row kernels and (C, P, F) of the centroids: every C in
# {2, 5, 8}, P in {1, 3, 4} and F in {20, 24, 48, 128}
ROW_SHAPES = [(2, 20), (5, 24), (8, 48), (5, 128)]
CENTROID_SHAPES = [(2, 1, 20), (5, 3, 24), (8, 4, 48), (5, 4, 128)]


def _rows(seed, c, f):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(M, f)).astype(np.float32)
    centers = rng.normal(size=(c, f)).astype(np.float32)
    labels = rng.integers(0, c, size=(M,)).astype(np.int32)
    sel = rng.integers(0, 2, size=(M,)).astype(np.float32)
    return feats, centers, labels, sel


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _near_tie_rows(feats, centers):
    f = feats.astype(np.float64)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    top = np.sort(f @ _unit(centers.astype(np.float64)).T, axis=1)
    gap = top[:, -1] - top[:, -2]
    return (np.abs(gap) < 1e-6) | (np.abs(gap - TH) < 1e-6)


# ---------------------------------------------------------------------------
# the plain versions against jnp and the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("c,f", ROW_SHAPES)
def test_mpcl_plain_general_shapes_match_reference(reference, c, f):
    feats, centers, labels, sel = _rows(10 * c + f, c, f)
    centers = _unit(centers)
    x = torch.from_numpy(feats).requires_grad_(True)
    got = mpcl_plain(x, torch.from_numpy(labels), torch.from_numpy(centers),
                     torch.from_numpy(sel), temperature=T, base_temperature=BASE_T,
                     margin=MARGIN)
    (g,) = torch.autograd.grad(got, x)

    def fn(xj):
        if reference == "jnp":
            return L.mpcl_loss_calc(xj.reshape(1, H, W, f), jnp.asarray(labels),
                                    jnp.asarray(centers), temperature=T,
                                    base_temperature=BASE_T, margin=MARGIN,
                                    pixel_sel_loc=jnp.asarray(sel), resize_labels=False)
        return mpcl_loss_fused(xj, jnp.asarray(labels), jnp.asarray(centers), T, BASE_T,
                               MARGIN, False, True, jnp.asarray(sel))
    if reference == "pallas":
        with pltpu.force_tpu_interpret_mode():
            want, gw = jax.value_and_grad(fn)(jnp.asarray(feats))
    else:
        want, gw = jax.value_and_grad(fn)(jnp.asarray(feats))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=2e-3, atol=1e-7)


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("c,f", ROW_SHAPES)
def test_mpcl_pseudo_plain_general_shapes_match_reference(reference, c, f):
    feats, centers, _, _ = _rows(20 * c + f, c, f)
    centers = _unit(centers)
    assert not _near_tie_rows(feats, centers).any()
    x = torch.from_numpy(feats).requires_grad_(True)
    got = mpcl_pseudo_plain(x, torch.from_numpy(centers), temperature=T,
                            base_temperature=BASE_T, margin=MARGIN, pixel_sel_th=TH)
    (g,) = torch.autograd.grad(got, x)

    def fn(xj):
        if reference == "jnp":
            x4 = xj.reshape(1, H, W, f)
            lab, s = cen.generate_pseudo_label(x4, jnp.asarray(centers), pixel_sel_th=TH)
            return L.mpcl_loss_calc(x4, lab, jnp.asarray(centers), temperature=T,
                                    base_temperature=BASE_T, margin=MARGIN,
                                    pixel_sel_loc=s, resize_labels=False)
        return mpcl_pseudo_fused(xj, jnp.asarray(centers), T, BASE_T, MARGIN, False, TH)
    if reference == "pallas":
        with pltpu.force_tpu_interpret_mode():
            want, gw = jax.value_and_grad(fn)(jnp.asarray(feats))
    else:
        want, gw = jax.value_and_grad(fn)(jnp.asarray(feats))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("c,f", ROW_SHAPES)
def test_pseudo_label_plain_general_shapes_match_reference(reference, c, f):
    feats, centers, _, _ = _rows(30 * c + f, c, f)
    lab, mask = tcen.generate_pseudo_label(torch.from_numpy(feats.reshape(1, H, W, f)),
                                           torch.from_numpy(centers), pixel_sel_th=TH)
    if reference == "jnp":
        want_lab, want_mask = cen.generate_pseudo_label(
            jnp.asarray(feats.reshape(1, H, W, f)), jnp.asarray(centers), pixel_sel_th=TH)
    else:
        with pltpu.force_tpu_interpret_mode():
            want_lab, want_mask = pseudo_label_fused(jnp.asarray(feats), jnp.asarray(centers),
                                                     TH)
    near = _near_tie_rows(feats, centers)
    differ = (lab.numpy() != np.asarray(want_lab)) | (mask.numpy() != np.asarray(want_mask))
    assert not np.any(differ & ~near), f"{int(differ.sum())} rows differ"
    assert 0 < mask.numpy().sum() < M


def _centroid_data(c, P, f):
    rng = np.random.default_rng(100 * c + 10 * P + f)
    feats = rng.normal(size=(M, f)).astype(np.float32)
    logits = 2.0 * rng.normal(size=(M, c)).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    dc = rng.normal(size=(P, c, f)).astype(np.float32)
    ds = rng.normal(size=(c,)).astype(np.float32)
    key = jax.random.PRNGKey(c + P)
    # the draw target_soft_centroids makes from its rng (centroids.py:124)
    assign = np.array(jax.random.randint(key, (M,), 0, P)) if P > 1 else None
    return feats, probs, dc, ds, key, assign


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("c,P,f", CENTROID_SHAPES)
def test_soft_centroids_plain_general_shapes_match_jnp_and_pallas(c, P, f, weighted):
    """Centroids, ratio and stddevs, and the gradients of sum(cents * dc) +
    sum(std * ds) to features and probabilities, against jnp; the centroids
    and ratio also against the Pallas kernel (forward only)."""
    feats, probs, dc, ds, key, assign = _centroid_data(c, P, f)
    thd = 0.4
    x = torch.from_numpy(feats.reshape(1, H, W, f)).requires_grad_(True)
    p = torch.from_numpy(probs.reshape(1, H, W, c)).requires_grad_(True)
    res = tcen.target_soft_centroids(
        x, p, partition=P, assign=None if assign is None else torch.from_numpy(assign),
        threshold=thd, weighted_ave=weighted, num_classes=c, with_std=True)
    y = (res.centroids * torch.from_numpy(dc)).sum() + (res.stddevs * torch.from_numpy(ds)).sum()
    gx, gp = torch.autograd.grad(y, [x, p], allow_unused=True)
    gp = torch.zeros_like(p) if gp is None else gp     # hard weights: none to probs

    def fn(xj, pj):
        r = cen.target_soft_centroids(xj.reshape(1, H, W, f), pj.reshape(1, H, W, c),
                                      partition=P, rng=key if P > 1 else None, threshold=thd,
                                      weighted_ave=weighted, num_classes=c)
        return (jnp.sum(r.centroids * dc) + jnp.sum(r.stddevs * ds),
                (r.centroids, r.ratio, r.stddevs))
    (_, (w_c, w_r, w_s)), (wgx, wgp) = jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(probs))
    got = res.centroids.detach().numpy()
    assert got.shape == (P, c, f)
    np.testing.assert_allclose(got, np.asarray(w_c), rtol=1e-4, atol=1e-5)
    assert float(res.ratio) == pytest.approx(float(w_r), rel=1e-5)
    np.testing.assert_allclose(res.stddevs.detach().numpy(), np.asarray(w_s), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gx.numpy().reshape(M, f), np.asarray(wgx), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(gp.numpy().reshape(M, c), np.asarray(wgp), rtol=2e-3, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        pc, pr = soft_centroids_fused(
            jnp.asarray(feats), jnp.asarray(probs),
            jnp.asarray(assign if assign is not None else np.zeros(M, np.int32)),
            partition=P, threshold=thd, weighted_ave=weighted, num_classes=c)
    np.testing.assert_allclose(got, np.asarray(pc), rtol=1e-4, atol=1e-5)
    assert float(res.ratio) == pytest.approx(float(pr), rel=1e-5)


# ---------------------------------------------------------------------------
# the steps against JAX's
# ---------------------------------------------------------------------------
SH, SW, BS = 32, 32, 2
STEP_SIZES = dict(n_block=2, bottleneck_depth=2)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _assert_tree_close(got, want, rtol, atol, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")
    assert len(jax.tree.leaves(got)) == len(flat_w), what


def _step_cfg(cls, recipe, method, c, f, contrastive):
    cfg = cls()
    cfg.method = method
    cfg = recipe(cfg)
    cfg.model.multilvl = method == "slcl"
    cfg.model.dtype = "float32"
    cfg.model.num_classes, cfg.model.filters = c, f
    cfg.data.crop, cfg.data.bs = SH, BS
    for k, v in STEP_SIZES.items():
        setattr(cfg.model, k, v)
    for k, v in contrastive.items():
        setattr(cfg.contrastive, k, v)
    return cfg


# (method, C, F, contrastive overrides)
STEP_RUNS = {"slcl_c5_f20": ("slcl", 5, 20, {}),
             "mccl_p3_c5_f24_std": ("mccl", 5, 24, dict(part=3, stdmin=True, w_stdmin=0.1))}


def _two_steps(run):
    method, c, f, contrastive = STEP_RUNS[run]
    cfg = _step_cfg(Config, apply_recipe, method, c, f, contrastive)
    tcfg = _step_cfg(TConfig, t_apply_recipe, method, c, f, contrastive)
    model = build_segmentor(cfg.model)
    zeros = jnp.zeros((c, f), jnp.float32)
    sizes = dict(filters=f, n_class=c, **STEP_SIZES)
    if method == "slcl":
        disc = UncertaintyDiscriminator(dtype=jnp.float32)
        disc_aux = UncertaintyDiscriminator(dtype=jnp.float32)
        state, txs = create_train_state(cfg, model, disc=disc, disc_aux=disc_aux,
                                        sample_shape=(1, SH, SW, 3), centroids=zeros)
        step = build_step(cfg, model, txs, disc, disc_aux)
        seg = load_flax_weights(TDRUNet(multilvl=True, **sizes).to(
            memory_format=torch.channels_last), _np(state.seg.params),
            _np(state.seg.batch_stats))
        d_main = load_flax_weights(TDisc(c), _np(state.d_main.params))
        d_aux = load_flax_weights(TDisc(c), _np(state.d_aux.params))
        tstate = t_create_train_state(tcfg, seg, disc=d_main, disc_aux=d_aux,
                                      centroids=torch.zeros(c, f))
        tstep = t_build_step(tcfg)
    else:
        state, txs = create_train_state(cfg, model, sample_shape=(1, SH, SW, 3),
                                        centroids=zeros)
        step = build_step(cfg, model, txs)
        seg = load_flax_weights(TDRUNet(phead=True, **sizes).to(
            memory_format=torch.channels_last), _np(state.seg.params),
            _np(state.seg.batch_stats))
        tstate = t_create_train_state(tcfg, seg, centroids=torch.zeros(c, f))
        draw = {}

        def jax_draw(m, P, device):
            _, rng_part, _ = jax.random.split(draw["rng"], 3)
            ids = jax.random.randint(rng_part, (m,), 0, P)
            return torch.from_numpy(np.array(ids, np.int32)).to(device)
        tstep = t_build_step(tcfg, draw_assign=jax_draw)
    rng = np.random.default_rng(7)
    sched = {"lr": 8e-4, "lr_dis": 1e-4, "warm": 1.0}
    jsched = {k: jnp.asarray(v, jnp.float32) for k, v in sched.items()}
    out = []
    for _ in range(2):
        batch = {"img_s": rng.normal(size=(BS, SH, SW, 3)).astype(np.float32),
                 "lab_s": rng.integers(0, c, size=(BS, SH, SW)).astype(np.int32),
                 "img_t": rng.normal(0.5, 1.5, size=(BS, SH, SW, 3)).astype(np.float32)}
        if method == "mccl":
            batch["img_t_aug"] = rng.normal(0.5, 1.5, size=(BS, SH, SW, 3)).astype(np.float32)
            draw["rng"] = state.rng
        state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jsched)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, sched)
        out.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()},
                    _np({"seg": state.seg.params, "bs": state.seg.batch_stats,
                         "centroids": state.centroids}),
                    {"seg": state_dict_to_flax(tstate.seg),
                     "centroids": tstate.centroids.numpy().copy()}))
    return out


@pytest.fixture(scope="module")
def step_runs():
    return {run: _two_steps(run) for run in STEP_RUNS}


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("run", list(STEP_RUNS))
def test_general_shape_steps_match_jax(step_runs, run, i):
    """Every metric, the segmentor's parameters (rtol 1e-4 / atol 1e-6),
    BatchNorm statistics and the class centres (rtol 1e-4 / atol 1e-5)."""
    want, got, want_state, got_state = step_runs[run][i]
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k
    _assert_tree_close(got_state["seg"]["params"], want_state["seg"], 1e-4, 1e-6,
                       f"{run} step {i}")
    _assert_tree_close(got_state["seg"]["batch_stats"], want_state["bs"], 1e-4, 1e-5,
                       f"{run} step {i} batch_stats")
    np.testing.assert_allclose(got_state["centroids"], want_state["centroids"], rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# route, the limit, the refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,P,F,want", [
    (4, 1, 32, "templated"), (4, 2, 8, "templated"), (4, 2, 16, "templated"),
    (4, 1, 64, "templated"),
    (5, 1, 32, "general"),     # another class count
    (4, 3, 32, "general"),     # more partitions
    (4, 1, 48, "general"),     # a width between the compiled ones
    (4, 1, 20, "general"),     # a width that is no multiple of 8
    (4, 1, 128, "general"),    # wider than the compiled ones
    (2, 4, 24, "general"),     # all three
])
def test_route_by_shape(C, P, F, want):
    for dtype in (torch.bfloat16, torch.float32):
        assert K.route(C, P, F, dtype) == want
    with pytest.raises(TypeError):
        K.route(C, P, F, torch.float16)


def test_shape_limit_and_its_message():
    K.check_shape(8, 128, 4, with_std=True)          # well within
    K.check_shape(4, 2048)                           # DeepLabV2's width
    need = K.general_smem(5, 4, 48, True)
    assert need == {"rows": 4 * (5 * 48 + 256 * 5),
                    "centroid_fwd": 4 * 5 * (4 * 5 * 48 + 4 * 5 + 1 + 5 * 48),
                    "centroid_final": 4 * (2 * 48 + 4),
                    "centroid_bwd": 4 * (4 * 5 * 48 + 4 * 5 + 2 * 5 * 48)}
    with pytest.raises(ValueError) as e:
        K.check_shape(64, 1024, 8, with_std=True)
    msg = str(e.value)
    assert "C=64" in msg and "P=8" in msg and "F=1024" in msg and str(K.SMEM_LIMIT) in msg
    with pytest.raises(ValueError, match="C=0"):
        K.check_shape(0, 32)
    # a C entry point's -1 names the shape and the limit too
    with pytest.raises(ValueError) as e:
        K.raise_on_error(-1, "soft_centroids_gen_fwd_partial", dict(C=5, P=4, F=48))
    assert "C=5" in str(e.value) and "F=48" in str(e.value)
    assert str(K.SMEM_LIMIT) in str(e.value)


@pytest.mark.parametrize("lib", ["mpcl", "mpcl_pseudo", "soft_centroids"])
def test_wrappers_route_and_refuse_before_any_launch(lib):
    """The wrappers' choice of entry points by shape, and a ValueError
    naming the limit for a shape beyond it, decided from the shapes alone
    (so on a CUDA tensor a call launches a kernel of one family or raises;
    nothing falls back to the plain version)."""
    def route_of(c, p, f):
        feats = torch.zeros(4, f)
        if lib == "soft_centroids":
            return K_sc._route(feats, torch.zeros(4, c), p, p > 1, None)
        mod = K_mpcl if lib == "mpcl" else K_mp
        return mod._route(feats, torch.zeros(c, f), None)
    pre, counters, shape = route_of(4, 1, 32)
    assert not pre.endswith("gen_") and not any(k.name.endswith("_general") for k in counters)
    pre, counters, shape = route_of(5, 3, 20)
    assert pre.endswith("gen_") and all(k.name.endswith("_general") for k in counters)
    assert shape["C"] == 5 and shape["F"] == 20
    with pytest.raises(ValueError, match=str(K.SMEM_LIMIT)):
        route_of(200, 40, 1024)


@pytest.mark.parametrize("method,model,contrastive", [
    ("slcl", dict(num_classes=200, filters=1024), {}),
    ("mpscl", dict(num_classes=64, filters=4096), {}),
    ("mccl", dict(num_classes=16, filters=256), dict(part=64, stdmin=True)),
])
def test_trainer_refuses_a_shape_beyond_the_limit_at_construction(method, model,
                                                                  contrastive):
    cfg = TConfig()
    cfg.method = method
    cfg = t_apply_recipe(cfg)
    for k, v in model.items():
        setattr(cfg.model, k, v)
    for k, v in contrastive.items():
        setattr(cfg.contrastive, k, v)
    with pytest.raises(ValueError) as e:
        Trainer(cfg, device="cpu")
    msg = str(e.value)
    assert f"C={model['num_classes']}" in msg and f"F={model['filters']}" in msg
    assert str(K.SMEM_LIMIT) in msg


def test_trainer_shape_check_passes_the_general_and_ignores_other_methods():
    for method, c, f, part in (("slcl", 5, 24, 1), ("mccl", 5, 48, 4), ("mccl", 8, 20, 3),
                               ("advent", 500, 4096, 1)):
        cfg = TConfig()
        cfg.method = method
        cfg = t_apply_recipe(cfg)
        cfg.model.num_classes, cfg.model.filters, cfg.contrastive.part = c, f, part
        check_kernel_shapes(cfg)
