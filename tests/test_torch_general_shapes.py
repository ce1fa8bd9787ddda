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
import subprocess
from pathlib import Path

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
    # the backward's ring at the mccl_p4_c5_f48_std cell's shape (bf16,
    # dprobs): the coefficients, rounded up to 16; S stages' barriers; the
    # row tables of a 160-row tile (8 warps of 4 passes of 5 rows: weights,
    # partition, g); the dprobs partials of its rows (5 classes a row, 6
    # chunks a class padded to 8); rounded up to 128; then S stages of 160
    # rows' features, probs and ids, as many as the 110 KB budget holds (at
    # most 2)
    coef = 4 * (4 * 5 * 48 + 4 * 5 + 2 * 5 * 48)
    stage = 160 * (48 * 2 + 5 * 4 + 4)
    S = max(n for n in range(2, 3)
            if -(-(coef + 16 * n + 160 * (5 + 2) * 4 + 160 * 5 * 8 * 4) // 128) * 128
            + n * stage <= K.GEN_BWD_BUDGET)
    ring_at = -(-(coef + 16 * S + 160 * (5 + 2) * 4 + 160 * 5 * 8 * 4) // 128) * 128
    # the forward's ring there: 128-row tiles (15,360 bf16 bytes, within the
    # 20 KB aimed at); 4 n-tiles (P*C + 1 = 21 columns rounded up to 24,
    # then the std's 5 to 8); the stages' full and empty barriers (16 bytes
    # a stage) and the two tables' row partitions (2 x 128 ints), rounded
    # up to 128: 1,152 bytes; two weight tables of 3 terms x 32
    # columns x 136 (128 rows and 8 more), bf16; then 3 stages in bf16 (4
    # groups of two warps), 2 in f32 (3 would pass the 110 KB budget): the
    # larger, f32's
    head = 1152 + 2 * 3 * 32 * 136 * 2
    assert K.gen_fwd_plan(5, 4, 48, True, 2)["smem"] == head + 3 * 128 * (48 * 2 + 24)
    assert head + 3 * 128 * (48 * 4 + 24) > K.GEN_FWD_BUDGET
    assert need == {"rows": 4 * (5 * 48 + 256 * 5),
                    "centroid_fwd": head + 2 * 128 * (48 * 4 + 5 * 4 + 4),
                    "centroid_final": 4 * (2 * 48 + 4),
                    "centroid_bwd": ring_at + S * stage}
    assert S == 2
    # the direct form where no ring fits: the coefficients alone
    assert K.general_smem(8, 8, 656, True)["centroid_bwd"] == 4 * (64 * 656 + 64 + 2 * 8 * 656)
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


# ---------------------------------------------------------------------------
# the general centroid backward's plan (csrc/centroids_gen_plan.cuh)
# ---------------------------------------------------------------------------
CSRC = Path(__file__).resolve().parents[1] / "slcl_torch" / "csrc"
PLAN_KEYS = ("form", "V", "nch", "tpr", "rpw", "npw", "rw", "cs", "regs", "feats", "bulk",
             "rows", "stages",
             "feat_bytes", "prob_bytes", "id_bytes", "stage_bytes", "bar_at", "w_at",
             "part_at", "g_at", "pt_at", "ring_at", "smem")
PLAN_MAIN = r"""
#include <cstdio>
#include "centroids_gen_plan.cuh"
int main() {
  int C, P, F, s, es, dp;
  while (std::scanf("%d %d %d %d %d %d", &C, &P, &F, &s, &es, &dp) == 6) {
    const slcl::GenBwdPlan p = slcl::gen_bwd_plan(C, P, F, s != 0, es, dp != 0);
    std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d\n",
                p.form, p.V, p.nch, p.tpr, p.rpw, p.npw, p.rw, p.cs, p.regs, p.feats, p.bulk,
                p.rows,
                p.stages, p.feat_bytes, p.prob_bytes, p.id_bytes, p.stage_bytes, p.bar_at,
                p.w_at, p.part_at, p.g_at, p.pt_at, p.ring_at, p.smem);
  }
}
"""
PLAN_F = (1, 7, 13, 20, 24, 48, 128, 2048)
PLAN_C = (1, 2, 3, 4, 5, 8, 16)
PLAN_P = (1, 2, 3, 4, 8)


def _parent_smem(C, P, F, with_std):
    """The four formulas the general kernels were admitted by before the
    backward's ring (``general_smem`` as it stood): the backward took its
    coefficients alone."""
    s = int(bool(with_std))
    groups = 1 if F >= 256 else 256 // F
    return {"rows": 4 * (C * F + 256 * (C | 1)),
            "centroid_fwd": 4 * groups * (P * C * F + P * C + 1 + s * C * F),
            "centroid_final": 4 * (2 * F + P),
            "centroid_bwd": 4 * (P * C * F + P * C + s * 2 * C * F)}


def _limit_shapes():
    """(C, P, F, std) at the edge of the parent's limit: for each C, F and
    std the largest P whose backward coefficients fit, and one more; the
    widest F at C = P = 1."""
    out = []
    for with_std in (False, True):
        for C in (1, 2, 4, 5, 8, 16):
            for F in (256, 300, 640, 656, 1024, 2048, 4096):
                per_p = 4 * (C * F + C)
                rest = 4 * 2 * C * F if with_std else 0
                p_max = (K.SMEM_LIMIT - rest) // per_p
                out += [(C, p, F, with_std) for p in (p_max, p_max + 1) if p >= 1]
        f_max = (K.SMEM_LIMIT // 4 - 1) // (3 if with_std else 1) - 1
        out += [(1, 1, f, with_std) for f in (f_max, f_max + 1, f_max + 2)]
    return out


def _plan_grid():
    return ([(C, P, F, s) for F in PLAN_F for C in PLAN_C for P in PLAN_P
             for s in (False, True)] + _limit_shapes())


@pytest.fixture(scope="module")
def cpp_plans(tmp_path_factory):
    """Every (C, P, F, std, itemsize, dprobs) of _plan_grid through the C++
    plan, compiled here with g++ from the kernels' own header."""
    tmp = tmp_path_factory.mktemp("plan")
    (tmp / "plan_main.cpp").write_text(PLAN_MAIN)
    exe = tmp / "plan_main"
    subprocess.run(["g++", "-std=c++17", "-O1", "-Wall", "-Werror", "-I", str(CSRC),
                    str(tmp / "plan_main.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, text=True)
    calls = list(dict.fromkeys((C, P, F, s, es, dp) for C, P, F, s in _plan_grid()
                               for es in (2, 4) for dp in (False, True)))
    text = "".join(f"{C} {P} {F} {int(s)} {es} {int(dp)}\n" for C, P, F, s, es, dp in calls)
    out = subprocess.run([str(exe)], input=text, check=True, capture_output=True,
                         text=True).stdout.split("\n")
    plans = {}
    for call, line in zip(calls, out):
        vals = [int(v) for v in line.split()]
        plan = dict(zip(PLAN_KEYS, vals))
        plan["form"] = ("ring", "direct")[plan["form"]]
        plans[call] = plan
    assert len(plans) == len(calls)
    return plans


@pytest.mark.parametrize("f", PLAN_F + ("limit",))
def test_gen_bwd_plan_matches_the_cpp_plan(cpp_plans, f):
    """ops/cuda/__init__.py::gen_bwd_plan (which general_smem and the shape
    check read) is the kernel's own plan, field for field, in bf16 and f32,
    with and without dprobs; where the plan is direct, the fields a ring
    sets do not enter the launch."""
    calls = [c for c in cpp_plans if (c[2] == f if f != "limit" else c[2] not in PLAN_F)]
    assert calls
    for C, P, F, s, es, dp in calls:
        want = cpp_plans[(C, P, F, s, es, dp)]
        got = K.gen_bwd_plan(C, P, F, s, es, dp)
        if want["form"] == "direct":
            keys = ("form", "regs", "bulk", "rows", "smem")
        else:
            keys = PLAN_KEYS
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}, (C, P, F, s, es, dp)


@pytest.mark.parametrize("with_std", [False, True])
@pytest.mark.parametrize("kernels", [("centroid_fwd", "centroid_final", "centroid_bwd"),
                                     ("rows", "centroid_fwd", "centroid_final",
                                      "centroid_bwd"),
                                     ("centroid_bwd",)])
def test_backward_admits_every_shape_the_parent_admitted(kernels, with_std):
    """Every (C, P, F, std) that the parent's formulas admit (by the
    kernels the wrappers and the Trainer check together, and by the
    backward's alone) is admitted, and no other but those the forward's
    ring now takes where the parent's grouped forward did not fit: the
    backward's ring is taken only where it fits, and the direct form needs
    what the parent's backward did. Includes the shapes at the limit, and F
    = 2048 at C = 4, P <= 2 (DeepLabV2's width), admitted in bf16 and f32,
    on the ring in bf16."""
    shapes = [(C, P, F) for C, P, F, s in _plan_grid() if s == with_std]
    assert len(shapes) > 300
    admitted = 0
    for C, P, F in shapes:
        old = _parent_smem(C, P, F, with_std)
        parent_ok = all(old[k] <= K.SMEM_LIMIT for k in kernels)
        fwd_ring = all(K.gen_fwd_plan(C, P, F, with_std, es)["form"] != "grouped"
                       for es in (2, 4))
        want = all(old[k] <= K.SMEM_LIMIT or (k == "centroid_fwd" and fwd_ring)
                   for k in kernels)
        try:
            K.check_shape(C, F, P, with_std, kernels)
            ok = True
        except ValueError:
            ok = False
        assert ok == want, (C, P, F, with_std, kernels)
        assert ok or not parent_ok, (C, P, F, with_std, kernels)
        admitted += ok
        for es in (2, 4):
            for dp in (False, True):
                plan = K.gen_bwd_plan(C, P, F, with_std, es, dp)
                if plan["form"] == "direct":
                    assert plan["smem"] == old["centroid_bwd"]
                else:
                    assert plan["smem"] <= K.SMEM_LIMIT
    assert 0 < admitted < len(shapes)
    for P in (1, 2):
        K.check_shape(4, 2048, P, with_std, kernels)
        for dp in (False, True):
            assert K.gen_bwd_plan(4, P, 2048, with_std, 2, dp)["form"] == "ring"


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("dprobs", [False, True])
def test_ring_stages_are_whole_bulk_copies(itemsize, dprobs):
    """Each ring stage's bulk copies (features when read, probs, ids with P
    > 1) start and end on 16 bytes for a whole tile and sit at 16-byte
    offsets of a 128-byte-aligned ring; the tables lie between the
    coefficients and the ring without overlap; a thread-chunk's vector
    divides the row; the register form holds 8 features a chunk and at
    most GEN_REG_FLOATS floats."""
    rings = 0
    for C, P, F, s in _plan_grid():
        p = K.gen_bwd_plan(C, P, F, s, itemsize, dprobs)
        assert F % p["V"] == 0 and p["nch"] * p["V"] == F
        assert p["tpr"] * p["rpw"] <= 32 and p["tpr"] == min(p["nch"], 32)
        coef = 4 * (P * C * F + P * C + (2 * C * F if s else 0))
        if p["form"] == "direct":
            assert p["smem"] == coef and not p["regs"]
            continue
        rings += 1
        R = p["rows"]
        assert R == 8 * p["rw"] == 8 * p["rpw"] * p["npw"] and p["npw"] in (1, 2, 4, 8)
        assert p["feat_bytes"] == (R * F * itemsize if (s or dprobs) else 0)
        assert p["prob_bytes"] == R * C * 4 and p["id_bytes"] == (R * 4 if P > 1 else 0)
        for b in ("feat_bytes", "prob_bytes", "id_bytes", "stage_bytes"):
            assert p[b] % 16 == 0, (C, P, F, s, b, p[b])
        assert p["stage_bytes"] == p["feat_bytes"] + p["prob_bytes"] + p["id_bytes"]
        assert p["ring_at"] % 128 == 0 and p["bar_at"] % 16 == 0 and p["bar_at"] >= coef
        assert (p["bar_at"] + 16 * p["stages"] <= p["w_at"] < p["part_at"] < p["g_at"]
                < p["pt_at"] <= p["ring_at"])
        pt = R * p["cs"] * (-(-p["tpr"] // 4) * 4) * 4 if dprobs else 0
        assert p["pt_at"] + pt <= p["ring_at"]
        assert p["smem"] == p["ring_at"] + p["stages"] * p["stage_bytes"] <= K.SMEM_LIMIT
        assert p["stages"] == 2 and not p["bulk"]
        if p["regs"]:
            assert p["V"] == 8 and p["nch"] <= 32
            assert C <= K.GEN_REG_CLASSES_STD if s else (C <= K.GEN_REG_CLASSES and P == 1)
    assert rings > 400
    # the general cells' calls: within two blocks' budget, the chunk's
    # coefficients in registers
    for C, P, F, s, dp, regs in ((5, 4, 48, True, True, 1), (5, 1, 48, False, True, 1),
                                 (5, 1, 24, False, False, 1), (4, 2, 32, True, True, 1)):
        p = K.gen_bwd_plan(C, P, F, s, itemsize, dp)
        assert p["form"] == "ring" and p["regs"] == regs
        assert p["smem"] <= K.GEN_BWD_BUDGET


# ---------------------------------------------------------------------------
# the general centroid forward's plan (csrc/centroids_gen_plan.cuh)
# ---------------------------------------------------------------------------
FWD_PLAN_MAIN = r"""
#include <cstdio>
#include "centroids_gen_plan.cuh"
int main() {
  int C, P, F, s, es;
  while (std::scanf("%d %d %d %d %d", &C, &P, &F, &s, &es) == 5) {
    const slcl::GenFwdPlan p = slcl::gen_fwd_plan(C, P, F, s != 0, es);
    std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d\n",
                p.form, p.mt, p.ns, p.nt_s, p.nt, p.wm, p.wn, p.wk, p.mw, p.nw, p.kpw,
                p.rows, p.stages, p.feat_bytes, p.prob_bytes, p.id_bytes, p.stage_bytes,
                p.b_stride, p.b_bytes, p.red_bytes, p.bar_at, p.part_at, p.b_at, p.ring_at,
                p.smem);
  }
}
"""


def _fwd_limit_shapes():
    """(C, P, F, std) at the edge of the parent's forward limit (its
    grouped form's 4 * G * values): for each C, F and std the largest P
    that fits, and one more."""
    out = []
    for with_std in (False, True):
        for C in (1, 2, 4, 5, 8, 16):
            for F in (1, 3, 8, 20, 40, 100, 256, 656, 1024):
                groups = 1 if F >= 256 else 256 // F
                per_p = 4 * groups * (C * F + C)
                rest = 4 * groups * (1 + (C * F if with_std else 0))
                p_max = (K.SMEM_LIMIT - rest) // per_p
                out += [(C, p, F, with_std) for p in (p_max, p_max + 1) if p >= 1]
    return out


def _fwd_grid():
    return list(dict.fromkeys(_plan_grid() + _fwd_limit_shapes()))


@pytest.fixture(scope="module")
def cpp_fwd_plans(tmp_path_factory):
    """Every (C, P, F, std, itemsize) of _fwd_grid through the C++ forward
    plan, compiled here with g++ from the kernels' own header."""
    tmp = tmp_path_factory.mktemp("fwd_plan")
    (tmp / "fwd_plan_main.cpp").write_text(FWD_PLAN_MAIN)
    exe = tmp / "fwd_plan_main"
    subprocess.run(["g++", "-std=c++17", "-O1", "-Wall", "-Werror", "-I", str(CSRC),
                    str(tmp / "fwd_plan_main.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, text=True)
    calls = [(C, P, F, s, es) for C, P, F, s in _fwd_grid() for es in (2, 4)]
    text = "".join(f"{C} {P} {F} {int(s)} {es}\n" for C, P, F, s, es in calls)
    out = subprocess.run([str(exe)], input=text, check=True, capture_output=True,
                         text=True).stdout.split("\n")
    plans = {}
    for call, line in zip(calls, out):
        plan = dict(zip(K.GEN_FWD_KEYS, (int(v) for v in line.split())))
        plan["form"] = ("ring", "grouped", "narrow")[plan["form"]]
        plans[call] = plan
    assert len(plans) == len(calls)
    return plans


@pytest.mark.parametrize("f", PLAN_F + ("limit",))
def test_gen_fwd_plan_matches_the_cpp_plan(cpp_fwd_plans, f):
    """ops/cuda/__init__.py::gen_fwd_plan (which general_smem and the shape
    check read) is the kernel's own plan, field for field, in bf16 and f32;
    general_smem's "centroid_fwd" is the larger of the two plans' smem,
    the C++ expression's."""
    calls = [c for c in cpp_fwd_plans if (c[2] == f if f != "limit" else c[2] not in PLAN_F)]
    assert calls
    for C, P, F, s, es in calls:
        want = cpp_fwd_plans[(C, P, F, s, es)]
        assert K.gen_fwd_plan(C, P, F, s, es) == want, (C, P, F, s, es)
        assert K.general_smem(C, P, F, s)["centroid_fwd"] == max(
            cpp_fwd_plans[(C, P, F, s, 2)]["smem"], cpp_fwd_plans[(C, P, F, s, 4)]["smem"])


@pytest.mark.parametrize("with_std", [False, True])
def test_forward_admits_every_shape_the_parent_admitted(with_std):
    """Every (C, P, F, std) whose forward the parent admitted (its grouped
    form's 4 * G * (P*C*F + P*C + 1 + std*C*F) within the limit) is
    admitted, in bf16 and f32: the ring where it fits, else the grouped
    form, which needs what the parent did. F in {1, 7, 13, 20, 24, 48, 128,
    2048}, the shapes at the parent's limit, and DeepLabV2's F = 2048 at C
    = 4, P <= 2."""
    shapes = [(C, P, F) for C, P, F, s in _fwd_grid() if s == with_std]
    assert len(shapes) > 300
    kept = rings = 0
    for C, P, F in shapes:
        parent = _parent_smem(C, P, F, with_std)["centroid_fwd"]
        for es in (2, 4):
            plan = K.gen_fwd_plan(C, P, F, with_std, es)
            if plan["form"] == "grouped":
                assert plan["smem"] == parent
            else:
                assert plan["smem"] <= K.SMEM_LIMIT
                rings += 1
        new_ok = K.general_smem(C, P, F, with_std)["centroid_fwd"] <= K.SMEM_LIMIT
        if parent <= K.SMEM_LIMIT:
            assert new_ok, (C, P, F, with_std)
            kept += 1
    assert kept > 300 and rings > 300
    for P in (1, 2):
        K.check_shape(4, 2048, P, with_std, ("centroid_fwd", "centroid_final"))


@pytest.mark.parametrize("itemsize", [2, 4])
def test_forward_ring_stages_are_whole_bulk_copies(itemsize):
    """Each ring stage's bulk copies (features, probs, ids with P > 1)
    start and end on 16 bytes for a whole tile and sit at 16-byte offsets of
    a 128-byte-aligned ring; the weight tables lie between the barriers and
    the ring, their rows 16-byte aligned and an odd number of 16-byte units
    apart (ldmatrix reads no bank twice); the warps' split covers
    every (m-tile, n-tile) with at most GEN_FWD_MT x GEN_FWD_NT a warp (the
    narrow form, one n-tile, exactly where nt = 1); the block's totals fit
    where the tables were."""
    rings = 0
    for C, P, F, s in _fwd_grid():
        p = K.gen_fwd_plan(C, P, F, s, itemsize)
        if p["form"] == "grouped":
            continue
        rings += 1
        assert (p["form"] == "narrow") == (p["nt"] == 1)
        assert p["mt"] == F // 16 + 1 and 16 * p["mt"] > F
        assert p["ns"] % 8 == 0 and p["ns"] >= P * C + 1 and p["nt_s"] == p["ns"] // 8
        assert 8 * p["nt"] == p["ns"] + (-(-C // 8) * 8 if s else 0)
        assert p["wm"] * p["wn"] * p["wk"] == 8
        cap = K.GEN_FWD_MT_WIDE if itemsize == 2 and p["form"] == "ring" else K.GEN_FWD_MT
        assert p["mw"] * p["wm"] >= p["mt"] and p["mw"] <= cap
        assert p["nw"] * p["wn"] >= p["nt"] and p["nw"] <= K.GEN_FWD_NT
        R = p["rows"]
        assert R == 16 * p["wk"] * p["kpw"] and p["kpw"] in (1, 2, 4)
        assert R & (R - 1) == 0     # the row step takes r and q by mask and shift
        assert p["feat_bytes"] == R * F * itemsize and p["prob_bytes"] == R * C * 4
        assert p["id_bytes"] == (R * 4 if P > 1 else 0)
        for b in ("feat_bytes", "prob_bytes", "id_bytes", "stage_bytes"):
            assert p[b] % 16 == 0, (C, P, F, s, b, p[b])
        assert p["stage_bytes"] == p["feat_bytes"] + p["prob_bytes"] + p["id_bytes"]
        assert p["b_stride"] == R + 8 and (2 * p["b_stride"]) % 32 == 16
        assert p["b_bytes"] == 3 * p["nt"] * 8 * p["b_stride"] * 2
        assert p["bar_at"] == 0 and p["part_at"] == 16 * p["stages"]
        assert p["part_at"] % 16 == 0 and p["b_at"] >= p["part_at"] + 8 * R
        assert p["b_at"] % 128 == 0
        # a k-group's slice of a stage: RG = R / wk rows, whole 16-byte copies
        RG = R // p["wk"]
        assert RG % 16 == 0 and RG & (RG - 1) == 0
        assert p["ring_at"] % 128 == 0 and p["ring_at"] >= p["b_at"] + 2 * p["b_bytes"]
        assert p["red_bytes"] == 4 * p["mt"] * 16 * p["nt"] * 8
        assert p["smem"] == max(p["ring_at"] + p["stages"] * p["stage_bytes"],
                                p["b_at"] + p["red_bytes"]) <= K.SMEM_LIMIT
        assert p["stages"] in (2, 3)
    assert rings > 500
    # the general cells' calls and the forced ones: every warp on its own
    # k-steps of all the tile's sums (the bf16 std: of half its m-tiles), in
    # bf16 within two blocks' budget
    for C, P, F, s in ((5, 4, 48, True), (5, 1, 48, False), (5, 1, 24, False),
                       (4, 1, 32, False), (4, 2, 32, True)):
        p = K.gen_fwd_plan(C, P, F, s, itemsize)
        split = (2, 1, 4) if s and itemsize == 2 else (1, 1, 8)
        assert p["form"] == ("ring" if s else "narrow") and (p["wm"], p["wn"], p["wk"]) == split
        budget = K.GEN_FWD_BUDGET if s else K.GEN_FWD_NARROW_BUDGET
        assert p["smem"] <= (budget if itemsize == 2 else K.SMEM_LIMIT)


def _bf16_terms(v: torch.Tensor):
    """The kernel's split of f32 values into three bf16 terms
    (centroids_gen.cuh::bf16_terms): each the rest rounded to nearest."""
    t0 = v.to(torch.bfloat16)
    r1 = v - t0.float()
    t1 = r1.to(torch.bfloat16)
    t2 = (r1 - t1.float()).to(torch.bfloat16)
    return t0, t1, t2


def test_bf16_terms_rebuild_weights_and_squares_exactly():
    """Every product of the forward's tensor-core sums is exact: a weight
    w in [0, 1] (w = 0 or w >= 2^-110) is hi + mid + lo, three bf16
    terms, exactly; x^2 of a bf16 x (every bf16 with 2^-50 <= |x| <= 2^50,
    and 0) is hi + lo, two bf16 terms, as fma.rn.bf16x2 gives them (x^2
    rounded to bf16, then x^2 - hi rounded to bf16); and a bf16 term times
    a bf16 value is exact in f32."""
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.random(1 << 20, dtype=np.float32),
                        np.float32(2.0) ** -rng.integers(0, 111, 1 << 16).astype(np.float32)
                        * rng.uniform(1, 2, 1 << 16).astype(np.float32),
                        np.array([0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)),
                                  2.0 ** -110], np.float32)])
    w = torch.from_numpy(np.clip(w, 0, 1).astype(np.float32))
    t = _bf16_terms(w)
    assert torch.equal(t[0].double() + t[1].double() + t[2].double(), w.double())
    # f32 features take three terms too, at any sign
    x32 = torch.from_numpy(rng.normal(size=1 << 18).astype(np.float32) * 1e3)
    t = _bf16_terms(x32)
    assert torch.equal(t[0].double() + t[1].double() + t[2].double(), x32.double())
    # every bf16: its square in two terms
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    mag = x.float().abs()
    x = x[(mag == 0) | ((mag >= 2.0 ** -50) & (mag <= 2.0 ** 50))]
    sq = x.float() * x.float()            # exact: 16 significant bits
    hi = sq.to(torch.bfloat16)
    lo = (sq - hi.float()).to(torch.bfloat16)
    assert x.numel() > 25_000
    assert torch.equal(hi.double() + lo.double(), x.double() * x.double())
    # a term times a feature: 8 x 8 significant bits, exact in f32
    xs = x[torch.from_numpy(rng.integers(0, x.numel(), 1 << 16))]
    for term in _bf16_terms(w[:1 << 16]):
        assert torch.equal((term.float() * xs.float()).double(),
                           term.double() * xs.double())
