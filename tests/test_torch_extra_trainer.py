"""DDFSeg, AdaptEvery and BCL through the port's trainer and CLI on the CPU:
one epoch of each on the fixture trees (AdaptEvery on the MMWHS PNG tree
with its ``vertCT``/``vertMR`` point clouds; DDFSeg and BCL on MS-CMRSeg)
with validation, the final test and a checkpoint that the evaluation CLI
restores; BCL's pseudo-labels after a round against the JAX trainer's
``_bcl_update_plabels`` on the same weights and images (the round's logic
bit for bit on JAX's probabilities, the probabilities within a float32
tolerance, the maps equal away from threshold ties); and a
checkpoint of each method's extra networks (``d_seg``, ``d_ent``,
``d_point``) restored bit for bit, the next step after the restore equal to
the uninterrupted one (dropout masks included: they follow the seed and
the step).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.data import device_prefetch
from slcl_torch.scripts import evaluate as t_evaluate
from slcl_torch.train import __main__ as t_cli
from slcl_torch.train.trainer import Trainer as TTrainer
from slcl_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIX = ROOT / "tests" / "fixtures"
SMALL = ["model.layers=[1,1,1,1]", "model.base=8", "ddfseg.filters=4",
         "ddfseg.style_filters=4", "ddfseg.ngf=8", "ddfseg.slim=true"]

# method -> its data arguments (tree, domains)
RUNS = {
    "ddfseg": ["data.dataset=mscmrseg", f"data.data_dir={FIX / 'mini_mscmrseg'}"],
    "adaptevery": ["data.dataset=mmwhs", "data.raw=false",
                   f"data.data_dir={FIX / 'mini_mmwhs_png'}"],
    "bcl": ["data.dataset=mscmrseg", f"data.data_dir={FIX / 'mini_mscmrseg'}",
            "run.bcl_round_epochs=1"],
}
METRICS = {"ddfseg": ("seg_s", "seg_fake_st", "cyc_loss_s", "zero_loss_t", "loss_adv_t",
                      "loss_adv_s", "loss_adv_seg", "d_t_acc_real", "d_s_acc_fake"),
           "adaptevery": ("seg_s", "seg_s_aux", "loss_point", "loss_adv", "loss_adv_ent",
                          "loss_adv_point"),
           "bcl": ("seg_s", "seg_t_pseudo", "loss_ent", "metric_loss")}


@pytest.mark.parametrize("method", list(RUNS))
def test_cli_trains_one_epoch_and_evaluate_restores_it(tmp_path, method):
    args = [f"method={method}", *RUNS[method], *SMALL, "optim.epochs=1", "data.bs=2",
            "data.eval_bs=4", "data.crop=32", "model.dtype=float32", "data.num_workers=2",
            f"run.out_dir={tmp_path}", "--device", "cpu"]
    rec = t_cli.main(args)
    assert rec["device"] == "cpu"
    (epoch,) = rec["history"]
    assert epoch["epoch"] == 0 and 0.0 <= epoch["val_dice"] <= 1.0
    for k in METRICS[method]:
        assert np.isfinite(epoch[k]), k
    for split in ("test", "test_s"):
        vals = [v for k in ("dc", "hd", "asd") for v in rec[split][k]]
        assert len(vals) == 18 and all(np.isfinite(vals)), (split, rec[split])
    out = Path(rec["out_dir"])
    for name in ("ckpt_best.pt", "ckpt_last.pt", "log.jsonl", "summary.json"):
        assert (out / name).is_file(), name
    res = t_evaluate.main(args + ["run.restore_from=best"])
    assert res["dc"] == rec["test"]["dc"]


# ---------------------------------------------------------------------------
# BCL's pseudo-labels against the JAX trainer
# ---------------------------------------------------------------------------
class _Images:
    """Numpy images with labels and names (the dataset protocol)."""

    def __init__(self, n: int, seed: int, hw: int = 32):
        rng = np.random.default_rng(seed)
        self.items = [(rng.normal(size=(hw, hw, 3)).astype(np.float32),
                       rng.integers(0, 4, size=(hw, hw)).astype(np.int32), f"s{seed}_{i}")
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _bcl_cfg(cls, recipe):
    cfg = cls()
    cfg.method = "bcl"
    cfg = recipe(cfg)
    cfg.model.dtype = "float32"
    cfg.model.layers, cfg.model.base = (1, 1, 1, 1), 8
    cfg.data.bs, cfg.data.eval_bs, cfg.data.crop, cfg.data.num_workers = 2, 4, 32, 1
    return cfg


# the port's and JAX's float32 softmaxes on the same weights part by about
# one ulp (max 2.98e-8 here, at 0.2512; under 7 ulps there)
PROB_ATOL = 2e-7
# at most this many ties of the round's 6 x 32 x 32 pixels: pixels where a
# class threshold (a quantile of the confidences, so often a pixel's own
# value) lies between the two packages' confidences, or whose argmax
# differs between them
TIE_BOUND = 16


def _port_probs(port):
    """The port's round's softmax of every train_t image, as
    ``Trainer.bcl_update_plabels`` takes it: (N, H, W, C) and the names."""
    from slcl_torch.data import Loader
    from slcl_torch.parallel import mesh as dp
    from slcl_torch.train.steps import autocast
    cfg = port.cfg
    loader = Loader(port.datasets["train_t"], cfg.data.eval_bs, shuffle=False,
                    drop_last=False, num_threads=cfg.data.num_workers)
    probs, names = [], []
    with dp.use(None), port.evaluator.eval_mode():
        for img, _lab, batch_names in loader:
            with autocast(cfg.model.dtype, port.device):
                logits, _ = port.state.seg(port.evaluator.to_device(img), source=False)
            probs.append(torch.softmax(logits.float(), dim=-1).numpy())
            names.extend(batch_names)
    return np.concatenate(probs), names


def _jax_probs(jt):
    """The JAX trainer's round's softmax (``_bcl_update_plabels``' infer)."""
    from slcl_tpu.data.loader import Loader
    cfg = jt.cfg
    loader = Loader(jt.datasets["train_t"], cfg.data.eval_bs, shuffle=False,
                    drop_last=False, num_threads=cfg.data.num_workers)
    variables = {"params": jt.state.seg.params, "batch_stats": jt.state.seg.batch_stats}
    probs, names = [], []
    for img, _lab, batch_names in loader:
        pred, _ = jt.model.apply(variables, jnp.asarray(img), False, False)
        probs.append(np.asarray(jax.nn.softmax(pred.astype(jnp.float32), axis=-1)))
        names.extend(batch_names)
    return np.concatenate(probs), names


@pytest.mark.parametrize("prop", [0.2, 0.5])
def test_bcl_pseudo_labels_match_the_jax_trainer(prop):
    """The port's round on its own random weights, then the JAX trainer's
    ``_bcl_update_plabels`` on the same weights (its model in float32 as the
    port's) and images:
    - the port's round logic (its ``gene_thres`` and the threshold rule of
      ``Trainer.bcl_update_plabels``) on JAX's own probabilities gives JAX's
      thresholds and pseudo-label maps bit for bit;
    - the port's probabilities are JAX's within PROB_ATOL, its thresholds
      too;
    - the port's own maps equal JAX's at every pixel that is not a tie (a
      threshold of either package between the two packages' confidences,
      or an argmax that differs, which only a top-two gap within 2
      PROB_ATOL may do), and there are at most TIE_BOUND ties."""
    from slcl_tpu.config import Config, apply_recipe
    from slcl_tpu.ops.centroids import gene_thres as j_gene_thres
    from slcl_tpu.ops.centroids import thres_cb_plabel
    from slcl_tpu.train.trainer import Trainer

    from slcl_torch.ops.centroids import gene_thres as t_gene_thres

    data = {"train_s": _Images(4, 1), "train_t": _Images(6, 2), "valid_t": _Images(2, 3),
            "test_t": _Images(2, 4)}
    port = TTrainer(_bcl_cfg(TConfig, t_apply_recipe), datasets=data, device="cpu")
    # one step first, so the running statistics are not the initial ones
    batch = next(iter(device_prefetch(port._epoch_batches(), port.device)))
    port.step_fn(port.state, batch, port._sched(0))
    port.bcl_update_plabels(prop)

    jt = Trainer(_bcl_cfg(Config, apply_recipe), datasets=data)
    jt.model = jt.model.clone(dtype=jnp.float32)
    flax = state_dict_to_flax(port.state.seg)
    jt.state = jt.state.replace(seg=jt.state.seg.replace(
        params=jax.tree.map(jnp.asarray, flax["params"]),
        batch_stats=jax.tree.map(jnp.asarray, flax["batch_stats"])))
    jt._bcl_update_plabels(prop)
    assert set(port.bcl_plabels) == set(jt._bcl_plabels) == {n for *_, n in data["train_t"].items}
    nc = port.cfg.model.num_classes

    # the round logic, on JAX's probabilities: bit for bit
    pj, names = _jax_probs(jt)
    conf_j, pred_j = pj.max(-1), pj.argmax(-1)
    th_j = np.asarray(j_gene_thres(conf_j.ravel(), pred_j.ravel(), prop, nc))
    th = t_gene_thres(conf_j.ravel(), pred_j.ravel(), prop, nc)
    np.testing.assert_array_equal(th, th_j)
    logic = np.where(conf_j >= th[pred_j], pred_j, 255).astype(np.int32)
    for i, name in enumerate(names):
        want = np.asarray(thres_cb_plabel(jnp.asarray(pj[i]), th_j, nc)[0], np.int32)
        np.testing.assert_array_equal(want, jt._bcl_plabels[name], err_msg=name)
        np.testing.assert_array_equal(logic[i], want, err_msg=name)

    # the probabilities
    pt, names_t = _port_probs(port)
    assert names_t == names
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_ATOL)

    # the port's own round, away from ties
    conf_t, pred_t = pt.max(-1), pt.argmax(-1)
    th_t = t_gene_thres(conf_t.ravel(), pred_t.ravel(), prop, nc)
    np.testing.assert_allclose(th_t, th_j, rtol=0, atol=PROB_ATOL)
    flip = pred_t != pred_j
    top2 = np.sort(pj, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0])[flip].max(initial=0.0) <= 2 * PROB_ATOL
    lo, hi = np.minimum(conf_t, conf_j), np.maximum(conf_t, conf_j)
    th_lo = np.minimum(th_t[pred_j], th_j[pred_j])
    th_hi = np.maximum(th_t[pred_j], th_j[pred_j])
    apart = (conf_t != conf_j) | (th_t[pred_j] != th_j[pred_j])
    tie = flip | (apart & (np.maximum(lo, th_lo) <= np.minimum(hi, th_hi)))
    ties = int(tie.sum())
    print(f"prop {prop}: {ties} tie pixels of {tie.size}")
    assert ties <= TIE_BOUND, ties
    kept = 0
    for i, name in enumerate(names):
        got, want = port.bcl_plabels[name], jt._bcl_plabels[name]
        np.testing.assert_array_equal(got[~tie[i]], want[~tie[i]], err_msg=name)
        kept += int((want != 255).sum())
    assert 0 < kept < 6 * 32 * 32


def test_bcl_batches_carry_the_round_pseudo_labels():
    """Each target image's map from the round; one without takes 255."""
    data = {"train_s": _Images(4, 1), "train_t": _Images(4, 2), "valid_t": _Images(2, 3),
            "test_t": _Images(2, 4)}
    tr = TTrainer(_bcl_cfg(TConfig, t_apply_recipe), datasets=data, device="cpu")
    tr.bcl_update_plabels(0.5)
    del tr.bcl_plabels["s2_1"]
    for batch in tr._epoch_batches():
        for name, plab in zip(batch["names_t"], batch["plabel_t"]):
            want = tr.bcl_plabels.get(name, np.full((32, 32), 255, np.int32))
            np.testing.assert_array_equal(plab, want)


# ---------------------------------------------------------------------------
# checkpoints of the extra networks
# ---------------------------------------------------------------------------
def _small_cfg(method, out_dir):
    cfg = TConfig()
    cfg.method = method
    cfg = t_apply_recipe(cfg)
    cfg.data.dataset = "synthetic"
    cfg.model.dtype = "float32"
    cfg.model.layers, cfg.model.base = (1, 1, 1, 1), 8
    cfg.ddfseg.filters, cfg.ddfseg.style_filters, cfg.ddfseg.ngf, cfg.ddfseg.slim = 4, 4, 8, True
    cfg.data.bs, cfg.data.crop, cfg.data.num_workers = 2, 32, 1
    cfg.run.out_dir = str(out_dir)
    return cfg


@pytest.mark.parametrize("method,extra", [("ddfseg", ("d_seg",)),
                                          ("adaptevery", ("d_ent", "d_point"))])
def test_extra_networks_restore_bit_for_bit(tmp_path, method, extra):
    a = TTrainer(_small_cfg(method, tmp_path), device="cpu")
    batches = [b for _, b in zip(range(3), device_prefetch(a._epoch_batches(), a.device))]
    sched = a._sched(0)
    a.step_fn(a.state, batches[0], sched)
    a.save_checkpoint("mid")
    saved = torch.load(a.checkpoint_path("mid"), weights_only=True)
    assert all(saved[k] is not None for k in extra + tuple(f"opt_{k}" for k in extra))
    b = TTrainer(_small_cfg(method, tmp_path), device="cpu")
    b.restore_checkpoint("mid")
    assert b.state.step == a.state.step == 1
    for name in ("seg", "d_main", "d_aux") + extra:
        sa, sb = getattr(a.state, name).state_dict(), getattr(b.state, name).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
        oa = getattr(a.state, f"opt_{name}").state_dict()["state"]
        ob = getattr(b.state, f"opt_{name}").state_dict()["state"]
        assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i]), name
    for batch in batches[1:]:
        ma = a.step_fn(a.state, batch, sched)
        mb = b.step_fn(b.state, batch, sched)
        assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    for name in ("seg",) + extra:
        sa, sb = getattr(a.state, name).state_dict(), getattr(b.state, name).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name


def test_dropout_masks_follow_the_seed_and_the_step():
    """The default masks: a function of (seed, step, path, call) alone,
    different across steps, calls and seeds, with the keep rate."""
    from slcl_torch.train.steps_extra import Dropouts
    d = Dropouts()
    cpu = torch.device("cpu")
    m = [d.for_step(s, step)("encoders/_ResBlock_0/Dropout_0", call, (4, 64, 64), 0.75, cpu)
         for s, step, call in ((0, 0, 0), (0, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 0))]
    assert torch.equal(m[0], m[1])
    assert all(not torch.equal(m[0], x) for x in m[2:])
    assert abs(float(m[0].float().mean()) - 0.75) < 0.01
    # a Dropout in train mode needs a pass for its key; in eval mode it is
    # the identity
    from slcl_torch.models.common import Dropout
    x = torch.ones(2, 3)
    with pytest.raises(RuntimeError, match="outside a dropout_pass"):
        Dropout(0.5).train()(x)
    assert Dropout(0.5).eval()(x) is x


def _count_flax(init):
    shapes = jax.eval_shape(init)
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))


def test_full_width_parameter_counts_are_the_jax_models():
    """The trainer's full-width generators against the JAX models' counts
    (``jax.eval_shape``), which ``chip_smoke.py::N_PARAMS`` asserts on the
    card: DDFNet + SegDecoder (16/8/32), ResNetUNetPoint, BCLDeepLab; and
    the discriminators, PatchGAN with and without its aux head and the
    PointNet at base 64."""
    import chip_smoke
    from slcl_torch.models.ddfseg import DDFSeg
    from slcl_torch.models.deeplabv2 import BCLDeepLab as TBCL
    from slcl_torch.models.discriminators import PatchGAN as TPatch
    from slcl_torch.models.pointnet import PointNetCls as TPoint
    from slcl_torch.models.resnet_unet import ResNetUNetPoint as TRUP
    from slcl_tpu.models.ddfseg import DDFNet, SegDecoder
    from slcl_tpu.models.deeplabv2 import BCLDeepLab
    from slcl_tpu.models.discriminators import PatchGAN
    from slcl_tpu.models.pointnet import PointNetCls
    from slcl_tpu.models.resnet_unet import ResNetUNetPoint

    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    x = jnp.zeros((1, 64, 64, 3))
    want = {"ddfseg": _count_flax(lambda: DDFNet().init(keys, x, x, True))
            + _count_flax(lambda: SegDecoder(4).init(keys, jnp.zeros((1, 8, 8, 512)), True)),
            "adaptevery": _count_flax(lambda: ResNetUNetPoint(4).init(keys, x, True)),
            "bcl": _count_flax(lambda: BCLDeepLab(4).init(keys, x, True, True))}
    n = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    got = {"ddfseg": n(DDFSeg(4)), "adaptevery": n(TRUP(4)), "bcl": n(TBCL(4))}
    assert got == want == {k: chip_smoke.N_PARAMS[k] for k in want}
    img = jnp.zeros((1, 64, 64, 1))
    assert n(TPatch(1)) == _count_flax(lambda: PatchGAN().init(keys, img))
    assert n(TPatch(1, aux=True)) == _count_flax(lambda: PatchGAN(aux=True).init(keys, img))
    assert n(TPoint(k=1)) == _count_flax(
        lambda: PointNetCls(k=1).init(keys, jnp.zeros((1, 300, 3)), True))
