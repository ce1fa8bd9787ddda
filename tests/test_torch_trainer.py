"""The port's protocol machinery on the CPU at a small size: checkpoints
(full restore continues bit for bit; a params-only warm start across
methods), class-centre files, ``train()`` with its log and summary, the
``evaluate`` entry point, and ``gen_class_centers`` against the JAX script's arithmetic on the same
converted weights (rtol 1e-4 / atol 1e-5: the same f32 forward summed in
another order by XLA and by PyTorch).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.data import Loader
from slcl_torch.scripts import evaluate, gen_class_centers
from slcl_torch.train.trainer import Trainer
from slcl_torch.utils.convert import state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models import build_segmentor

torch.set_num_threads(1)

SMALL = dict(dataset="synthetic", crop=32, bs=2, eval_bs=4, num_workers=1)
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2, multilvl=True, dtype="float32")
JAX_SUMMARY_KEYS = {"best_epoch", "best_val_dice", "test", "test_s", "test_t_other_fold",
                    "history"}


def _cfg(method, out_dir, cls=TConfig, recipe=t_apply_recipe, **model):
    cfg = cls()
    cfg.method = method
    cfg = recipe(cfg)
    for k, v in SMALL.items():
        setattr(cfg.data, k, v)
    for k, v in {**SIZES, **model}.items():
        setattr(cfg.model, k, v)
    cfg.run.out_dir = str(out_dir)
    return cfg


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return {"img_s": torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32)),
            "lab_s": torch.from_numpy(rng.integers(0, 4, size=(2, 32, 32)).astype(np.int32)),
            "img_t": torch.from_numpy(
                rng.normal(0.5, 2.0, size=(2, 32, 32, 3)).astype(np.float32))}


def _assert_same_state_dict(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_same_optimizer(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][k])), (i, k)


def test_full_restore_continues_bit_for_bit(tmp_path):
    a = Trainer(_cfg("slcl", tmp_path), device="cpu")
    a.train_epoch(0)
    path = a.save_checkpoint("mid")
    other = _cfg("slcl", tmp_path)
    other.run.seed = 3          # another init, so nothing matches by chance
    b = Trainer(other, device="cpu")
    b.restore_checkpoint(str(path))
    sched = a._sched(1)
    ma = a.step_fn(a.state, _batch(), sched)
    mb = b.step_fn(b.state, _batch(), sched)
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for net in ("seg", "d_main", "d_aux"):
        _assert_same_state_dict(getattr(a.state, net).state_dict(),
                                getattr(b.state, net).state_dict())
    for opt in ("opt_seg", "opt_d_main", "opt_d_aux"):
        _assert_same_optimizer(getattr(a.state, opt), getattr(b.state, opt))
    assert torch.equal(a.state.centroids, b.state.centroids)
    assert a.state.step == b.state.step == 9
    # the file is plain tensors and dicts
    assert torch.load(path, weights_only=True)["step"] == 8


def test_advent_checkpoint_warm_starts_slcl_and_baseline(tmp_path):
    adv = Trainer(_cfg("advent", tmp_path), device="cpu")
    adv.train_epoch(0)
    path = adv.save_checkpoint("best")
    for method in ("slcl", "baseline"):
        cfg = _cfg(method, tmp_path)
        cfg.run.seed = 3
        t = Trainer(cfg, device="cpu")
        t.restore_checkpoint(str(path), params_only=True)
        _assert_same_state_dict(t.state.seg.state_dict(), adv.state.seg.state_dict())
        if method == "slcl":
            for net in ("d_main", "d_aux"):
                _assert_same_state_dict(getattr(t.state, net).state_dict(),
                                        getattr(adv.state, net).state_dict())
        else:
            assert t.state.d_main is None and t.state.d_aux is None
        assert not t.state.opt_seg.state_dict()["state"]   # optimizers stay fresh
        assert t.state.step == 0
    wide = Trainer(_cfg("slcl", tmp_path, filters=16), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        wide.restore_checkpoint(str(path), params_only=True)


def test_missing_centre_file_raises(tmp_path):
    cfg = _cfg("slcl", tmp_path)
    cfg.contrastive.init_centers = str(tmp_path / "absent.npy")
    with pytest.raises(FileNotFoundError, match="init_centers"):
        Trainer(cfg, device="cpu")
    np.save(tmp_path / "wrong.npy", np.zeros((4, 16), np.float32))
    cfg.contrastive.init_centers = str(tmp_path / "wrong.npy")
    with pytest.raises(ValueError, match="shape"):
        Trainer(cfg, device="cpu")


def test_loaded_centre_file_disables_the_bootstrap(tmp_path):
    """A zero centre file is an EMA start: one step gives (1 - m) times the
    batch means, which the bootstrap of a run without a file adopts whole."""
    np.save(tmp_path / "zeros.npy", np.zeros((4, 8), np.float32))
    loaded_cfg = _cfg("slcl", tmp_path)
    loaded_cfg.contrastive.init_centers = str(tmp_path / "zeros.npy")
    loaded = Trainer(loaded_cfg, device="cpu")
    boot = Trainer(_cfg("slcl", tmp_path), device="cpu")
    assert loaded.centroids_loaded and not boot.centroids_loaded
    sched = boot._sched(0)
    for t in (loaded, boot):
        t.step_fn(t.state, _batch(), sched)
    m = loaded_cfg.contrastive.class_center_m
    assert boot.state.centroids.abs().sum() > 0
    np.testing.assert_allclose(loaded.state.centroids.numpy(),
                               (1.0 - m) * boot.state.centroids.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_protocol_advent_centres_slcl_writes_log_and_summary(tmp_path):
    """The protocol in miniature: AdvEnt, a centre file from its best
    checkpoint, then ``slcl`` warm-started from both for two epochs."""
    acfg = _cfg("advent", tmp_path)
    acfg.optim.epochs, acfg.run.eval_frequency = 1, 1
    adv = Trainer(acfg, device="cpu")
    asum = adv.train()
    best = adv.out_dir / "ckpt_best.pt"
    npy = tmp_path / "centers.npy"
    centres = gen_class_centers.main(
        ["method=advent", *(f"data.{k}={v}" for k, v in SMALL.items()),
         *(f"model.{k}={v}" for k, v in SIZES.items()),
         f"run.restore_from={best}", f"out={npy}", "--device", "cpu"])
    assert centres.shape == (4, 8) and np.isfinite(centres).all() and centres.any()
    np.testing.assert_array_equal(np.load(npy), centres)

    scfg = _cfg("slcl", tmp_path)
    scfg.optim.epochs, scfg.run.eval_frequency = 2, 1
    scfg.optim.lr, scfg.optim.lr_warmup_epochs = 2e-4, 5
    scfg.run.init_from, scfg.contrastive.init_centers = str(best), str(npy)
    slcl = Trainer(scfg, device="cpu")
    summary = slcl.train()
    assert set(summary) == JAX_SUMMARY_KEYS
    log = [json.loads(line) for line in (slcl.out_dir / "log.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in log] == [-1, 0, 1]
    # same weights, same valid set: the warm start's eval is AdvEnt's best
    assert log[-1]["epoch_time_s"] >= 0 and "loss_mpscl_tg" in log[1]
    assert log[0]["val_dice"] == pytest.approx(asum["best_val_dice"], abs=1e-6)
    assert json.loads((slcl.out_dir / "summary.json").read_text())["history"] == log
    for split in ("test", "test_s"):
        for k in ("dc", "hd", "asd"):
            assert len(summary[split][k]) == 6 and np.isfinite(summary[split][k]).all()
    for name in ("ckpt_best.pt", "ckpt_last.pt", "best_fingerprint.txt"):
        assert (slcl.out_dir / name).is_file(), name


def test_evaluate_cli_tests_a_checkpoint_and_raises_without_one(tmp_path):
    t = Trainer(_cfg("advent", tmp_path), device="cpu")
    t.train_epoch(0)
    t.save_checkpoint("best")
    args = ["method=advent", *(f"data.{k}={v}" for k, v in SMALL.items()),
            *(f"model.{k}={v}" for k, v in SIZES.items()), f"run.out_dir={tmp_path}",
            "--device", "cpu"]
    got = evaluate.main([*args, "run.restore_from=best"])
    assert got == t.eval("test_t")
    with pytest.raises(SystemExit, match="restore failed"):
        evaluate.main([*args, "run.restore_from=absent"])


def test_gen_class_centers_matches_jax_arithmetic(tmp_path):
    t = Trainer(_cfg("baseline", tmp_path), device="cpu")
    t.train_epoch(0)   # BatchNorm buffers away from their init
    got = gen_class_centers.class_centers(t)

    jcfg = _cfg("baseline", tmp_path, Config, apply_recipe)
    model = build_segmentor(jcfg.model)
    flax = state_dict_to_flax(t.state.seg)
    variables = {"params": flax["params"], "batch_stats": flax["batch_stats"]}
    feats_fn = jax.jit(lambda v, x: model.apply(v, x, False).dcdr_ft)
    sums = jnp.zeros((4, 8), jnp.float32)
    counts = jnp.zeros((4, 1), jnp.float32)
    for img, mask, _ in Loader(t.datasets["train_s"], 4, shuffle=False, drop_last=False,
                               num_threads=1):
        ft = feats_fn(variables, jnp.asarray(img))
        onehot = jax.nn.one_hot(jnp.asarray(mask).reshape(-1), 4, dtype=jnp.float32)
        sums = sums + onehot.T @ ft.astype(jnp.float32).reshape(-1, ft.shape[-1])
        counts = counts + jnp.sum(onehot, axis=0)[:, None]
    want = np.asarray(sums / jnp.maximum(counts, 1.0), np.float32)
    assert got.dtype == np.float32 and got.shape == (4, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
