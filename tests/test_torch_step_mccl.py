"""MCCL ("SLCL proper") on the port: one and two ``mccl`` steps against the
JAX package's ``make_mccl_step`` from the same converted weights, batches,
``sched`` and rMC draw (JAX's own: ``jax.random.split(state.rng, 3)``, then
``randint`` of the second key, passed to the port through
``draw_assign``), on the CPU in f32; then the port's own machinery: the
draw as a function of the seed and the step (a restored checkpoint steps
as the uninterrupted run), the warm start from an AdvEnt checkpoint that
keeps the fresh projection head, the CLI, and RAIN's build and its refusal
of a missing component file.

Runs: the preset (phead, P = 2, soft weights, clda, CNR, intra) with two
domain-pure forwards; the one concatenated forward with stdmin and
seg_pseudo on (thd 0.3); and the preset at warm = 0. Compared after each
step: every metric, the segmentor parameters, the BatchNorm running
statistics and the source centres, at tests/test_torch_step.py's
tolerances: metrics rtol 1e-4 / atol 1e-5, parameters rtol 1e-4 / atol
1e-6, running stats and centres rtol 1e-4 / atol 1e-5.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.data import to_device
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.train.state import create_train_state as t_create_train_state
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.train.trainer import Trainer
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models import build_segmentor
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H = W = 32
BS = 2
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2)
RUNS = {"preset": {}, "concat_stdmin_pseudo": {"concat_forward": True, "stdmin": True,
                                               "w_stdmin": 0.1, "seg_pseudo": True,
                                               "thd": 0.3},
        "warm0": {}}


def _cfg(cls, recipe, contrastive=()):
    cfg = cls()
    cfg.method = "mccl"
    cfg = recipe(cfg)
    cfg.model.dtype = "float32"
    cfg.data.crop, cfg.data.bs = H, BS
    for k, v in SIZES.items():
        setattr(cfg.model, k, v)
    for k, v in dict(contrastive).items():
        setattr(cfg.contrastive, k, v)
    return cfg


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _assert_tree_close(got, want, rtol, atol, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")
    assert len(jax.tree.leaves(got)) == len(flat_w), what


def _two_steps(run):
    cfg = _cfg(Config, apply_recipe, RUNS[run])
    assert cfg.model.phead and not cfg.model.multilvl and cfg.contrastive.part == 2
    model = build_segmentor(cfg.model)
    zeros = jnp.zeros((cfg.model.num_classes, cfg.model.filters), jnp.float32)
    state, txs = create_train_state(cfg, model, sample_shape=(1, H, W, 3), centroids=zeros)
    step = build_step(cfg, model, txs)

    tcfg = _cfg(TConfig, t_apply_recipe, RUNS[run])
    seg = load_flax_weights(TDRUNet(phead=True, **SIZES).to(
        memory_format=torch.channels_last), _np(state.seg.params),
        _np(state.seg.batch_stats))
    tstate = t_create_train_state(tcfg, seg, centroids=torch.zeros(4, SIZES["filters"]))
    draw = {}

    def jax_draw(m, P, device):
        _, rng_part, _ = jax.random.split(draw["rng"], 3)
        ids = jax.random.randint(rng_part, (m,), 0, P)
        return torch.from_numpy(np.array(ids, np.int32)).to(device)

    tstep = t_build_step(tcfg, draw_assign=jax_draw)
    rng = np.random.default_rng(7)
    sched = {"lr": 8e-4, "lr_dis": 1e-4, "warm": 0.0 if run == "warm0" else 1.0}
    jsched = {k: jnp.asarray(v, jnp.float32) for k, v in sched.items()}
    out = []
    for _ in range(2):
        batch = {"img_s": rng.normal(size=(BS, H, W, 3)).astype(np.float32),
                 "lab_s": rng.integers(0, 4, size=(BS, H, W)).astype(np.int32),
                 "img_t": rng.normal(0.5, 1.5, size=(BS, H, W, 3)).astype(np.float32),
                 "img_t_aug": rng.normal(0.5, 1.5, size=(BS, H, W, 3)).astype(np.float32)}
        draw["rng"] = state.rng
        state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jsched)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, sched)
        out.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()},
                    _np({"seg": state.seg.params, "bs": state.seg.batch_stats,
                         "centroids": state.centroids}),
                    {"seg": state_dict_to_flax(tstate.seg),
                     "centroids": tstate.centroids.numpy()}))
    return out


@pytest.fixture(scope="module")
def runs():
    return {run: _two_steps(run) for run in RUNS}


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("run", list(RUNS))
def test_metrics_match(runs, run, i):
    want, got, _, _ = runs[run][i]
    assert set(got) == set(want)
    assert ("loss_pseudo" in got) == (run == "concat_stdmin_pseudo")
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("run", list(RUNS))
def test_parameters_running_stats_and_centres_match(runs, run, i):
    _, _, want, got = runs[run][i]
    _assert_tree_close(got["seg"]["params"], want["seg"], 1e-4, 1e-6, f"{run} step {i}")
    _assert_tree_close(got["seg"]["batch_stats"], want["bs"], 1e-4, 1e-5,
                       f"{run} step {i} batch_stats")
    np.testing.assert_allclose(got["centroids"], want["centroids"], rtol=1e-4, atol=1e-5)


# ---- the port's own machinery, at the same small size ----
SMALL = dict(dataset="synthetic", crop=32, bs=2, eval_bs=4, num_workers=1)


def _tcfg(method, out_dir, **contrastive):
    cfg = TConfig()
    cfg.method = method
    cfg = t_apply_recipe(cfg)
    for k, v in SMALL.items():
        setattr(cfg.data, k, v)
    for k, v in {**SIZES, "dtype": "float32"}.items():
        setattr(cfg.model, k, v)
    for k, v in contrastive.items():
        setattr(cfg.contrastive, k, v)
    cfg.run.out_dir = str(out_dir)
    return cfg


def test_restored_checkpoint_repeats_the_draws(tmp_path):
    """The rMC draw at step n depends on (seed, n) alone: save -> restore ->
    step equals step -> step (parameters, centres, metrics), in a trainer
    built with another seed, whose own draw would differ."""
    a = Trainer(_tcfg("mccl", tmp_path, stdmin=True, w_stdmin=0.1), device="cpu")
    batches = [to_device(b, torch.device("cpu"))
               for _, b in zip(range(3), a._epoch_batches())]
    sched = a._sched(0)
    a.step_fn(a.state, batches[0], sched)
    path = a.save_checkpoint("mid")
    other = _tcfg("mccl", tmp_path, stdmin=True, w_stdmin=0.1)
    other.run.seed = 3
    b = Trainer(other, device="cpu")
    assert b.state.seed == 3
    b.restore_checkpoint(str(path))
    assert b.state.seed == a.state.seed == 1234 and b.state.step == 1
    for batch in batches[1:]:
        ma = a.step_fn(a.state, batch, sched)
        mb = b.step_fn(b.state, batch, sched)
        assert ma.keys() == mb.keys()
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    sa, sb = a.state.seg.state_dict(), b.state.seg.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.state.centroids, b.state.centroids) and a.state.step == 3
    # another seed draws other partitions: the same state steps elsewhere
    c = Trainer(other, device="cpu")
    c.restore_checkpoint(str(path))
    c.state.seed = 3
    mc = c.step_fn(c.state, batches[1], sched)
    d = Trainer(other, device="cpu")
    d.restore_checkpoint(str(path))
    md = d.step_fn(d.state, batches[1], sched)
    assert torch.equal(mc["seg_s"], md["seg_s"])          # the draw does not touch it
    assert not torch.equal(mc["inter_c_loss"], md["inter_c_loss"])


def test_advent_checkpoint_warm_starts_mccl_with_a_fresh_phead(tmp_path):
    adv = Trainer(_tcfg("advent", tmp_path), device="cpu")
    adv.train_epoch(0)
    path = adv.save_checkpoint("best")
    t = Trainer(_tcfg("mccl", tmp_path), device="cpu")
    assert t.state.d_main is None and t.cfg.data.aug_counter
    fresh = {k: v.clone() for k, v in t.state.seg.state_dict().items()}
    t.restore_checkpoint(str(path), params_only=True)
    got, saved = t.state.seg.state_dict(), adv.state.seg.state_dict()
    phead = [k for k in got if k.startswith("phead")]
    assert len(phead) == 4 and not any(k in saved for k in phead)
    for k in got:
        assert torch.equal(got[k], fresh[k] if k in phead else saved[k]), k
    m = t.step_fn(t.state, to_device(next(iter(t._epoch_batches())), torch.device("cpu")),
                  t._sched(0))
    assert all(torch.isfinite(v) for v in m.values())


def test_mccl_with_rain_raises(tmp_path):
    """MCCL + RAIN is ported (tests/test_torch_step_mccl_rain*.py): with no
    component file it builds the frozen style net and a (1, 512) sampling;
    a configured component file that is missing raises."""
    cfg = _tcfg("mccl", tmp_path)
    cfg.rain.enabled = True
    t = Trainer(cfg, device="cpu")
    assert t.state.sampling.shape == (1, 512) and not any(
        p.requires_grad for p in t.state.rain.parameters())
    cfg.rain.decoder_ckpt = str(tmp_path / "absent.pth")
    with pytest.raises(FileNotFoundError, match="rain.decoder_ckpt"):
        Trainer(cfg, device="cpu")


def test_cli_trains_mccl_one_epoch_on_cpu(tmp_path):
    args = [sys.executable, "-m", "slcl_torch.train", "method=mccl",
            "data.dataset=synthetic", "optim.epochs=1", "data.bs=2", "data.crop=32",
            "model.filters=8", "model.n_block=2", "model.bottleneck_depth=2",
            "model.dtype=float32", "data.num_workers=1", f"run.out_dir={tmp_path}",
            "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and ".ph" in Path(rec["out_dir"]).name
    (epoch,) = rec["history"]
    assert epoch["epoch"] == 0 and 0.0 <= epoch["val_dice"] <= 1.0
    for k in ("seg_s", "ratio_t", "ratio_t_aug", "conf_t", "align_st", "spread_tt", "CNR",
              "inter_c_loss", "intra_c_loss"):
        assert k in epoch and np.isfinite(epoch[k]), k
    assert len(rec["test"]["dc"]) == 6 and len(rec["test"]["hd"]) == 6
    for name in ("ckpt_best.pt", "ckpt_last.pt", "log.jsonl", "summary.json"):
        assert (Path(rec["out_dir"]) / name).is_file(), name
