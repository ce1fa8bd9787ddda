"""``run.scan_steps`` on the port (``slcl_torch/train/multistep.py``) on the
CPU, where the multi-step runner calls the step in place of a CUDA graph's
replay, with the static batch slots, in-place state, device-scalar
schedule and staged draws of the captured runner:

(a) the Trainer's epoch (the synthetic 8-step epoch) at ``scan_steps`` 2
    and 3 (3 + 3 + a 2-step tail through the plain step) equals its
    ``scan_steps=1`` epoch bit for bit: every network's parameters and
    buffers, every optimizer's state, the centres, RAIN's sampling, the
    step and every epoch metric; for ``slcl`` multilvl + CNR, ``mccl``
    (P = 2, stdmin), ``mccl`` + RAIN before warm-up (noise and rMC draws)
    and ``ddfseg`` (dropout masks);
(b) one ``mpscl`` epoch at ``scan_steps=3`` against the JAX Trainer's at
    ``scan_steps=3`` (``lax.scan`` over the groups, the tail through the
    plain step), from the same converted weights and the same batches, at
    ``tests/test_torch_step.py``'s tolerances: metrics rtol 1e-4 / atol
    1e-5, segmentor parameters rtol 1e-4 / atol 1e-6, the discriminator,
    running statistics and centres rtol 1e-4 / atol 1e-5; in float64 on
    both sides (``jax_scan``);
(c) every tensor the runner's step reads or writes (parameters, buffers,
    optimizer state, centres, sampling, the batch slots, the staged draws)
    keeps its address from step to step: what a graph replay needs;
(d) a staged rMC, noise and dropout draw equals the eager step's draw for
    the same (seed, step), in a buffer that keeps its address.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.data import to_device
from slcl_torch.train.multistep import StagedDraws
from slcl_torch.train.state import TrainState, optimizers
from slcl_torch.train.steps import Generators, rmc_draw
from slcl_torch.train.steps_extra import Dropouts, dropout_draw
from slcl_torch.train.steps_rain import RainNoise, noise_draw
from slcl_torch.train.trainer import _NETS, Trainer
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config
from torch_rain_common import Preset

torch.set_num_threads(1)

SMALL = dict(dataset="synthetic", crop=32, bs=2, eval_bs=4, num_workers=1)
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2, dtype="float32")
CPU = torch.device("cpu")
# (method, overrides by section): the cases of (a)
CASES = {
    "slcl": ("slcl", {"model": dict(multilvl=True), "contrastive": dict(CNR=True)}),
    "mccl": ("mccl", {"contrastive": dict(stdmin=True, w_stdmin=0.1)}),
    "mccl_rain": ("mccl", {"rain": dict(enabled=True, update_eps=True, eps_iters=2),
                           "contrastive": dict(warmup_epochs=1)}),
    "ddfseg": ("ddfseg", {"ddfseg": dict(filters=4, style_filters=4, ngf=8, slim=True)}),
}


def _cfg(name: str, k: int, out_dir) -> TConfig:
    method, over = CASES[name]
    cfg = TConfig()
    cfg.method = method
    cfg = t_apply_recipe(cfg)
    for key, v in SMALL.items():
        setattr(cfg.data, key, v)
    for key, v in SIZES.items():
        setattr(cfg.model, key, v)
    for section, kv in over.items():
        for key, v in kv.items():
            setattr(getattr(cfg, section), key, v)
    cfg.run.scan_steps = k
    cfg.run.out_dir = str(out_dir)
    return cfg


def _state(t: Trainer) -> dict:
    s, out = t.state, {"step": torch.tensor(t.state.step)}
    for n in _NETS:
        if getattr(s, n) is not None:
            out.update({f"{n}/{k}": v for k, v in getattr(s, n).state_dict().items()})
    for n, opt in optimizers(s).items():
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{n}/{i}/{k}": torch.as_tensor(v) for k, v in st.items()})
    for n in ("centroids", "sampling"):
        if getattr(s, n) is not None:
            out[n] = getattr(s, n)
    return out


@pytest.fixture(scope="module")
def one_step(tmp_path_factory):
    """Each case's ``scan_steps=1`` epoch: (metrics, state)."""
    out = {}
    for name in CASES:
        t = Trainer(_cfg(name, 1, tmp_path_factory.mktemp(name)), device="cpu")
        out[name] = (t.train_epoch(0), _state(t))
    return out


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_scan_epoch_equals_one_step_epoch(one_step, tmp_path, name, k):
    t = Trainer(_cfg(name, k, tmp_path), device="cpu")
    metrics = t.train_epoch(0)
    # 8 steps: the whole groups through the runner, the tail plain
    assert t.multi is not None and t.multi.eager_steps == 8 // k * k
    want_m, want_s = one_step[name]
    assert metrics == want_m                  # every metric, exactly
    got_s = _state(t)
    assert got_s.keys() == want_s.keys()
    bad = [key for key in want_s if not torch.equal(got_s[key], want_s[key])]
    assert not bad, bad[:5]


# ---------------------------------------------------------------------------
# (b) against the JAX Trainer's scan
# ---------------------------------------------------------------------------
def _assert_tree_close(got, want, rtol, atol, what):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")
    assert len(jax.tree.leaves(got)) == len(flat), what


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def jax_scan(tmp_path_factory):
    """One ``mpscl`` epoch at ``scan_steps=3`` by the JAX Trainer and by the
    port's, from the port's initial weights, both in float64 (the port's
    networks, centres and batches under torch's float64 default, as the dry
    run does; JAX's DRUNet and discriminator at ``dtype=float64`` under
    ``jax.enable_x64``, its state made from the converted weights in place
    of flax's init; the
    centres float32 on both sides, as both steps compute them): in f32,
    eight steps turn rounding into Adam's sign-like steps on the
    discriminator's near-zero gradients (9.4e-4 in its ``conv1`` against
    the 1e-5 tolerance). Both Trainers' batches are checked equal first."""
    import slcl_tpu.train.trainer as jtrainer
    from slcl_tpu.models import DRUNet, UncertaintyDiscriminator
    from slcl_tpu.train.state import create_train_state
    from slcl_tpu.train.steps import build_step
    out_dir = tmp_path_factory.mktemp("jax_scan")
    cfg = Config()
    cfg.method = "mpscl"
    for key, v in SMALL.items():
        setattr(cfg.data, key, v)
    for key, v in SIZES.items():
        setattr(cfg.model, key, v)
    cfg.optim.epochs = 1
    cfg.run.scan_steps = 3
    cfg.run.out_dir = str(out_dir)
    tcfg = TConfig()
    tcfg.method = "mpscl"
    for section in ("data", "model", "optim", "run", "contrastive", "adv"):
        for key, v in vars(getattr(cfg, section)).items():
            setattr(getattr(tcfg, section), key, v)
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        tt = Trainer(tcfg, device="cpu")
        def converted_state(cfg_, model, disc=None, disc_aux=None, **kw):
            # the port's weights, in place of flax's init (~27 s on a CPU)
            assert disc is not None and disc_aux is None
            return create_train_state(cfg_, Preset(_f64(state_dict_to_flax(tt.state.seg))),
                                      disc=Preset(_f64(state_dict_to_flax(tt.state.d_main))),
                                      **kw)

        with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtrainer, "create_train_state", converted_state)
            jt = jtrainer.Trainer(cfg)
            assert jt.mesh is None
            jb, tb = list(jt._epoch_batches()), list(tt._epoch_batches())
            assert len(jb) == len(tb) == 8
            for a, b in zip(jb, tb):
                for key, v in a.items():
                    if isinstance(v, np.ndarray):
                        np.testing.assert_array_equal(v, b[key])
            m = cfg.model
            f64 = jnp.float64
            model = DRUNet(filters=m.filters, n_block=m.n_block,
                           bottleneck_depth=m.bottleneck_depth, n_class=m.num_classes,
                           multilvl=m.multilvl, phead=m.phead, dtype=f64)
            # its step at float64 (the Trainer's model is float32)
            jt.step_fn = build_step(cfg, model, jt.txs, UncertaintyDiscriminator(dtype=f64),
                                    None)
            want_m = jt.train_epoch(0)
            want = jax.tree.map(np.asarray, {"seg": jt.state.seg.params,
                                             "bs": jt.state.seg.batch_stats,
                                             "d": jt.state.d_main.params,
                                             "centroids": jt.state.centroids})
        got_m = tt.train_epoch(0)
    finally:
        torch.set_default_dtype(before)
    seg = state_dict_to_flax(tt.state.seg)
    got = {"seg": seg["params"], "bs": seg["batch_stats"],
           "d": state_dict_to_flax(tt.state.d_main)["params"],
           "centroids": tt.state.centroids.numpy().copy()}
    return want_m, got_m, want, got, tt


def test_jax_scan_metrics_match(jax_scan):
    want, got, _, _, tt = jax_scan
    assert tt.multi is not None and tt.multi.eager_steps == 6
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("part,atol", [("seg", 1e-6), ("bs", 1e-5), ("d", 1e-5),
                                       ("centroids", 1e-5)])
def test_jax_scan_state_matches(jax_scan, part, atol):
    _, _, want, got, _ = jax_scan
    if part == "centroids":
        np.testing.assert_allclose(got[part], want[part], rtol=1e-4, atol=atol)
    else:
        _assert_tree_close(got[part], want[part], 1e-4, atol, part)


# ---------------------------------------------------------------------------
# (c) addresses, (d) staged draws
# ---------------------------------------------------------------------------
def _addresses(t: Trainer) -> dict:
    m = t.multi
    out = {k: v.data_ptr() for k, v in _state(t).items() if k != "step"}
    out.update({f"input/{k}": v.data_ptr() for k, v in m.inputs.items()})
    out.update({f"flag/{k}": v.data_ptr() for k, v in m.flags.items()})
    out.update({f"draw/{i}": buf.data_ptr() for i, (_, _, buf) in enumerate(m.draws.slots)})
    return out


@pytest.mark.parametrize("name", ["slcl", "mccl_rain", "ddfseg"])
def test_runner_keeps_every_address(tmp_path, name):
    cfg = _cfg(name, 2, tmp_path)
    if name == "mccl_rain":
        cfg.contrastive.warmup_epochs = 0       # the ascent on: it writes the sampling
        cfg.rain.eps_iters = 1
    t = Trainer(cfg, device="cpu")
    sched = t._sched(0)
    batches = [to_device(b, CPU) for _, b in zip(range(4), t._epoch_batches())]
    acc = {}
    t.multi = t.build_multi_step()
    t.multi(t.state, batches[:1], sched, acc)     # the first step makes the state
    first = _addresses(t)
    before = {k: v.clone() for k, v in _state(t).items()}
    assert any(k.startswith("draw/") for k in first) == (name != "slcl")
    for b in batches[1:]:
        t.multi(t.state, [b], sched, acc)
        assert _addresses(t) == first
    after = _state(t)
    # ... and the step did write them
    for key in ("seg/" + next(iter(t.state.seg.state_dict())), "centroids", "sampling"):
        if key in before:
            assert not torch.equal(before[key], after[key]), key


def test_staged_draws_equal_the_eager_draws():
    seed, dev = 11, CPU
    staged = StagedDraws()
    hooks = staged.hooks()
    staged.prepare(seed, 2)
    ids = hooks["draw_assign"](1000, 2, dev)
    z = hooks["draw_noise"]((1, 512), dev)
    mask = hooks["draw_dropout"](2, "enc/Dropout_0", 1, (2, 8, 8, 4), 0.7, dev)
    gens = Generators()
    assert torch.equal(ids, rmc_draw(gens, seed, 2, 1000, 2, dev))
    ids_2 = ids.clone()
    ptrs = [t.data_ptr() for t in (ids, z, mask)]
    staged.prepare(seed, 7)
    again = (hooks["draw_assign"](1000, 2, dev), hooks["draw_noise"]((1, 512), dev),
             hooks["draw_dropout"](7, "enc/Dropout_0", 1, (2, 8, 8, 4), 0.7, dev))
    assert [t.data_ptr() for t in again] == ptrs
    # the eager step's own draws at step 7: the module functions and the
    # step-side defaults (RainNoise, Dropouts) without a hook
    state = TrainState(seg=torch.nn.Identity(), opt_seg=None, seed=seed, step=7)
    want = (rmc_draw(gens, seed, 7, 1000, 2, dev),
            RainNoise()(state, (1, 512), dev),
            Dropouts().for_step(seed, 7)("enc/Dropout_0", 1, (2, 8, 8, 4), 0.7, dev))
    assert torch.equal(want[1], noise_draw(gens, seed, 7, (1, 512), dev))
    assert torch.equal(want[2], dropout_draw(gens, seed, 7, "enc/Dropout_0", 1,
                                             (2, 8, 8, 4), 0.7, dev))
    for got, w in zip(again, want):
        assert torch.equal(got, w)
    assert not torch.equal(again[0], ids_2)     # another step, another draw
    with pytest.raises(RuntimeError, match="staged as"):
        staged.prepare(seed, 8)
        hooks["draw_noise"]((1, 512), dev)      # out of the recorded order
