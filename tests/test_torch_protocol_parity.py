"""The SLCL protocol through both Trainers from the same weights (ROADMAP
queue 3 item 1: is the port's protocol quality below JAX's by its own
arithmetic?).

The README's protocol at reduced width (DRUNet filters 8, two blocks,
bottleneck 2; synthetic 32x32, ``data.gap=0.5``, Adam, a validation each
epoch), E epochs a stage:

1. ``advent`` (multilvl, lr 2e-3, ``adv.w_dis`` 2e-4);
2. the centre files from AdvEnt's best checkpoint: ``gen_class_centers``
   with ``method=baseline`` (multilvl) for ``slcl`` and ``method=mccl`` for
   ``mccl`` (its projection head keeps its fresh init), each package's own
   script on its own checkpoint;
3. ``slcl`` (multilvl + CNR, lr 2e-4 with 5 warm-up epochs) and ``mccl``
   (the preset: P = 2, soft weights, CNR; lr 2e-4), each warm-started
   (``run.init_from``) from AdvEnt's best checkpoint with its centre file.

Each stage runs ``Trainer.train()`` of the JAX package, then the port's,
in float64 on both sides (the losses keep their float32): JAX's DRUNet and
discriminators at ``dtype=float64`` under ``jax.enable_x64`` (the JAX
Trainer's ``build_segmentor`` and ``UncertaintyDiscriminator`` swapped in
this test), its initial state made from the port's initial weights through
a monkeypatched ``create_train_state`` (as ``test_torch_scan_steps.py::
jax_scan`` does); the port under torch's float64 default. Each of the
port's batches is checked equal to JAX's before the port's step takes it,
and the port's MCCL steps take JAX's rMC draw of the same step (recorded
from JAX's ``state.rng``).

Each stage starts both packages from the same weights, exactly: AdvEnt
from the port's initial networks, each fine-tune from the port's
warm-started networks and the port's centre file. The weights are rounded
to float32 values first, which the converter to flax keeps exactly. JAX's
own warm start and centre file are compared with the port's before that.
So no stage carries an earlier stage's rounding, which a kink can turn
into a departure: handed the initial weights 1e-8 apart (the converter's
float32 rounding of float64 ones), MCCL's first step from AdvEnt's
checkpoint has a ``decoder2_2b`` pre-activation on either side of its
LeakyReLU's kink in the two packages, where the loss's left and right
derivatives differ, and the runs part (``tools/protocol_parity.py``
measures this; run from their own starts and exactly equal initial
weights they agree).

Compared: every metric of every step (rel 1e-4, abs 1e-5: ``jax_scan``'s),
each epoch's val Dice (the same) and the best epoch (equal), the centre
files (rtol 1e-5), the warm-started networks (rtol 1e-4, atol 1e-5, the
discriminators' and running statistics' tolerance of ``jax_scan``) and the
final test's Dice (rel 1e-4, abs 1e-5). A failure names the first step
and quantity that departs.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_rain_common import Preset, jax_randint

import slcl_torch.scripts.gen_class_centers as t_centres
from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.train.trainer import Trainer
from slcl_torch.utils.convert import state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe

torch.set_num_threads(1)

E = 2
REPO = Path(__file__).resolve().parent.parent
COMMON = {"data": dict(dataset="synthetic", crop=32, bs=2, eval_bs=4, num_workers=1,
                       gap=0.5),
          "model": dict(filters=8, n_block=2, bottleneck_depth=2, dtype="float32"),
          "optim": dict(optimizer="adam", epochs=E),
          "run": dict(eval_frequency=1)}
STAGES = {
    "advent": ("advent", {"model": dict(multilvl=True), "optim": dict(lr=2e-3),
                          "adv": dict(w_dis=2e-4)}),
    "slcl": ("slcl", {"model": dict(multilvl=True),
                      "optim": dict(lr=2e-4, lr_warmup_epochs=5), "adv": dict(w_dis=2e-4)}),
    "mccl": ("mccl", {"optim": dict(lr=2e-4)}),
    # the centre files' Trainers (gen_class_centers)
    "centres_slcl": ("baseline", {"model": dict(multilvl=True)}),
    "centres_mccl": ("mccl", {}),
}
REL, ABS = 1e-4, 1e-5


def _overrides(stage: str) -> dict:
    method, over = STAGES[stage]
    out = {sec: dict(kv) for sec, kv in COMMON.items()}
    for sec, kv in over.items():
        out.setdefault(sec, {}).update(kv)
    return method, out


def _configs(stage: str, out_dir: Path, **run):
    """(JAX Config, port Config) of ``stage``: the recipe, then the
    overrides, as both CLIs apply them."""
    method, over = _overrides(stage)
    over["run"] = {**over["run"], **run}
    cfgs = []
    for cls, recipe, sub in ((Config, apply_recipe, "jax"), (TConfig, t_apply_recipe, "port")):
        cfg = cls()
        cfg.method = method
        cfg = recipe(cfg)
        for sec, kv in over.items():
            for k, v in kv.items():
                setattr(getattr(cfg, sec), k, v)
        cfg.run.out_dir = str(out_dir / sub)
        cfgs.append(cfg)
    for sec in ("data", "model", "optim", "adv", "contrastive"):
        want = vars(getattr(cfgs[0], sec))
        got = vars(getattr(cfgs[1], sec))
        assert {k: got[k] for k in want if k in got} == {k: want[k] for k in got if k in want}, sec
    return cfgs


def _cli(stage: str, **extra) -> list:
    """``section.key=value`` arguments of ``stage`` for the two
    ``gen_class_centers`` scripts."""
    method, over = _overrides(stage)
    args = [f"method={method}"]
    for sec, kv in over.items():
        for k, v in kv.items():
            args.append(f"{sec}.{k}={str(v).lower() if isinstance(v, bool) else v}")
    return args + [f"{k}={v}" for k, v in extra.items()]


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_centres_script():
    """``scripts/gen_class_centers.py`` as a module, its ``configure_jax``
    (the CLI's platform and compilation-cache set-up) left out: the test
    process has configured JAX already (tests/conftest.py)."""
    import slcl_tpu.utils.jaxenv as jaxenv
    spec = importlib.util.spec_from_file_location("_jax_gen_class_centers",
                                                  REPO / "scripts" / "gen_class_centers.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaxenv, "configure_jax", lambda: None)
        spec.loader.exec_module(mod)
    return mod


class _Run:
    """One stage's record on one side: the metrics of each step, its
    batches (and MCCL's draws), the summary and the warm-started networks
    (the port's also as a state dict)."""

    def __init__(self):
        self.steps, self.batches, self.draws = [], [], []
        self.summary = None
        self.warm = self.warm_state = None


def _round_f32(*modules) -> None:
    """Every parameter and buffer of ``modules`` rounded to a float32 value
    in place (the converter to flax takes float32)."""
    with torch.no_grad():
        for m in modules:
            if m is not None:
                for t in list(m.parameters()) + list(m.buffers()):
                    if t.is_floating_point():
                        t.copy_(t.float().to(t.dtype))


def _jax_recording(jt, run: _Run, P: int, warm=None):
    """JAX's step and batches, recorded; MCCL's rMC draw (the step's own,
    from ``state.rng``) too."""
    step, batches = jt.step_fn, jt._epoch_batches

    def step_fn(state, arrays, sched):
        if P > 1:
            _, part, _ = jax.random.split(state.rng, 3)
            b, h, w = arrays["img_t"].shape[:3]
            run.draws.append(np.array(jax_randint(part, b * h * w, P), np.int32))
        state, metrics = step(state, arrays, sched)
        run.steps.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    def epoch_batches():
        for b in batches():
            run.batches.append({k: v for k, v in b.items() if isinstance(v, np.ndarray)})
            yield b

    jt.step_fn, jt._epoch_batches = step_fn, epoch_batches
    restore = jt.restore_checkpoint

    def restore_checkpoint(tag, params_only=False):
        restore(tag, params_only=params_only)
        if params_only:
            run.warm = jax.tree.map(np.asarray, {"params": jt.state.seg.params,
                                                 "batch_stats": jt.state.seg.batch_stats})
            if warm is not None:
                # the fine-tune starts from the port's warm-started networks
                v = _f64(state_dict_to_flax(warm()))
                jt.state = jt.state.replace(seg=jt.state.seg.replace(
                    params=v["params"], batch_stats=v["batch_stats"]))

    jt.restore_checkpoint = restore_checkpoint


def _port_recording(tt, run: _Run, want: _Run, P: int, round_warm: bool = True):
    """The port's step and batches, recorded; each batch checked equal to
    JAX's before the step takes it; MCCL's rMC draw is JAX's of the step.
    A warm start is recorded, then (``round_warm``) rounded to float32
    values, as JAX's is given it."""
    step = tt.step_fn
    if P > 1:
        step = t_build_step(tt.cfg, centroids_loaded=tt.centroids_loaded,
                            draw_assign=lambda m, P_, dev: torch.from_numpy(
                                want.draws[tt.state.step]).to(dev))
    batches = tt._epoch_batches

    def step_fn(state, batch, sched):
        metrics = step(state, batch, sched)
        run.steps.append({k: float(v) for k, v in metrics.items()})
        return metrics

    def epoch_batches():
        for b in batches():
            i = len(run.batches)
            assert i < len(want.batches), f"the port's batch {i}: JAX had {len(want.batches)}"
            for k, v in want.batches[i].items():
                np.testing.assert_array_equal(b[k], v, err_msg=f"batch {i} {k}")
            run.batches.append(b)
            yield b

    tt.step_fn, tt._epoch_batches = step_fn, epoch_batches
    restore = tt.restore_checkpoint

    def restore_checkpoint(tag="best", params_only=False):
        restore(tag, params_only=params_only)
        if params_only:
            run.warm = state_dict_to_flax(tt.state.seg)
            run.warm_state = {k: v.clone() for k, v in tt.state.seg.state_dict().items()}
            if round_warm:
                _round_f32(tt.state.seg)

    tt.restore_checkpoint = restore_checkpoint


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """Per stage, (JAX's run, the port's run); the centre files."""
    return run_protocol(tmp_path_factory.mktemp("protocol"))


def run_protocol(tmp: Path, same_start: bool = True, round_init: bool = True) -> tuple:
    """The protocol through both Trainers under ``tmp``: per stage (JAX's
    run, the port's run), and the centre files (JAX's, the port's). With
    ``same_start`` False each fine-tune starts from its own package's
    warm start and centre file; with ``round_init`` False the port keeps
    its float64 initial weights, which JAX receives rounded to float32
    (``tools/protocol_parity.py``)."""
    import slcl_tpu.train.trainer as jtrainer
    from slcl_tpu.models import DRUNet, UncertaintyDiscriminator
    from slcl_tpu.train.state import create_train_state

    f64 = jnp.float64
    source = {}

    def segmentor(m):
        assert m.backbone == "drunet"
        return DRUNet(filters=m.filters, n_block=m.n_block,
                      bottleneck_depth=m.bottleneck_depth, n_class=m.num_classes,
                      multilvl=m.multilvl, phead=m.phead, dtype=f64)

    def converted_state(cfg_, model, disc=None, disc_aux=None, **kw):
        # the port's initial weights of the same stage, in place of flax's init
        s = source["trainer"].state
        assert (disc is None) == (s.d_main is None) and (disc_aux is None) == (s.d_aux is None)
        return create_train_state(
            cfg_, Preset(_f64(state_dict_to_flax(s.seg))),
            disc=Preset(_f64(state_dict_to_flax(s.d_main))) if disc else None,
            disc_aux=Preset(_f64(state_dict_to_flax(s.d_aux))) if disc_aux else None, **kw)

    runs, centres, ckpt = {}, {}, {}
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtrainer, "create_train_state", converted_state)
            mp.setattr(jtrainer, "build_segmentor", segmentor)
            mp.setattr(jtrainer, "UncertaintyDiscriminator",
                       lambda: UncertaintyDiscriminator(dtype=f64))
            jax_script = _jax_centres_script()

            def stage(name, jax_run=None, port_run=None):
                jcfg, tcfg = _configs(name, tmp / name, **(jax_run or {}))
                if port_run:
                    for k, v in port_run.items():
                        setattr(tcfg.run, k, v)
                tt = Trainer(tcfg, device="cpu")
                s = tt.state
                if round_init:
                    _round_f32(s.seg, s.d_main, s.d_aux)
                source["trainer"] = tt
                jt = jtrainer.Trainer(jcfg)
                assert jt.mesh is None
                P = tcfg.contrastive.part if tcfg.method == "mccl" else 1
                want, got = _Run(), _Run()
                warm = None
                if tcfg.run.init_from and same_start:
                    def warm():
                        Trainer.restore_checkpoint(tt, tcfg.run.init_from, params_only=True)
                        _round_f32(tt.state.seg)
                        return tt.state.seg
                _jax_recording(jt, want, P, warm)
                _port_recording(tt, got, want, P, round_warm=same_start)
                want.summary = jt.train()
                got.summary = tt.train()
                runs[name] = (want, got)
                return jt, tt

            jt, tt = stage("advent")
            ckpt["jax"] = str((jt.out_dir / "ckpt_best").absolute())
            ckpt["port"] = str(tt.out_dir / "ckpt_best.pt")

            for which in ("slcl", "mccl"):
                name = f"centres_{which}"
                jcfg, tcfg = _configs(name, tmp / name)
                source["trainer"] = Trainer(tcfg, device="cpu")   # mccl: its fresh head
                paths = {side: str(tmp / f"{name}_{side}.npy") for side in ("jax", "port")}
                want = jax_script.main(_cli(name, **{"run.restore_from": ckpt["jax"],
                                                     "out": paths["jax"]}))
                got = t_centres.main(_cli(name, **{"run.restore_from": ckpt["port"],
                                                   "out": paths["port"]}) + ["--device", "cpu"])
                np.testing.assert_array_equal(np.load(paths["jax"]), want)
                np.testing.assert_array_equal(np.load(paths["port"]), got)
                centres[which] = (want, got)
                # both fine-tunes start from the port's centre file (the two
                # files are compared in test_centre_file_matches_jax)
                stage(which, jax_run={"init_from": ckpt["jax"],
                                      "init_centers": paths["port" if same_start else "jax"]},
                      port_run={"init_from": ckpt["port"], "init_centers": paths["port"]})
    finally:
        torch.set_default_dtype(before)
    return runs, centres


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= max(REL * abs(want), ABS)


@pytest.mark.parametrize("stage", ["advent", "slcl", "mccl"])
def test_every_step_metric_matches_jax(protocol, stage):
    want, got = protocol[0][stage]
    assert len(got.batches) == len(want.batches) == 8 * E
    assert len(got.steps) == len(want.steps) == 8 * E
    for i, (g, w) in enumerate(zip(got.steps, want.steps)):
        assert set(g) == set(w), (stage, i)
        bad = [f"{k}: port {g[k]!r} jax {w[k]!r}" for k in w if not _close(g[k], w[k])]
        assert not bad, f"{stage}: first departure at step {i} (epoch {i // 8}): {bad}"


@pytest.mark.parametrize("stage", ["advent", "slcl", "mccl"])
def test_val_dice_and_best_epoch_match_jax(protocol, stage):
    want, got = protocol[0][stage]
    hw, hg = want.summary["history"], got.summary["history"]
    # the warm starts validate their init first (epoch -1)
    epochs = list(range(-1 if stage != "advent" else 0, E))
    assert [r["epoch"] for r in hw] == [r["epoch"] for r in hg] == epochs
    for rw, rg in zip(hw, hg):
        assert _close(rg["val_dice"], rw["val_dice"]), (stage, rw["epoch"], rg["val_dice"],
                                                        rw["val_dice"])
    assert got.summary["best_epoch"] == want.summary["best_epoch"]
    assert _close(got.summary["best_val_dice"], want.summary["best_val_dice"])


@pytest.mark.parametrize("stage", ["advent", "slcl", "mccl"])
def test_final_test_dice_matches_jax(protocol, stage):
    want, got = protocol[0][stage]
    for split in ("test", "test_s"):
        w, g = want.summary[split]["dc"], got.summary[split]["dc"]
        assert len(w) == len(g) == 6
        assert all(_close(a, b) for a, b in zip(g, w)), (stage, split, g, w)


@pytest.mark.parametrize("which", ["slcl", "mccl"])
def test_centre_file_matches_jax(protocol, which):
    want, got = protocol[1][which]
    assert got.shape == want.shape == (4, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("stage", ["slcl", "mccl"])
def test_warm_started_networks_match_jax(protocol, stage):
    want, got = protocol[0][stage]
    assert want.warm is not None and got.warm is not None
    for part in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(want.warm[part])[0]
        assert len(jax.tree.leaves(got.warm[part])) == len(flat), part
        for path, w in flat:
            node = got.warm[part]
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(np.asarray(node), w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{stage} {part}{jax.tree_util.keystr(path)}")
