"""Step parity on the new backbones: two ``slcl`` steps on a small
ResNetUNet (multilvl, CNR, both discriminators, the 1x1 feature projection),
two ``adaptseg`` and two ``advent`` steps on a small DeepLabV2 (multi-level,
frozen BatchNorm, the classifier heads ``layer5``/``layer6`` at 10x the LR)
and one ``baseline`` step on a small UNet, in the port against the JAX
package's ``create_train_state`` + ``build_step``, from the same weights,
batches and ``sched``, on the CPU in f32.

The JAX state is built by ``create_train_state`` itself (its optimizers and
the 10x group come from the config) around variables drawn from a numpy
seed: a stand-in whose ``init`` returns them replaces flax's op-by-op
``init``, which takes tens of seconds on the CPU.

Tolerances are tests/test_torch_step.py's, for the same reasons: metrics
rtol 1e-4 / atol 1e-5; segmentor parameters rtol 1e-4 / atol 1e-6;
discriminators, BatchNorm running statistics and the centres rtol 1e-4 /
atol 1e-5. ResNetUNet runs at 64x64 (at 32x32 its layer-4 map is 1x1), and
there the reference is the JAX step in float64 (``jax.enable_x64``:
variables, batches and ``sched`` cast; the step's own float32 casts stay),
with the float32 JAX step's own largest distance from it in each tensor
added to that tensor's tolerance. Through that deep network with batch statistics of a
few values float32 rounding grows into update errors of a few percent: the
float32 JAX step ends two steps 2.1e-5 from the float64 one on ``conv1``,
the port 4.3e-6 (and loss_cnr 0.0434389, 0.0435202 float64, port
0.0435208), so the test holds the port to the float64 step rather than to
the JAX package's float32 error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.models import DeepLabV2 as TDeepLab
from slcl_torch.models import ResNetUNet as TResNetUNet
from slcl_torch.models import UNet as TUNet
from slcl_torch.models import UncertaintyDiscriminator as TDisc
from slcl_torch.train.state import create_train_state as t_create_train_state
from slcl_torch.train.state import make_optimizer, param_groups, set_lr
from slcl_torch.train.steps import build_step as t_build_step
from slcl_torch.utils.convert import load_flax_weights, state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.models import UncertaintyDiscriminator
from slcl_tpu.models.deeplabv2 import DeepLabV2
from slcl_tpu.models.resnet_unet import ResNetUNet
from slcl_tpu.models.unet import UNet
from slcl_tpu.train.state import create_train_state
from slcl_tpu.train.steps import build_step

torch.set_num_threads(1)

BS = 2
SMALL = (1, 1, 1, 1)
# run -> (method, backbone, crop, flax model (its dtype), port model, steps,
# the JAX step in float64)
RUNS = {
    "slcl_resnet50": ("slcl", "resnet50", 64,
                      lambda dt: ResNetUNet(layers=SMALL, base=8, multilvl=True, dtype=dt),
                      lambda: TResNetUNet(layers=SMALL, base=8, multilvl=True), 2, True),
    "adaptseg_deeplabv2": ("adaptseg", "deeplabv2", 32,
                           lambda dt: DeepLabV2(layers=SMALL, multi_level=True, dtype=dt),
                           lambda: TDeepLab(layers=SMALL, multi_level=True), 2, False),
    "advent_deeplabv2": ("advent", "deeplabv2", 32,
                         lambda dt: DeepLabV2(layers=SMALL, multi_level=True, dtype=dt),
                         lambda: TDeepLab(layers=SMALL, multi_level=True), 2, False),
    "baseline_unet": ("baseline", "unet", 32, lambda dt: UNet(base=8, dtype=dt),
                      lambda: TUNet(base=8), 1, False),
}


def _cfg(cls, recipe, method, backbone, crop):
    cfg = cls()
    cfg.method = method
    cfg = recipe(cfg)
    cfg.model.backbone = backbone
    cfg.model.multilvl = backbone != "unet"
    cfg.model.dtype = "float32"
    cfg.data.crop, cfg.data.bs = crop, BS
    if method == "advent":
        cfg.adv.w_ent, cfg.adv.w_prior = 0.5, 1.0
    return cfg


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _random_variables(model, shape, seed):
    """Variables on ``jax.eval_shape``'s shapes from a numpy seed (kernels
    N(0, 1)/sqrt(fan_in), BN scales 1 + 0.1 N(0, 1), biases and means
    0.1 N(0, 1), variances |N(0, 1)| + 0.5; a discriminator's N(0, 0.02))."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros(shape)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    disc = isinstance(model, UncertaintyDiscriminator)

    def leaf(path, s):
        name, n = path[-1].key, rng.normal(size=s.shape).astype(np.float32)
        if disc:
            return 0.02 * n
        if name == "kernel":
            return n / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return np.abs(n) + 0.5
        return 0.1 * n
    return jax.tree_util.tree_map_with_path(leaf, shapes)


class _Preset:
    """Stands in for a flax module in ``create_train_state``: its ``init``
    returns the given variables."""

    def __init__(self, variables):
        self.variables = variables

    def init(self, *args):
        return self.variables


def _assert_tree_close(got, want, rtol, atol, what, floor=None):
    """|got - want| <= atol + rtol |want| per element, plus max |floor - want|
    over the tensor where a float32 JAX run ``floor`` stands beside a
    float64 ``want``."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_f = (jax.tree.leaves(floor) if floor is not None else [None] * len(flat_w))
    for (path, w), f in zip(flat_w, flat_f):
        node = got
        for p in path:
            node = node[p.key]
        lim = atol + rtol * np.abs(w) + (0.0 if f is None else np.abs(f - w).max())
        bad = np.abs(node - w) > lim
        assert not bad.any(), (f"{what} {jax.tree_util.keystr(path)}: {int(bad.sum())} "
                               f"of {bad.size} off, max |err| {np.abs(node - w).max():.3g}")
    assert len(jax.tree.leaves(got)) == len(flat_w), what


def _jax_steps(x64, method, backbone, crop, flax_model, seg_v, d_v, batches, sched):
    """The JAX package's steps from the same variables and batches, in
    float64 (``x64``) or float32: per step the metrics and the state."""
    adversarial = method != "baseline"
    dt = jnp.float64 if x64 else jnp.float32
    out = []
    with jax.enable_x64(x64):
        cast = jax.tree.map(lambda a: jnp.asarray(a, dt), (seg_v, d_v))
        cfg = _cfg(Config, apply_recipe, method, backbone, crop)
        model = flax_model(dt)
        disc = UncertaintyDiscriminator(dtype=dt) if adversarial else None
        centroids = (jnp.zeros((4, cfg.model.filters), dt) if method == "slcl" else None)
        state, txs = create_train_state(
            cfg, _Preset(cast[0]), disc=_Preset(cast[1][0]) if adversarial else None,
            disc_aux=_Preset(cast[1][1]) if adversarial else None,
            sample_shape=(1, crop, crop, 3), centroids=centroids)
        step = build_step(cfg, model, txs, disc, disc)
        jsched = {k: jnp.asarray(v, dt) for k, v in sched.items()}
        for batch in batches:
            state, jm = step(state, {k: jnp.asarray(v, dt if v.dtype == np.float32 else None)
                                     for k, v in batch.items()}, jsched)
            want = {"seg": state.seg.params, "bs": state.seg.batch_stats}
            if adversarial:
                want.update(d_main=state.d_main.params, d_aux=state.d_aux.params)
            if centroids is not None:
                want["centroids"] = state.centroids
            out.append({"want_m": {k: float(v) for k, v in jm.items()},
                        "want": jax.tree.map(lambda a: np.asarray(a, np.float64), want)})
    return out


def _run(name):
    """Per step (from 1; 0 holds the initial weights): the JAX reference's
    metrics and state, a float32 JAX run's beside a float64 reference, and
    the port's."""
    method, backbone, crop, flax_model, port_model, steps, x64 = RUNS[name]
    adversarial = method != "baseline"
    seg_v = _random_variables(flax_model(jnp.float32), (1, crop, crop, 3), 1)
    d_v = [_random_variables(UncertaintyDiscriminator(dtype=jnp.float32),
                             (1, crop, crop, 4), s) for s in (2, 3)] if adversarial \
        else [None, None]
    rng = np.random.default_rng(11)
    batches = [{"img_s": rng.normal(size=(BS, crop, crop, 3)).astype(np.float32),
                "lab_s": rng.integers(0, 4, size=(BS, crop, crop)).astype(np.int32),
                # target images from another distribution than the source
                # (see tests/test_torch_step_advent.py)
                "img_t": rng.normal(0.5, 2.0, size=(BS, crop, crop, 3)).astype(np.float32)}
               for _ in range(steps)]
    sched = {"lr": 8e-4, "lr_dis": 1e-4, "warm": 1.0}
    args = (method, backbone, crop, flax_model, seg_v, d_v, batches, sched)
    out = [{"want": _np({"seg": seg_v["params"]})}] + _jax_steps(x64, *args)
    if x64:
        for rec, f32 in zip(out[1:], _jax_steps(False, *args)):
            rec.update(floor=f32["want"], floor_m=f32["want_m"])

    tcfg = _cfg(TConfig, t_apply_recipe, method, backbone, crop)
    seg = load_flax_weights(port_model().to(memory_format=torch.channels_last),
                            _np(seg_v["params"]), _np(seg_v["batch_stats"]))
    d_main = load_flax_weights(TDisc(), _np(d_v[0]["params"])) if adversarial else None
    d_aux = load_flax_weights(TDisc(), _np(d_v[1]["params"])) if adversarial else None
    tstate = t_create_train_state(
        tcfg, seg, disc=d_main, disc_aux=d_aux,
        centroids=torch.zeros(4, tcfg.model.filters) if method == "slcl" else None)
    tstep = t_build_step(tcfg)
    for rec, batch in zip(out[1:], batches):
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, sched)
        got = {"seg": state_dict_to_flax(tstate.seg)}
        if adversarial:
            got.update(d_main=state_dict_to_flax(tstate.d_main)["params"],
                       d_aux=state_dict_to_flax(tstate.d_aux)["params"])
        if tstate.centroids is not None:
            got["centroids"] = tstate.centroids.numpy().copy()
        rec.update(got_m={k: float(v) for k, v in tm.items()}, got=got)
    return out


@pytest.fixture(scope="module")
def runs():
    return {name: _run(name) for name in RUNS}


CASES = [(name, i) for name, run in RUNS.items() for i in range(1, run[5] + 1)]


@pytest.mark.parametrize("name,i", CASES)
def test_metrics_match(runs, name, i):
    rec = runs[name][i]
    want, got, floor = rec["want_m"], rec["got_m"], rec.get("floor_m")
    assert set(got) == set(want)
    if RUNS[name][0] in ("adaptseg", "advent"):
        assert {"seg_s_aux", "loss_adv_aux", "loss_dis_aux"} <= set(got)
    for k in want:
        extra = abs(floor[k] - want[k]) if floor else 0.0
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5 + extra), k


@pytest.mark.parametrize("name,i", CASES)
def test_parameters_running_stats_and_centres_match(runs, name, i):
    rec = runs[name][i]
    want, got, floor = rec["want"], rec["got"], rec.get("floor")
    part = (lambda k: None) if floor is None else (lambda k: floor[k])
    _assert_tree_close(got["seg"]["params"], want["seg"], 1e-4, 1e-6, f"{name} {i} seg",
                       part("seg"))
    _assert_tree_close(got["seg"]["batch_stats"], want["bs"], 1e-4, 1e-5,
                       f"{name} {i} batch_stats", part("bs"))
    for key in ("d_main", "d_aux", "centroids"):
        if key in want:
            _assert_tree_close(got[key], want[key], 1e-4, 1e-5, f"{name} {i} {key}",
                               part(key))


@pytest.mark.parametrize("name", ["adaptseg_deeplabv2", "advent_deeplabv2"])
def test_head_group_moves_at_ten_times_the_lr(runs, name):
    """The first SGD step moves ``layer5``/``layer6`` by 10 lr (g + wd p) in
    JAX, at least 7.9e-5 here: a 1x update would land 7e-5 away, far
    outside the parameter tolerance (1e-6 + 1e-4 |p|, p ~ 0.01), so the
    parity above holds the port's 10x group. The frozen BatchNorms move by
    their decay alone (lr wd p = 4e-7)."""
    init, after = runs[name][0]["want"]["seg"], runs[name][1]["want"]["seg"]
    for head in ("layer5", "layer6"):
        delta = jax.tree.map(lambda a, b: np.abs(a - b).max(), after[head], init[head])
        assert min(jax.tree.leaves(delta)) > 1e-5, head
    bn = np.abs(after["bn1"]["scale"] - init["bn1"]["scale"]).max()
    assert 0.0 < bn < 1e-6


def test_set_lr_keeps_the_head_ratio_through_a_checkpoint(tmp_path):
    """``set_lr`` writes lr and 10 lr into the two DeepLab groups, and the
    optimizer's state dict, saved and loaded as the trainer's checkpoint
    is, carries the ratio into an optimizer built without it."""
    seg = TDeepLab(layers=SMALL, multi_level=True)
    groups = param_groups(seg, "deeplabv2")
    heads = {id(p) for n, p in seg.named_parameters() if n.split(".")[0] in ("layer5", "layer6")}
    assert {id(p) for p in groups[1]["params"]} == heads
    assert param_groups(seg, "resnet101")[0]["lr_mult"] == 1.0    # as JAX's lr10 keys
    assert len(param_groups(seg, "resnet101")) == 1
    opt = make_optimizer("sgd", groups, 8e-4, weight_decay=5e-4)
    assert [g["lr"] for g in opt.param_groups] == [8e-4, 8e-3]
    set_lr(opt, 2e-4)
    assert [g["lr"] for g in opt.param_groups] == [2e-4, 2e-3]
    torch.save({"opt_seg": opt.state_dict()}, tmp_path / "ckpt.pt")
    fresh = make_optimizer("sgd", [{"params": g["params"]} for g in groups], 1.0)
    assert [g["lr_mult"] for g in fresh.param_groups] == [1.0, 1.0]
    fresh.load_state_dict(torch.load(tmp_path / "ckpt.pt", weights_only=True)["opt_seg"])
    set_lr(fresh, 1e-3)
    assert [g["lr"] for g in fresh.param_groups] == [1e-3, 1e-2]
