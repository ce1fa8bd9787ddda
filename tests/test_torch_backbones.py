"""Port parity for the backbones: ResNetUNet (the paper's ResNet-50 U-Net),
DeepLabV2 (frozen BatchNorm) and UNet. Flax variables drawn from a numpy
seed on the shapes ``jax.eval_shape`` gives are carried into the port's
models by ``slcl_torch.utils.convert``; then the same input goes through
both, in eval mode and in train mode.

The reference is the JAX model run in float64 (``jax.enable_x64``, the
variables cast; its bilinear upsampling stays float32 inside): flax's
BatchNorm takes the batch variance in float32 as E[x^2] - E[x]^2, which on
ResNetUNet's layer-4 map (2x2 over two images at 64x64) moves the float32
JAX forward several times further from the float64 one than the port's
float32 forward (at 32x32: 9.3e-4 against 1.6e-4, measured). The port runs
in float32 at DRUNet's tolerances (tests/test_torch_models.py): pred and
dcdr_ft rtol 1e-3 / atol 1e-4, aux atol 2e-3; BatchNorm running statistics
after one train-mode forward rtol 1e-4 / atol 1e-5. The full-width
parameter counts equal the JAX models'. FrozenBatchNorm's scale and bias take no gradient from the loss and are
decayed as optax decays them; flax's ConvTranspose kernel reaches torch
flipped in both spatial axes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slcl_torch.config import ModelConfig
from slcl_torch.models import DeepLabV2 as TDeepLab
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models import FrozenBatchNorm as TFrozenBN
from slcl_torch.models import ResNetUNet as TResNetUNet
from slcl_torch.models import UNet as TUNet
from slcl_torch.models import build_segmentor as t_build_segmentor
from slcl_torch.train.state import TrainState, make_optimizer
from slcl_torch.train.steps import _seg_update
from slcl_torch.utils.convert import flax_to_state_dict, load_flax_weights, state_dict_to_flax
from slcl_tpu.models.common import FrozenBatchNorm
from slcl_tpu.models.deeplabv2 import DeepLabV2
from slcl_tpu.models.resnet_unet import ResNetUNet
from slcl_tpu.models.unet import UNet

torch.set_num_threads(1)

SMALL = (1, 1, 1, 1)


def random_variables(model, hw, seed):
    """flax variables of ``model`` from a numpy seed: kernels
    N(0, 1)/sqrt(fan_in), BN scales 1 + 0.1 N(0, 1), biases and means
    0.1 N(0, 1), variances |N(0, 1)| + 0.5. No ``model.init``: its
    op-by-op run takes tens of seconds on the CPU."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, hw, hw, 3)), False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, n = path[-1].key, rng.normal(size=s.shape).astype(np.float32)
        if name == "kernel":
            return n / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return np.abs(n) + 0.5
        return 0.1 * n
    return jax.tree_util.tree_map_with_path(leaf, shapes)


# name -> (flax model, port model, input size)
CASES = {
    "resnet_unet_multilvl_phead": (
        lambda: ResNetUNet(layers=SMALL, base=8, multilvl=True, phead=True,
                           dtype=jnp.float32),
        lambda: TResNetUNet(layers=SMALL, base=8, multilvl=True, phead=True), 64),
    "resnet_unet_filters16": (
        lambda: ResNetUNet(layers=SMALL, base=8, feat_dim=16, dtype=jnp.float32),
        lambda: TResNetUNet(layers=SMALL, base=8, feat_dim=16), 64),
    "deeplabv2_33": (lambda: DeepLabV2(layers=SMALL, multi_level=True, dtype=jnp.float32),
                     lambda: TDeepLab(layers=SMALL, multi_level=True), 33),
    "deeplabv2_40": (lambda: DeepLabV2(layers=SMALL, multi_level=True, dtype=jnp.float32),
                     lambda: TDeepLab(layers=SMALL, multi_level=True), 40),
    "unet": (lambda: UNet(base=8, dtype=jnp.float32), lambda: TUNet(base=8), 32),
}


@pytest.fixture(scope="module")
def forwards():
    """Per case and port dtype: the reference's outputs (eval, train) and
    running statistics after the train forward, and the port's."""
    out = {}
    for i, (name, (flax_model, port_model, hw)) in enumerate(CASES.items()):
        v = random_variables(flax_model(), hw, i)
        x = np.random.default_rng(100 + i).normal(size=(2, hw, hw, 3)).astype(np.float32)
        with jax.enable_x64():
            model = flax_model().clone(dtype=jnp.float64)
            v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
            x64 = jnp.asarray(x, jnp.float64)
            ev = jax.jit(lambda v, x: model.apply(v, x, False))(v64, x64)
            tr, upd = jax.jit(lambda v, x: model.apply(v, x, True, mutable=["batch_stats"]))(
                v64, x64)
            want = {"eval": jax.tree.map(np.asarray, ev), "train": jax.tree.map(np.asarray, tr),
                    "stats": jax.tree.map(np.asarray, upd["batch_stats"])}
        port = load_flax_weights(port_model().to(memory_format=torch.channels_last),
                                 v["params"], v["batch_stats"])
        with torch.no_grad():
            got_ev = port.eval()(torch.from_numpy(x))
        got_tr = port.train()(torch.from_numpy(x))
        out[name] = {"eval": (want["eval"], got_ev), "train": (want["train"], got_tr),
                     "stats": (want["stats"], state_dict_to_flax(port)["batch_stats"]),
                     "port": port}
    return out


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_flax(forwards, name, mode):
    want, got = forwards[name][mode]
    hw = CASES[name][2]
    assert tuple(got.pred.shape) == want.pred.shape == (2, hw, hw, 4)
    assert tuple(got.dcdr_ft.shape) == want.dcdr_ft.shape
    np.testing.assert_allclose(got.pred.detach().numpy(), want.pred, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.dcdr_ft.detach().numpy(), want.dcdr_ft,
                               rtol=1e-3, atol=1e-4)
    if want.aux is None:
        assert got.aux is None
    else:
        np.testing.assert_allclose(got.aux.detach().numpy(), want.aux, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_running_stats_match_flax(forwards, name):
    want, got = forwards[name]["stats"]
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} {jax.tree_util.keystr(path)}")
    assert len(jax.tree.leaves(got)) == len(flat)


def test_shapes_of_the_taps(forwards):
    """The ResNetUNet tap projected to ``feat_dim`` (none at 16), DeepLab's
    layer-4 map at 1/8 of the input through the ceil-mode pool (33 -> 5,
    40 -> 6), UNet's base channels at full resolution."""
    shape = {n: tuple(forwards[n]["train"][1].dcdr_ft.shape) for n in CASES}
    assert shape["resnet_unet_multilvl_phead"] == (2, 64, 64, 32)
    assert shape["resnet_unet_filters16"] == (2, 64, 64, 16)
    assert shape["deeplabv2_33"] == (2, 5, 5, 2048)
    assert shape["deeplabv2_40"] == (2, 6, 6, 2048)
    assert shape["unet"] == (2, 32, 32, 8)
    assert not hasattr(forwards["resnet_unet_filters16"]["port"], "feat_proj")
    assert forwards["resnet_unet_multilvl_phead"]["port"].feat_dim == 32


def _count_flax(model, hw=64):
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, hw, hw, 3)), False),
                            jax.random.PRNGKey(0))
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("name,flax_model,port_model", [
    ("resnet50 multilvl phead",
     lambda: ResNetUNet(multilvl=True, phead=True, dtype=jnp.float32),
     lambda: TResNetUNet(multilvl=True, phead=True)),
    ("resnet50 multilvl", lambda: ResNetUNet(multilvl=True, dtype=jnp.float32),
     lambda: TResNetUNet(multilvl=True)),
    ("resnet50 filters16", lambda: ResNetUNet(feat_dim=16, dtype=jnp.float32),
     lambda: TResNetUNet(feat_dim=16)),
    ("deeplabv2 multi_level", lambda: DeepLabV2(multi_level=True, dtype=jnp.float32),
     lambda: TDeepLab(multi_level=True)),
    ("deeplabv2", lambda: DeepLabV2(dtype=jnp.float32), lambda: TDeepLab()),
    ("unet", lambda: UNet(dtype=jnp.float32), lambda: TUNet()),
])
def test_full_width_parameter_count(name, flax_model, port_model):
    n_port = sum(p.numel() for p in port_model().parameters())
    assert n_port == _count_flax(flax_model()), name
    if name == "deeplabv2 multi_level":
        assert n_port == 42_942_560      # tests/test_models.py's oracle


@pytest.mark.parametrize("cell,flax_model", [
    ("resnet50_slcl", lambda: ResNetUNet(multilvl=True, dtype=jnp.float32)),
    ("resnet50_mccl", lambda: ResNetUNet(phead=True, dtype=jnp.float32)),
    ("deeplabv2_advent", lambda: DeepLabV2(multi_level=True, dtype=jnp.float32)),
    ("deeplabv2_adaptseg", lambda: DeepLabV2(multi_level=True, dtype=jnp.float32)),
    ("unet_baseline", lambda: UNet(dtype=jnp.float32)),
])
def test_chip_smoke_parameter_counts_are_the_jax_models(cell, flax_model):
    """chip_smoke.py asserts each full-width backbone cell's parameter
    count on the card: the constants are the JAX models' counts."""
    import chip_smoke
    assert chip_smoke.N_PARAMS[cell] == _count_flax(flax_model())


def test_build_segmentor_names():
    cfg = ModelConfig()
    want = {"drunet": TDRUNet, "unet": TUNet, "deeplabv2": TDeepLab,
            "resnet101": TDeepLab, "resnet50": TResNetUNet, "resnet50_unet": TResNetUNet}
    for name, cls in want.items():
        cfg.backbone = name
        cfg.layers, cfg.base = (SMALL, 8) if "resnet50" in name else ((), 64)
        m = t_build_segmentor(cfg)
        assert type(m) is cls, name
    # layers / base reach ResNetUNet only; DeepLabV2 keeps ResNet-101
    cfg.backbone, cfg.layers, cfg.base = "deeplabv2", SMALL, 8
    assert t_build_segmentor(cfg).layers == (3, 4, 23, 3)
    cfg.backbone = "resnet50"
    m = t_build_segmentor(cfg)
    assert m.layers == SMALL and m.conv1.out_channels == 8
    cfg.backbone = "vgg"
    with pytest.raises(ValueError, match="vgg"):
        t_build_segmentor(cfg)


def test_frozen_batch_norm_takes_no_gradient_and_decays_as_optax(rng):
    """Two SGD steps (momentum 0.9, weight decay 0.05, lr 0.1) on a loss
    through a FrozenBatchNorm: its scale and bias get no loss gradient,
    the optimizer still decays them (optax decays every leaf), and the
    output, running statistics and parameters match flax's."""
    c, lr, wd = 6, 0.1, 0.05
    x = rng.normal(size=(4, 5, 5, c)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)

    fbn = FrozenBatchNorm(dtype=jnp.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    tx = optax.chain(optax.add_decayed_weights(wd), optax.sgd(lr, momentum=0.9))
    opt_state = tx.init(params)

    port = TFrozenBN(c)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.zeros(c), "running_var": torch.ones(c)})
    state = TrainState(seg=port, opt_seg=make_optimizer("sgd", port.parameters(), lr,
                                                        weight_decay=wd))
    for _ in range(2):
        def loss_fn(p, s):
            y, upd = fbn.apply({"params": p, "batch_stats": s}, jnp.asarray(x), True,
                               mutable=["batch_stats"])
            return jnp.sum(y ** 2), (y, upd["batch_stats"])
        (_, (y, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, stats)
        assert all(float(jnp.abs(g).max()) == 0.0 for g in jax.tree.leaves(grads))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        got = port(xt)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
        loss = (got ** 2).sum()
        assert torch.autograd.grad(loss, [port.weight, port.bias], retain_graph=True,
                                   allow_unused=True) == (None, None)
        _seg_update(state, loss, lr)
        assert float(port.weight.grad.abs().max()) == 0.0
        np.testing.assert_allclose(port.weight.detach().numpy(), np.asarray(params["scale"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(port.bias.detach().numpy(), np.asarray(params["bias"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-5, atol=1e-6)
    # the decay moved them: two steps of lr * wd * (1 + 1.9) on scale ~1
    assert not np.allclose(port.weight.detach().numpy(), scale, atol=1e-3)


def test_conv_transpose_kernel_is_flipped(rng):
    """flax's ConvTranspose (2x2, stride 2) equals the port's ConvTranspose2d
    only with the kernel flipped in both spatial axes; the converter flips
    it, and state_dict_to_flax flips it back."""
    model = UNet(base=4, dtype=jnp.float32)
    v = random_variables(model, 16, 3)
    port = load_flax_weights(TUNet(base=4), v["params"], v["batch_stats"])
    kernel = np.asarray(v["params"]["up1_up"]["kernel"])            # (2, 2, I, O)
    x = rng.normal(size=(2, 3, 3, kernel.shape[2])).astype(np.float32)
    from flax import linen as nn
    want = nn.ConvTranspose(kernel.shape[3], (2, 2), strides=(2, 2)).apply(
        {"params": v["params"]["up1_up"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port.up1_up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        unflipped = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (2, 3, 0, 1)))),
            port.up1_up.bias, stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert np.abs(unflipped.numpy() - np.asarray(want)).max() > 1e-2
    back = state_dict_to_flax(port)["params"]["up1_up"]["kernel"]
    np.testing.assert_array_equal(back, kernel)
    bad = dict(v["params"], up1_up={"kernel": kernel[:, :, :, :1], "bias": np.zeros(1)})
    with pytest.raises(ValueError, match="up1_up"):
        flax_to_state_dict(TUNet(base=4), bad, v["batch_stats"])
