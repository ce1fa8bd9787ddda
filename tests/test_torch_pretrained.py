"""The ImageNet encoder import (``slcl_torch/utils/pretrained.py``) against
the JAX package's (``slcl_tpu/utils/torch_convert.py``): one
torchvision-named ResNet state dict drawn from a numpy seed goes into both
packages' ResNetUNet and DeepLabV2 (the rest of each model carried from the
same flax variables), and the eval forwards agree at DRUNet's tolerances
(rtol 1e-3 / atol 1e-4). It loads from a ``.pth`` and from the JAX
converter's ``.npz`` alike; ``fc.*`` is ignored, entries the model lacks
are reported, a missing file or trunk entry raises.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.models import DeepLabV2 as TDeepLab
from slcl_torch.models import ResNetUNet as TResNetUNet
from slcl_torch.utils.convert import load_flax_weights
from slcl_torch.utils.pretrained import load_pretrained_encoder, port_key
from slcl_tpu.models.deeplabv2 import DeepLabV2
from slcl_tpu.models.resnet_unet import ResNetUNet
from slcl_tpu.utils import torch_convert as tc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = (1, 1, 1, 1)


def torchvision_dict(layers, base, seed):
    """A torchvision ResNet (bottleneck) state dict with random values:
    conv1/bn1, layer{L}.{b}.conv{1..3}/bn{1..3}, downsample.{0,1} on each
    stage's first block, num_batches_tracked and the fc head."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, o, i, k):
        sd[key] = (rng.normal(size=(o, i, k, k)) / np.sqrt(i * k * k)).astype(np.float32)

    def bn(key, c):
        sd[f"{key}.weight"] = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.running_mean"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.running_var"] = (np.abs(rng.normal(size=c)) + 0.5).astype(np.float32)
        sd[f"{key}.num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1.weight", base, 3, 7)
    bn("bn1", base)
    prev = base
    for li, blocks in enumerate(layers, start=1):
        planes = base * 2 ** (li - 1)
        for b in range(blocks):
            p = f"layer{li}.{b}"
            conv(f"{p}.conv1.weight", planes, prev, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2.weight", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3.weight", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                conv(f"{p}.downsample.0.weight", planes * 4, prev, 1)
                bn(f"{p}.downsample.1", planes * 4)
            prev = planes * 4
    sd["fc.weight"] = rng.normal(size=(10, prev)).astype(np.float32)
    sd["fc.bias"] = np.zeros(10, np.float32)
    return sd


def _flax_variables(model, hw, seed):
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, hw, hw, 3)), False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.05).astype(np.float32),
                        shapes)


def _fix_var(stats):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.abs(a) + 0.5 if p[-1].key == "var" else a, stats)


# backbone -> (flax model, port model, input size, torchvision base)
CASES = {
    "resnet50": (lambda: ResNetUNet(layers=SMALL, base=8, multilvl=True, dtype=jnp.float32),
                 lambda: TResNetUNet(layers=SMALL, base=8, multilvl=True), 64, 8),
    "deeplabv2": (lambda: DeepLabV2(layers=SMALL, multi_level=True, dtype=jnp.float32),
                  lambda: TDeepLab(layers=SMALL, multi_level=True), 33, 64),
}


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
@pytest.mark.parametrize("backbone", list(CASES))
def test_encoder_import_matches_jax(tmp_path, backbone, suffix):
    flax_model, port_model, hw, base = CASES[backbone]
    model = flax_model()
    v = _flax_variables(model, hw, 0)
    v["batch_stats"] = _fix_var(v["batch_stats"])
    sd = torchvision_dict(SMALL, base, 1)

    # JAX: the package's converter and merge (trainer._load_pretrained_encoder)
    enc_p, enc_b = tc.convert_resnet_encoder(sd, SMALL)
    params, rep = tc.merge_pretrained(v["params"], enc_p)
    stats, brep = tc.merge_pretrained(v["batch_stats"], enc_b)
    assert not [r for r in rep + brep if r.startswith("!")]
    x = np.random.default_rng(5).normal(size=(2, hw, hw, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: model.apply(v, x, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))

    path = tmp_path / f"enc{suffix}"
    if suffix == ".pth":
        torch.save({k: torch.from_numpy(a) for k, a in sd.items()}, path)
    else:   # scripts/convert_torch.py's archive
        tc.save_tree_npz(str(path), params=enc_p, batch_stats=enc_b)
    port = load_flax_weights(port_model(), v["params"], v["batch_stats"])
    report = load_pretrained_encoder(port, str(path), backbone)
    assert report["unmatched"] == []
    n_trunk = sum(1 for k in sd if not k.startswith("fc.") and "num_batches" not in k)
    assert report["loaded"] == n_trunk
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.pred.numpy(), np.asarray(want.pred), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.aux.numpy(), np.asarray(want.aux), rtol=1e-3, atol=2e-3)


def test_port_key_names():
    assert port_key("layer3.5.downsample.0.weight") == "layer3_5.down_conv.weight"
    assert port_key("layer1.0.downsample.1.running_var") == "layer1_0.down_bn.running_var"
    assert port_key("layer2.1.bn3.bias") == "layer2_1.bn3.bias"
    assert port_key("conv1.weight") == "conv1.weight"


def test_unmatched_reported_missing_and_mismatched_raise(tmp_path):
    port = TResNetUNet(layers=SMALL, base=8)
    sd = torchvision_dict((1, 2, 1, 1), 8, 2)      # a block the model lacks
    torch.save({k: torch.from_numpy(a) for k, a in sd.items()}, tmp_path / "extra.pth")
    report = load_pretrained_encoder(port, str(tmp_path / "extra.pth"), "resnet50")
    assert sorted(report["unmatched"]) == sorted(k for k in sd if k.startswith("layer2.1.")
                                                 and "num_batches" not in k)
    assert torch.equal(port.layer2_0.down_conv.weight,
                       torch.from_numpy(sd["layer2.0.downsample.0.weight"]))

    short = {k: v for k, v in torchvision_dict(SMALL, 8, 3).items()
             if not k.startswith("layer4.")}
    torch.save({k: torch.from_numpy(a) for k, a in short.items()}, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="layer4_0"):
        load_pretrained_encoder(port, str(tmp_path / "short.pth"), "resnet50")
    wide = torchvision_dict(SMALL, 16, 4)
    torch.save({k: torch.from_numpy(a) for k, a in wide.items()}, tmp_path / "wide.pth")
    with pytest.raises(ValueError, match="shape"):
        load_pretrained_encoder(port, str(tmp_path / "wide.pth"), "resnet50")
    with pytest.raises(FileNotFoundError, match="pretrained_ckpt"):
        load_pretrained_encoder(port, str(tmp_path / "none.pth"), "resnet50")
    with pytest.raises(ValueError, match="drunet"):
        load_pretrained_encoder(port, str(tmp_path / "extra.pth"), "drunet")


def test_trainer_with_pretrained_and_no_file_raises(tmp_path):
    """JAX prints and trains from scratch; the port's CLI stops."""
    args = [sys.executable, "-m", "slcl_torch.train", "method=baseline",
            "model.backbone=resnet50", "model.layers=[1,1,1,1]", "model.base=8",
            "model.pretrained=true", f"model.pretrained_ckpt={tmp_path / 'none.pth'}",
            "data.dataset=synthetic", "data.crop=32", "data.bs=2", "optim.epochs=1",
            f"run.out_dir={tmp_path}", "--device", "cpu"]
    out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)))
    assert out.returncode != 0
    assert "FileNotFoundError" in out.stderr and "pretrained_ckpt" in out.stderr
