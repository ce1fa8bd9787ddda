"""Serving on the port (``slcl_torch.serve``): the ``torch.export``
artifact against the live model, its reload with no model code, every
backbone, the batch-server CLI, and the whole path against
``slcl_tpu.serve`` on the same weights and PNGs.

Tolerances: labels equal (float32 export: the artifact runs the live
model's own ops); probabilities equal the live model's within 1e-6 and
sum to 1 within 1e-5; against JAX (flax weights carried across by
``utils/convert.py``, both exported in float32) labels equal and
probabilities within 1e-5; the serve CLI's masks equal JAX's ``serve._main``
masks pixel for pixel (its uint8 resize is cv2's fixed-point arithmetic).
"""
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch import serve
from slcl_torch.config import Config
from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models import build_segmentor
from slcl_torch.utils.convert import load_flax_weights
from slcl_tpu import serve as j_serve
from slcl_tpu.models import DRUNet

torch.set_num_threads(1)

CROP = 32
SMALL = dict(filters=8, n_block=2, bottleneck_depth=2)


def _tiny(backbone: str = "drunet", seed: int = 0):
    cfg = Config()
    cfg.model.backbone, cfg.model.multilvl = backbone, True
    cfg.model.filters, cfg.model.n_block, cfg.model.bottleneck_depth = 8, 2, 2
    if backbone == "resnet50":
        cfg.model.layers, cfg.model.base = (1, 1, 1, 1), 8
    net = build_segmentor(cfg.model, generator=torch.Generator().manual_seed(seed))
    return net.to(memory_format=torch.channels_last)


def _x(n: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, CROP, CROP, 3)).astype(np.float32))


def _artifact(tmp_path, net, **kw) -> Path:
    path = tmp_path / "m.slclt"
    serve.save_artifact(path, serve.export_segmentor(net, crop=CROP, **kw),
                        {"method": "baseline", "backbone": "drunet", "crop": CROP})
    return path


def test_artifact_round_trip_matches_the_live_model(tmp_path):
    net = _tiny()
    fn, meta = serve.load_artifact(_artifact(tmp_path, net), "cpu")
    assert meta["format"] == "slclt-v1" and meta["crop"] == CROP
    assert meta["device"] == "cpu" and meta["dtype"] == "float32"
    assert meta["in_avals"] == [f"float32[b,{CROP},{CROP},3]"]
    live = serve.make_infer_fn(net)
    for n in (1, 2, 3):
        got = fn(_x(n, n))
        with torch.no_grad():
            want = live(_x(n, n))
        assert got.shape == (n, CROP, CROP) and got.dtype == torch.int32
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_artifact_with_probs(tmp_path):
    net = _tiny()
    fn, _ = serve.load_artifact(_artifact(tmp_path, net, with_probs=True), "cpu")
    labels, probs = fn(_x(2))
    assert probs.shape == (2, CROP, CROP, 4) and probs.dtype == torch.float32
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, CROP, CROP), rtol=0, atol=1e-5)
    assert torch.equal(labels, probs.argmax(-1).to(torch.int32))
    with torch.no_grad():
        want_l, want_p = serve.make_infer_fn(net, with_probs=True)(_x(2))
    assert torch.equal(labels, want_l)
    torch.testing.assert_close(probs, want_p, rtol=0, atol=1e-6)


def test_foreign_file_and_jax_artifact_raise(tmp_path):
    bogus = tmp_path / "bogus.slclt"
    bogus.write_bytes(b"not an artifact at all")
    with pytest.raises(ValueError, match="magic"):
        serve.load_artifact(bogus, "cpu")
    model = DRUNet(dtype=jnp.float32, **SMALL)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3)), False)
    jax_art = tmp_path / "m.slclx"
    j_serve.save_artifact(jax_art, j_serve.export_segmentor(model, variables, crop=CROP,
                                                            platforms=("cpu",)))
    with pytest.raises(ValueError, match="JAX slclx artifact.*slcl_tpu"):
        serve.load_artifact(jax_art, "cpu")


@pytest.mark.parametrize("backbone", ["drunet", "unet", "deeplabv2", "resnet50"])
def test_every_backbone_exports_and_serves(tmp_path, backbone):
    """Exported at batch 2, served at 1, 3 and 16: no shape test in an eval
    path specialises the batch."""
    net = _tiny(backbone)
    fn, _ = serve.load_artifact(_artifact(tmp_path, net), "cpu")
    live = serve.make_infer_fn(net)
    for n in (1, 3, 16):
        with torch.no_grad():
            want = live(_x(n, n))
        assert torch.equal(fn(_x(n, n)), want), (backbone, n)


def test_artifact_loads_without_slcl_torch(tmp_path):
    """A consumer with PyTorch alone: neither the repo nor slcl_torch on its
    path; it parses the header and calls ``torch.export.load``."""
    net = _tiny()
    path = _artifact(tmp_path, net)
    x = _x(3)
    np.save(tmp_path / "x.npy", x.numpy())
    code = (
        "import importlib.util, io, json, struct, sys\n"
        "import numpy as np, torch\n"
        "assert importlib.util.find_spec('slcl_torch') is None\n"
        "raw = open('m.slclt', 'rb').read()\n"
        "assert raw[:6] == b'SLCLT\\x01'\n"
        "(n,) = struct.unpack('>I', raw[6:10])\n"
        "meta = json.loads(raw[10:10 + n])\n"
        "prog = torch.export.load(io.BytesIO(raw[10 + n:])).module()\n"
        "with torch.no_grad():\n"
        "    out = prog(torch.from_numpy(np.load('x.npy')))\n"
        "np.save('out.npy', out.numpy())\n"
        "assert not [m for m in sys.modules if m.startswith('slcl')]\n"
        "print(meta['crop'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(CROP)
    with torch.no_grad():
        want = serve.make_infer_fn(net)(x)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want.numpy())


def _flax_and_port():
    """A tiny flax DRUNet with perturbed variables and the port's copy."""
    rng = np.random.default_rng(7)
    model = DRUNet(multilvl=True, dtype=jnp.float32, **SMALL)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3)), False)
    noisy = jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)
                         * 0.1, v["params"])
    stats = jax.tree.map(lambda a: np.abs(np.asarray(a)) + 0.5, v["batch_stats"])
    variables = {"params": noisy, "batch_stats": stats}
    port = TDRUNet(multilvl=True, **SMALL).to(memory_format=torch.channels_last)
    return model, variables, load_flax_weights(port, noisy, stats)


def test_artifact_matches_jax_artifact(tmp_path):
    model, variables, port = _flax_and_port()
    j_serve.save_artifact(tmp_path / "m.slclx", j_serve.export_segmentor(
        model, variables, crop=CROP, with_probs=True, platforms=("cpu",)))
    j_fn, _ = j_serve.load_artifact(tmp_path / "m.slclx")
    fn, _ = serve.load_artifact(_artifact(tmp_path, port, with_probs=True), "cpu")
    for n in (1, 3):
        x = _x(n, 10 + n)
        want_l, want_p = j_fn(jnp.asarray(x.numpy()))
        got_l, got_p = fn(x)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-5)


def _pngs(d: Path):
    d.mkdir()
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(40, 36), (32, 32), (64, 64), (45, 51), (20, 30)]):
        yy, xx = np.mgrid[:h, :w]
        img = (120 + 100 * np.sin(xx / 4.0 + i) * np.cos(yy / 6.0)
               + rng.normal(size=(h, w)) * 10).clip(0, 255).astype(np.uint8)
        cv2.imwrite(str(d / f"slice_{i}.png"), img)


def test_serve_cli_masks_equal_jax(tmp_path, capsys):
    """Five PNGs of several sizes at bs=2 (a ragged last batch)."""
    model, variables, port = _flax_and_port()
    j_serve.save_artifact(tmp_path / "m.slclx", j_serve.export_segmentor(
        model, variables, crop=CROP, platforms=("cpu",)), {"crop": CROP})
    art = _artifact(tmp_path, port)
    _pngs(tmp_path / "in")
    assert j_serve._main([str(tmp_path / "m.slclx"), str(tmp_path / "in"),
                          str(tmp_path / "j"), "bs=2"]) == 0
    assert serve._main([str(art), str(tmp_path / "in"), str(tmp_path / "t"), "bs=2",
                        "--device", "cpu"]) == 0
    assert "served 5 images" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert len(names) == 5 and names == sorted(p.name for p in (tmp_path / "t").glob("*.png"))
    for n in names:
        got = cv2.imread(str(tmp_path / "t" / n), cv2.IMREAD_GRAYSCALE)
        assert set(np.unique(got)) <= {0, 60, 120, 180}
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "j" / n),
                                                      cv2.IMREAD_GRAYSCALE))


def test_serve_cli_refuses_jpeg(tmp_path):
    """The port has no JPEG decoder: a .jpg raises naming the file, before
    anything is served (JAX's CLI reads it through cv2)."""
    art = _artifact(tmp_path, _tiny())
    _pngs(tmp_path / "in")
    cv2.imwrite(str(tmp_path / "in" / "photo.jpg"), np.zeros((32, 32), np.uint8))
    with pytest.raises(ValueError, match="photo.jpg"):
        serve._main([str(art), str(tmp_path / "in"), str(tmp_path / "t"), "--device", "cpu"])
    assert not list((tmp_path / "t").glob("*.png"))
