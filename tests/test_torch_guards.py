"""Guards of the port: it imports nothing of JAX or ``slcl_tpu`` (the
``scripts`` entry points included), it never falls back to the CPU on its
own, and its CLI trains, validates and tests on the CPU when asked.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slcl_torch import resolve_device
from slcl_torch.config import Config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))


def test_port_imports_no_jax_and_no_slcl_tpu(tmp_path):
    """Every module of the port imported, one augmented sample of each
    aug_mode (and a counter pair) drawn from each fixture tree, and
    ``chip_smoke.py``'s trees written: no JAX, no ``slcl_tpu``, and none of
    OpenCV, pandas and PIL, which the card's host does not have."""
    code = (
        "import importlib, pathlib, pkgutil, sys, slcl_torch, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages(slcl_torch.__path__, 'slcl_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"chip_smoke.write_trees(pathlib.Path({str(tmp_path)!r}), slices=1)\n"
        "from slcl_torch.data.mmwhs import MMWHSRawDataset, MMWHSPngDataset\n"
        "from slcl_torch.data.mscmrseg import MSCMRSegDataset\n"
        f"fix = {str(ROOT / 'tests' / 'fixtures')!r}\n"
        "for mode in ('simple', 'heavy', 'heavy2'):\n"
        "    for counter in (False, True):\n"
        "        kw = dict(domain='t', augmentation=True, aug_mode=mode, aug_counter=counter)\n"
        "        for ds in (MMWHSRawDataset(fix + '/mini_mmwhs', 'mr', **kw),\n"
        "                   MMWHSPngDataset(fix + '/mini_mmwhs_png', 'mr', **kw),\n"
        "                   MSCMRSegDataset(fix + '/mini_mscmrseg', 'lge', **kw)):\n"
        "            for i in range(len(ds)): ds[i]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'slcl_tpu', 'cv2', 'pandas', 'PIL'))\n"
        "assert not bad, bad\n"
        "assert {'slcl_torch.scripts.gen_class_centers', 'slcl_torch.scripts.evaluate',\n"
        "        'slcl_torch.eval.evaluator', 'slcl_torch.ops.metrics',\n"
        "        'slcl_torch.utils.callbacks', 'slcl_torch.ops.cuda.mpcl_pseudo',\n"
        "        'slcl_torch.data.mmwhs', 'slcl_torch.data.mscmrseg', 'slcl_torch.data.png',\n"
        "        'slcl_torch.data.imgproc', 'slcl_torch.data.slic'} <= set(mods)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_trainer_without_device_raises_when_no_cuda():
    from slcl_torch.train.trainer import Trainer
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = Config()
    cfg.method = "slcl"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_on_cpu_run_the_plain_version_only():
    """The CUDA launch raises for CPU tensors; the dispatching wrapper
    never reaches it for them."""
    from slcl_torch.ops.cuda import KERNELS, launch_counts, reset_launch_counts
    from slcl_torch.ops.cuda.pseudo_label import pseudo_label, pseudo_label_cuda
    feats = torch.randn(64, 32)
    centers = torch.randn(4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        pseudo_label_cuda(feats, centers)
    reset_launch_counts()
    pseudo_label(feats, centers)
    assert set(KERNELS) == {"mpcl_fwd", "mpcl_bwd", "mpcl_pseudo_fwd", "mpcl_pseudo_bwd",
                            "pseudo_label", "soft_centroids_fwd", "soft_centroids_bwd",
                            "soft_centroids_fwd_std", "soft_centroids_bwd_std"}
    assert all(v == 0 for v in launch_counts().values())


def test_cli_trains_one_epoch_on_cpu(tmp_path):
    args = [sys.executable, "-m", "slcl_torch.train", "method=slcl",
            "model.multilvl=true", "data.dataset=synthetic", "optim.epochs=1",
            "data.bs=2", "data.crop=32", "model.filters=8", "model.n_block=2",
            "model.bottleneck_depth=2", "model.dtype=float32", "data.num_workers=1",
            f"run.out_dir={tmp_path}", "--device", "cpu"]
    out = subprocess.run(args, cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and Path(rec["out_dir"]).parent == tmp_path
    (epoch,) = rec["history"]
    assert epoch["epoch"] == 0 and 0.0 <= epoch["val_dice"] <= 1.0
    for k in ("seg_s", "loss_mpscl_tr", "loss_mpscl_tg", "loss_cnr", "loss_adv",
              "loss_adv_aux", "loss_dis", "loss_dis_aux"):
        assert k in epoch and epoch[k] == epoch[k] and abs(epoch[k]) < float("inf"), k
    assert len(rec["test"]["dc"]) == 6 and len(rec["test"]["hd"]) == 6
    for name in ("ckpt_best.pt", "ckpt_last.pt", "log.jsonl", "summary.json"):
        assert (Path(rec["out_dir"]) / name).is_file(), name


@pytest.mark.parametrize("method,dataset,tree", [
    ("slcl", "mmwhs", "mini_mmwhs"), ("mccl", "mscmrseg", "mini_mscmrseg")])
def test_cli_trains_one_epoch_on_real_format_trees(tmp_path, method, dataset, tree):
    """``slcl`` on the raw NIfTI MMWHS tree (CT -> MR), ``mccl`` on the
    MS-CMRSeg PNG tree (bSSFP -> LGE, counter pairs): one epoch, validation,
    the final test on both domains, checkpoints."""
    args = [sys.executable, "-m", "slcl_torch.train", f"method={method}",
            f"data.dataset={dataset}", f"data.data_dir={ROOT / 'tests' / 'fixtures' / tree}",
            "data.raw=true", "optim.epochs=1", "data.bs=2", "data.eval_bs=4",
            "data.crop=32", "model.filters=8", "model.n_block=2",
            "model.bottleneck_depth=2", "model.dtype=float32", "data.num_workers=2",
            f"model.multilvl={method == 'slcl'}", f"run.out_dir={tmp_path}",
            "--device", "cpu"]
    out = subprocess.run(args, cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and Path(rec["out_dir"]).parent == tmp_path
    (epoch,) = rec["history"]
    assert epoch["epoch"] == 0 and 0.0 <= epoch["val_dice"] <= 1.0
    assert all(v == v and abs(v) < float("inf") for v in epoch.values()
               if isinstance(v, float))
    for split in ("test", "test_s"):
        vals = [v for k in ("dc", "hd", "asd") for v in rec[split][k]]
        assert len(vals) == 18 and all(np.isfinite(vals)), (split, rec[split])
    for name in ("ckpt_best.pt", "ckpt_last.pt", "log.jsonl", "summary.json"):
        assert (Path(rec["out_dir"]) / name).is_file(), name
