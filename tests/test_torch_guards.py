"""Guards of the port: it imports nothing of JAX or ``slcl_tpu`` (the
``scripts`` entry points included), it never falls back to the CPU on its
own, it refuses the config keys it would otherwise ignore, and its CLI
trains, validates and tests on the CPU when asked (``baseline`` on MMWHS
also the other fold, as the JAX package does).
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
        "        'slcl_torch.data.imgproc', 'slcl_torch.data.slic',\n"
        "        'slcl_torch.models.resnet_unet', 'slcl_torch.models.deeplabv2',\n"
        "        'slcl_torch.models.unet', 'slcl_torch.utils.pretrained',\n"
        "        'slcl_torch.models.rain', 'slcl_torch.train.steps_rain',\n"
        "        'slcl_torch.scripts.stylize_samples', 'slcl_torch.models.ddfseg',\n"
        "        'slcl_torch.models.pointnet', 'slcl_torch.train.steps_extra',\n"
        "        'slcl_torch.serve', 'slcl_torch.scripts.export', 'slcl_torch.scripts.predict',\n"
        "        'slcl_torch.data.legacy', 'slcl_torch.data.preprocess',\n"
        "        'slcl_torch.utils.tables', 'slcl_torch.utils.timer',\n"
        "        'slcl_torch.utils.tb', 'slcl_torch.parallel', 'slcl_torch.parallel.mesh',\n"
        "        'slcl_torch.parallel.dryrun'} <= set(mods)\n"
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
    templated = {"mpcl_fwd", "mpcl_bwd", "mpcl_pseudo_fwd", "mpcl_pseudo_bwd",
                 "pseudo_label", "soft_centroids_fwd", "soft_centroids_bwd",
                 "soft_centroids_fwd_std", "soft_centroids_bwd_std"}
    # each with its general (runtime-shape) counterpart
    assert set(KERNELS) == templated | {k + "_general" for k in templated}
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


def test_cli_trains_adaptseg_on_deeplabv2_one_epoch_on_cpu(tmp_path):
    """AdaptSeg on the full-depth DeepLabV2 (frozen BN, multi-level, the 10x
    head group) through the CLI at 32x32: one epoch, validation, test,
    checkpoints; the checkpoint restores the full state, the optimizer's
    two groups with their LR ratio included."""
    args = [sys.executable, "-m", "slcl_torch.train", "method=adaptseg",
            "model.backbone=deeplabv2", "model.multilvl=true", "data.dataset=synthetic",
            "optim.epochs=1", "data.bs=2", "data.eval_bs=2", "data.crop=32",
            "model.dtype=float32", "data.num_workers=1", f"run.out_dir={tmp_path}",
            "--device", "cpu"]
    out = subprocess.run(args, cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    (epoch,) = rec["history"]
    for k in ("seg_s", "seg_s_aux", "loss_adv", "loss_adv_aux", "loss_dis", "loss_dis_aux"):
        assert k in epoch and np.isfinite(epoch[k]), k
    assert len(rec["test"]["dc"]) == 6
    from slcl_torch.train.__main__ import parse_args
    from slcl_torch.train.trainer import Trainer
    cfg, _, _ = parse_args(args[3:-2], "adaptseg")
    trainer = Trainer(cfg, device="cpu")
    trainer.restore_checkpoint(str(Path(rec["out_dir"]) / "ckpt_last.pt"))
    groups = trainer.state.opt_seg.param_groups
    assert [g["lr_mult"] for g in groups] == [1.0, 10.0]
    assert groups[1]["lr"] == pytest.approx(10 * groups[0]["lr"])
    assert len(groups[1]["params"]) == 16           # layer5 and layer6: 8 convs each
    assert trainer.state.step == 8


@pytest.mark.parametrize("backbone,width", [("unet", 64), ("deeplabv2", 2048)])
def test_contrastive_method_on_a_wider_backbone_raises(backbone, width):
    """dcdr_ft wider than model.filters (32) fails at the build, naming both;
    UNet at model.filters=64 builds."""
    from slcl_torch.train.trainer import Trainer
    cfg = Config()
    cfg.method = "slcl"
    cfg.model.backbone = backbone
    cfg.data.dataset, cfg.data.bs, cfg.data.crop = "synthetic", 2, 32
    with pytest.raises(ValueError, match=f"{width} wide.*model.filters=32"):
        Trainer(cfg, device="cpu")
    if backbone == "unet":
        cfg.model.filters = 64
        assert Trainer(cfg, device="cpu").state.centroids.shape == (4, 64)


@pytest.mark.parametrize("key,value,raises", [
    ("run.scan_steps", "4", False), ("model.remat", "dots", False),
    ("run.profile_dir", "prof", False), ("model.remat", "false", False),
    # refused until the ascent's backward kept dots' saved outputs; the id
    # of that time kept
    pytest.param("model.remat", "dots method=mccl rain.enabled=true", False,
                 id="model.remat-dots method=mccl rain.enabled=true-True")])
def test_config_keys_the_port_ignores_raise(tmp_path, key, value, raises):
    """The port honours every key the JAX package does: ``run.scan_steps``
    builds and runs one group of K steps through the multi-step runner
    (uncaptured on the CPU), ``model.remat`` (any mode, ``dots`` under MCCL
    + RAIN too) and ``run.profile_dir`` build. What it refuses raises at
    construction, naming the key."""
    from slcl_torch.data import to_device
    from slcl_torch.train.trainer import Trainer
    value, *more = value.split()
    cfg = Config.from_cli(["method=baseline", "data.dataset=synthetic", "data.crop=32",
                           "data.bs=2", "model.filters=8", "model.n_block=2",
                           "model.bottleneck_depth=2", f"run.out_dir={tmp_path}",
                           f"{key}={value}", *more])
    if raises:
        with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
            Trainer(cfg, device="cpu")
        return
    t = Trainer(cfg, device="cpu")
    if key == "run.scan_steps":
        batches = [to_device(b, t.device) for _, b in zip(range(4), t._epoch_batches())]
        acc, n = t.train_steps(batches, t._sched(0))
        assert n == 4 and t.state.step == 4 and t.multi.eager_steps == 4
        assert all(bool(torch.isfinite(v)) for v in acc.values())


def test_bf16_artifact_refuses_another_device_type(tmp_path):
    """torch.export records the evaluator's autocast region with its device
    type, so a bf16 artifact exported on the CPU must not be moved to CUDA
    (its regions would run in float32 there): ``load_artifact`` raises
    before loading, and serves it on its own device type."""
    from slcl_torch import serve
    from slcl_torch.models import build_segmentor
    cfg = Config.from_cli(["model.filters=8", "model.n_block=2", "model.bottleneck_depth=2"])
    net = build_segmentor(cfg.model, generator=torch.Generator().manual_seed(0))
    path = tmp_path / "bf16.slclt"
    serve.save_artifact(path, serve.export_segmentor(net, crop=32, dtype="bfloat16"),
                        {"crop": 32}, dtype="bfloat16")
    with pytest.raises(ValueError, match="bfloat16 autocast.*cannot serve on cuda"):
        serve.load_artifact(path, "cuda")
    fn, meta = serve.load_artifact(path, "cpu")
    assert meta["device"] == "cpu" and meta["dtype"] == "bfloat16"
    assert fn(torch.zeros(1, 32, 32, 3)).shape == (1, 32, 32)


def test_adaptevery_on_the_raw_mmwhs_tree_raises(tmp_path):
    """AdaptEvery needs the vertices of the PNG tree: on the raw NIfTI tree
    (no ``vert{MOD}/`` files) the build raises, as the JAX package's does."""
    from slcl_torch.train.trainer import Trainer
    cfg = Config.from_cli(["method=adaptevery", "data.dataset=mmwhs", "data.raw=true",
                           f"data.data_dir={ROOT / 'tests' / 'fixtures' / 'mini_mmwhs'}",
                           f"run.out_dir={tmp_path}"])
    with pytest.raises(ValueError, match="data.vert requires the preprocessed-PNG"):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("side,ok", [(16, False), (23, False), (24, True)])
def test_patchgan_on_an_input_too_small_for_its_head_raises(side, ok):
    """Below 24 px the PatchGAN's head keeps no pixel: it raises (JAX
    asserts) rather than return an empty map whose mean is NaN."""
    from slcl_torch.models.discriminators import PatchGAN
    x = torch.zeros(1, side, side, 1)
    if ok:
        assert tuple(PatchGAN(1, aux=True)(x)[1].shape) == (1, 1, 1, 1)
        return
    with pytest.raises(ValueError, match="PatchGAN input too small"):
        PatchGAN(1)(x)


def _mmwhs_both_folds(tmp_path) -> Path:
    """The fixture's raw MMWHS tree plus MR patient 2 (a copy of patient 1),
    whom split 0 puts in fold 1's test set: both folds then have a test."""
    import shutil
    tree = tmp_path / "mmwhs"
    shutil.copytree(ROOT / "tests" / "fixtures" / "mini_mmwhs", tree)
    gt = tree / "MR_withGT"
    for f in sorted(gt.glob("*1_*slice*.nii")):
        if f.name.startswith(("img1_", "lab1_")):
            shutil.copy(f, gt / f.name.replace("1_", "2_", 1))
    with open(tree / "MRminmax99.csv", "a") as f:
        f.write("img2,420.87,1313.0\n")
    return tree


@pytest.mark.parametrize("both_folds", [True, False])
def test_baseline_tests_the_other_mmwhs_fold_as_jax(tmp_path, both_folds):
    """``baseline`` on MMWHS writes ``test_t_other_fold`` as the JAX
    package's trainer does: the other fold's test with the final weights
    (the port's from the JAX run's weights, dc/hd/asd within 1e-4), or None
    with the note "other-fold eval skipped" when that fold has no test
    files (the fixture tree). The port's CLI epoch writes the same entry."""
    from slcl_torch.config import Config as TConfig
    from slcl_torch.train.trainer import Trainer
    from slcl_torch.utils.convert import load_flax_weights
    from slcl_tpu.config import Config as JConfig
    from slcl_tpu.train.trainer import Trainer as JTrainer

    tree = _mmwhs_both_folds(tmp_path) if both_folds else ROOT / "tests" / "fixtures" / \
        "mini_mmwhs"
    over = ["method=baseline", "data.dataset=mmwhs", f"data.data_dir={tree}", "data.raw=true",
            "optim.epochs=1", "data.bs=2", "data.eval_bs=4", "data.crop=32",
            "model.filters=8", "model.n_block=2", "model.bottleneck_depth=2",
            "model.dtype=float32", "data.num_workers=1"]
    out = subprocess.run([sys.executable, "-m", "slcl_torch.train", *over,
                          f"run.out_dir={tmp_path / 'port'}", "--device", "cpu"],
                         cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec == json.loads((Path(rec["out_dir"]) / "summary.json").read_text()) | {
        "device": "cpu", "out_dir": rec["out_dir"]}

    jcfg = JConfig.from_cli([*over, f"run.out_dir={tmp_path / 'jax'}"])
    jt = JTrainer(jcfg)
    want = jt.train()["test_t_other_fold"]
    if not both_folds:
        assert want is None and rec["test_t_other_fold"] is None
        assert "other-fold eval skipped" in out.stdout
        return
    for r in (want, rec["test_t_other_fold"]):
        assert len(r["dc"]) == 6 and np.isfinite(r["dc"]).all()
    # the port's branch on the JAX run's final weights
    t = Trainer(TConfig.from_cli([*over, f"run.out_dir={tmp_path / 'port2'}"]), device="cpu")
    load_flax_weights(t.state.seg, jax_tree(jt.state.seg.params),
                      jax_tree(jt.state.seg.batch_stats))
    got = t.test_other_fold()
    for k in ("dc", "hd", "asd"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def jax_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)
