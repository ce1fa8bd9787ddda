"""Export a trained segmentor checkpoint to a serving artifact
(counterpart of ``scripts/export.py``).

The artifact (``slcl_torch.serve``'s format: a ``torch.export`` program,
weights included, symbolic batch) loads with PyTorch alone, no model code.
It is exported on the device it will serve on, in ``model.dtype``.

Usage:
  python -m slcl_torch.scripts.export method=mccl \\
      run.restore_from=runs/<apdx>/ckpt_best.pt out=model.slclt
  python -m slcl_torch.scripts.export method=slcl model.multilvl=true \\
      run.restore_from=... out=m.slclt smoke=1 [--device cpu]

``out`` defaults to ``model.slclt``; ``smoke=1`` reloads the artifact and
checks it against the live model (labels equal at >= 99.9% of pixels, as
the JAX script requires). Without ``run.restore_from`` it exports the
fresh initialisation, with a warning. Runs on CUDA unless ``--device``
names another device.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ..train.__main__ import parse_args


def main(argv):
    if any(a in ("--help", "-h", "help") for a in argv):
        print(__doc__)
        return None
    cfg, device, extra = parse_args(argv, "baseline", ("out", "smoke"))
    opts = dict(a.split("=", 1) for a in extra)
    out = opts.get("out", "model.slclt")
    smoke = opts.get("smoke", "0") not in ("0", "", "false")

    from .. import serve
    from ..data import SyntheticCardiacDataset as S
    from ..train.trainer import Trainer
    # tiny placeholder datasets: restore and export read no data, and the
    # CLI works where the training dataset is absent
    crop = cfg.data.crop
    tiny = {k: S(2, crop, "mr", i) for i, k in
            enumerate(("train_s", "train_t", "valid_t", "test_t"))}
    trainer = Trainer(cfg, datasets=tiny, device=device)
    if trainer.evaluator is None:
        raise SystemExit(f"method {cfg.method!r} trains no segmentor to export")
    if cfg.run.restore_from:
        trainer.restore_checkpoint(cfg.run.restore_from, params_only=True)
        print(f"restored '{cfg.run.restore_from}'")
    else:
        print("WARNING: no run.restore_from — exporting the fresh "
              "initialization (integration-test mode)")
    model = trainer.evaluator.model
    exported = serve.export_segmentor(model, crop=crop, in_channels=cfg.model.in_channels,
                                      dtype=cfg.model.dtype)
    meta = {"method": cfg.method, "backbone": cfg.model.backbone,
            "crop": crop, "num_classes": cfg.model.num_classes,
            "restored_from": str(cfg.run.restore_from or ""),
            "output": "int32 argmax label map (N, crop, crop)"}
    serve.save_artifact(out, exported, meta, dtype=cfg.model.dtype)
    size_mb = Path(out).stat().st_size / 1e6
    print(f"wrote {out} ({size_mb:.1f} MB, device {trainer.device.type}, "
          f"{cfg.model.dtype}, input {crop}x{crop})")

    if smoke:
        fn, meta2 = serve.load_artifact(out, trainer.device)
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(2, crop, crop, cfg.model.in_channels)).astype(np.float32)).to(trainer.device)
        got = fn(x)
        with torch.no_grad():
            live = serve.make_infer_fn(model, dtype=cfg.model.dtype)(x)
        if tuple(got.shape) != (2, crop, crop):
            raise RuntimeError(f"artifact output shape {tuple(got.shape)}")
        agree = (got == live).float().mean().item()
        if agree <= 0.999:
            raise RuntimeError(f"artifact != live model: labels agree at {agree:.6f}")
        print(f"smoke ok: artifact matches the live model at {agree:.6f} of pixels "
              f"(meta: {meta2['method']}/{meta2['backbone']})")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
