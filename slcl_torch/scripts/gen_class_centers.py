"""Generate the initial class-centre file of MPSCL/SLCL/MCCL (counterpart
of ``scripts/gen_class_centers.py``).

The file is (C, F) float32 ``.npy``: per-class means of the source-domain
decoder features under a restored (or fresh) segmentor, the same contract
as the JAX script's, so a file either package wrote loads in both.

Usage:
  python -m slcl_torch.scripts.gen_class_centers method=baseline \\
      data.dataset=synthetic run.restore_from=runs/<apdx>/ckpt_best.pt \\
      out=centers.npy [--device cpu]
  python -m slcl_torch.scripts.gen_class_centers method=baseline \\
      data.dataset=mmwhs data.data_dir=/data/mmwhs_raw \\
      run.restore_from=runs/<apdx>/ckpt_best.pt out=centers.npy

Any backbone (``model.backbone``); the file is as wide as its decoder
features. With ``method=mccl`` the features pass through MCCL's projection head: an
AdvEnt checkpoint has none, so the head keeps its fresh init from
``run.seed``, the same init an MCCL run warm-started from that checkpoint
with the same seed starts from.

Runs on CUDA unless ``--device`` names another device.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..data import Loader
from ..train.__main__ import parse_args


def class_centers(trainer) -> np.ndarray:
    """Per-class means of ``trainer``'s eval-mode decoder features over
    ``train_s`` (classes with no pixel stay 0), as (C, F) float32."""
    cfg = trainer.cfg
    ev = trainer.evaluator
    n_class = cfg.model.num_classes
    sums = torch.zeros((n_class, trainer.state.seg.feat_dim), dtype=torch.float32,
                       device=trainer.device)
    counts = torch.zeros((n_class, 1), dtype=torch.float32, device=trainer.device)
    loader = Loader(trainer.datasets["train_s"], cfg.data.eval_bs, shuffle=False,
                    drop_last=False, num_threads=cfg.data.num_workers)
    with ev.eval_mode():
        for img, mask, _names in loader:
            with ev.autocast():
                ft = trainer.state.seg(ev.to_device(img)).dcdr_ft
            f = ft.float().reshape(-1, ft.shape[-1])
            onehot = torch.nn.functional.one_hot(
                ev.to_device(mask.astype(np.int64)).reshape(-1), n_class).float()
            sums += onehot.T @ f
            counts += onehot.sum(dim=0)[:, None]
    return (sums / counts.clamp(min=1.0)).cpu().numpy().astype(np.float32)


def main(argv):
    if any(a in ("--help", "-h", "help") for a in argv):
        print(__doc__)
        return None
    cfg, device, extra = parse_args(argv, "baseline", ("out",))
    out = next((a.split("=", 1)[1] for a in extra if a.startswith("out=")),
               "class_centers.npy")
    from ..train.trainer import Trainer
    trainer = Trainer(cfg, device=device)
    if cfg.run.restore_from:
        trainer.restore_checkpoint(cfg.run.restore_from, params_only=True)
        print(f"restored '{cfg.run.restore_from}'")
    centers = class_centers(trainer)
    np.save(out, centers)
    print(f"wrote {out} shape={centers.shape} norms="
          f"{np.linalg.norm(centers, axis=1).round(3).tolist()}")
    return centers


if __name__ == "__main__":
    main(sys.argv[1:])
