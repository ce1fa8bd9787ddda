"""Training CLI of the port (counterpart of ``scripts/train.py``).

Usage:
  python -m slcl_torch.train method=advent model.multilvl=true \\
      data.dataset=synthetic optim.epochs=30 run.out_dir=runs [--device cpu]
  python -m slcl_torch.train method=mccl data.dataset=synthetic \\
      optim.epochs=30 run.out_dir=runs [--device cpu]
  python -m slcl_torch.train method=slcl model.multilvl=true \\
      data.dataset=mmwhs data.data_dir=/data/mmwhs_raw [data.raw=false]
  python -m slcl_torch.train method=mccl data.dataset=mscmrseg \\
      data.data_dir=/data/mscmrseg
  python -m slcl_torch.train method=slcl model.backbone=resnet50 \\
      model.multilvl=true data.dataset=synthetic
  python -m slcl_torch.train method=adaptseg model.backbone=deeplabv2 \\
      model.multilvl=true model.pretrained=true \\
      model.pretrained_ckpt=/weights/resnet101.pth data.dataset=synthetic

``method`` is one of baseline, adaptseg, advent, mpscl, slcl and mccl;
``model.backbone`` one of drunet (default), unet, deeplabv2 (alias
resnet101) and resnet50 (alias resnet50_unet). The contrastive methods
need ``model.filters`` equal to the backbone's feature width (UNet's 64;
the ResNet-50 U-Net projects to ``model.filters``; DeepLabV2's 2048 is
not ported for them). With
``model.pretrained=true`` the ResNet encoder comes from the local file
``model.pretrained_ckpt`` (a missing file raises). ``data.dataset``
is ``mmwhs`` (CT -> MR; the raw per-slice NIfTI tree with its minmax CSVs,
or with ``data.raw=false`` the preprocessed PNG tree), ``mscmrseg`` (bSSFP
-> LGE PNGs) or ``synthetic``; ``data.rev=true`` swaps the domains.

Recipe presets are applied first (``apply_recipe``), then the
``section.key=value`` overrides. Runs ``Trainer.train()`` on CUDA unless
``--device`` names another device: checkpoints, ``log.jsonl`` and
``summary.json`` go to ``<run.out_dir>/<apdx>/``. Prints the summary, with
the device and that directory, as one JSON line last.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional, Tuple

from ..config import Config, apply_recipe


def parse_args(argv, default_method: str, extra_keys: Tuple[str, ...] = ()
               ) -> Tuple[Config, Optional[str], List[str]]:
    """(config, device, the ``key=value`` arguments whose key is one of
    ``extra_keys``) from a CLI's arguments; ``--device`` and ``--help`` are read here.
    The recipe of ``method=`` is applied before the overrides, as every
    entry point must (presets change the parameter tree)."""
    argv = list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    extra = [a for a in argv if a.split("=", 1)[0] in extra_keys]
    argv = [a for a in argv if a not in extra]
    method = next((a.split("=", 1)[1] for a in argv if a.startswith("method=")),
                  default_method)
    cfg = Config()
    cfg.method = method
    cfg = apply_recipe(cfg)
    cfg = Config.from_cli(argv, base=cfg)
    cfg.method = method
    return cfg, device, extra


def main(argv):
    if any(a in ("--help", "-h", "help") for a in argv):
        print(__doc__)
        return {}
    cfg, device, _ = parse_args(argv, "slcl")
    from .trainer import Trainer
    trainer = Trainer(cfg, device=device)
    result = {"device": str(trainer.device), "out_dir": str(trainer.out_dir),
              **trainer.train()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
