"""Training CLI of the port (counterpart of ``scripts/train.py``).

Usage:
  python -m slcl_torch.train method=slcl model.multilvl=true \\
      data.dataset=synthetic optim.epochs=1 [--device cpu]

Recipe presets are applied first (``apply_recipe``), then the
``section.key=value`` overrides. Runs on CUDA unless ``--device`` names
another device. Prints one JSON line of mean metrics per epoch.
"""
from __future__ import annotations

import json
import sys

from ..config import Config, apply_recipe


def main(argv):
    argv = list(argv)
    if any(a in ("--help", "-h", "help") for a in argv):
        print(__doc__)
        return {}
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    method = next((a.split("=", 1)[1] for a in argv if a.startswith("method=")),
                  "slcl")
    cfg = Config()
    cfg.method = method
    cfg = apply_recipe(cfg)
    cfg = Config.from_cli(argv, base=cfg)
    cfg.method = method

    from .trainer import Trainer
    trainer = Trainer(cfg, device=device)
    means = trainer.train()
    for record in trainer.history:
        print(json.dumps({"device": str(trainer.device), **record}), flush=True)
    return means


if __name__ == "__main__":
    main(sys.argv[1:])
