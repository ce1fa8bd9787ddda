"""Eval-only harness: restore a checkpoint and run the test evaluation
(counterpart of ``scripts/evaluate.py``).

Usage:
  python -m slcl_torch.scripts.evaluate method=slcl model.multilvl=true \\
      data.dataset=synthetic run.out_dir=runs run.restore_from=best [--device cpu]
  python -m slcl_torch.scripts.evaluate method=slcl model.multilvl=true \\
      data.dataset=mmwhs data.data_dir=/data/mmwhs_raw run.out_dir=runs \\
      run.restore_from=best

``run.restore_from`` is a tag under ``<run.out_dir>/<apdx>/`` or a
checkpoint path; a restore that fails raises. Prints the per-class table of
``test_t`` and ``valid_t`` and, last, the ``test_t`` results as one JSON
line. Runs on CUDA unless ``--device`` names another device.
"""
from __future__ import annotations

import json
import sys

from ..train.__main__ import parse_args


def main(argv):
    if any(a in ("--help", "-h", "help") for a in argv):
        print(__doc__)
        return None
    cfg, device, _ = parse_args(argv, "baseline")
    from ..train.trainer import Trainer
    trainer = Trainer(cfg, device=device)
    tag = cfg.run.restore_from or "best"
    try:
        trainer.restore_checkpoint(tag, params_only=True)
    except (OSError, KeyError, ValueError, RuntimeError) as e:
        # evaluating random initial weights silently is worse than failing
        raise SystemExit(
            f"checkpoint restore failed for {tag!r}: {e}\n(check run.out_dir/"
            "run.apdx and that method/model flags match the training run)") from e
    print(f"restored checkpoint '{tag}' (weights + BatchNorm buffers)")
    print("--- target test ---")
    results = trainer.eval("test_t", toprint=True)
    print("--- target valid ---")
    trainer.eval("valid_t", toprint=True)
    print(json.dumps({"device": str(trainer.device), "test": results}), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
