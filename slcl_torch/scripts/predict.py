"""Batched inference: segment the test split and write its masks
(counterpart of ``scripts/predict.py``).

Restores a checkpoint, runs ``Evaluator.predict`` over ``test_t`` and
writes ``<name>_pred.png`` (class id x 60) under ``out_dir``. When the
split has ground truth it prints the per-class Dice / HD95 / ASSD table
(``run.klc`` as the evaluator applies it) and, last, the results as one
JSON line.

Usage:
  python -m slcl_torch.scripts.predict method=slcl model.multilvl=true \\
      data.dataset=synthetic run.restore_from=runs/<apdx>/ckpt_best.pt \\
      out_dir=preds [--device cpu]
  python -m slcl_torch.scripts.predict method=slcl data.dataset=mmwhs \\
      data.data_dir=/data/mmwhs_raw run.restore_from=... out_dir=preds

Runs on CUDA unless ``--device`` names another device.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from ..train.__main__ import parse_args


def main(argv):
    if any(a in ("--help", "-h", "help") for a in argv):
        print(__doc__)
        return None
    cfg, device, extra = parse_args(argv, "baseline", ("out_dir",))
    out = Path(next((a.split("=", 1)[1] for a in extra), "preds"))

    from ..data import Loader
    from ..data.png import write_png_gray
    from ..eval.evaluator import evaluate_arrays
    from ..train.trainer import Trainer
    from ..utils.tables import results_to_markdown
    trainer = Trainer(cfg, device=device)
    if cfg.run.restore_from:
        trainer.restore_checkpoint(cfg.run.restore_from, params_only=True)
        print(f"restored '{cfg.run.restore_from}'")

    out.mkdir(parents=True, exist_ok=True)
    test = trainer.datasets["test_t"]
    loader = Loader(test, cfg.data.eval_bs, shuffle=False, drop_last=False,
                    num_threads=cfg.data.num_workers)
    t0 = time.perf_counter()
    preds, gts = trainer.evaluator.predict(loader)
    dt = time.perf_counter() - t0
    print(f"inference: {len(preds)} slices in {dt:.2f}s "
          f"({len(preds) / dt:.1f} img/s incl. host IO)")

    names_loader = Loader(test, cfg.data.eval_bs, shuffle=False, drop_last=False,
                          num_threads=1)
    names = [n for batch in names_loader for n in batch[-1]]
    for name, p in zip(names, preds):
        write_png_gray(out / f"{Path(str(name)).stem}_pred.png", (p * 60).astype(np.uint8))
    print(f"wrote {len(preds)} masks to {out}")

    results = None
    if gts is not None and np.any(gts):
        results = evaluate_arrays(preds, gts, klc=cfg.run.klc,
                                  num_classes=cfg.model.num_classes)
        print(results_to_markdown(results))
    print(json.dumps({"device": str(trainer.device), "n": int(len(preds)),
                      "test": results}), flush=True)
    return preds, results


if __name__ == "__main__":
    main(sys.argv[1:])
