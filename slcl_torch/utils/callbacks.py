"""Checkpoint / early-stop callbacks (a copy of
``slcl_tpu/utils/callbacks.py``; reference utils/callbacks.py parity).

``ModelCheckPointCallback`` (reference callbacks.py:45-97): best-on-metric
with min/max mode, always-save-last, periodic ``save_every_epochs``, and the
final rename to ``...e{best_epoch}.Scr{score}`` that the reference's
checkpoint-discovery relies on.

``EarlyStopCallback`` (reference callbacks.py:100-124): dice-plateau early
stopping with patience.

The save function is the caller's (the port's Trainer writes one
``ckpt_<tag>.pt`` per tag); these are usable against any save function.
Under several processes only rank 0 writes the fingerprint.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

from ..parallel.mesh import is_writer


class ModelCheckPointCallback:
    def __init__(self, out_dir: str, save_fn: Callable[[str], None],
                 mode: str = "max", save_every_epochs: int = 0,
                 n_epochs: int = 0, apdx: str = "model"):
        assert mode in ("min", "max")
        self.out_dir = Path(out_dir)
        self.save_fn = save_fn
        self.mode = mode
        self.save_every_epochs = save_every_epochs
        self.n_epochs = n_epochs
        self.apdx = apdx
        self.best_result = -float("inf") if mode == "max" else float("inf")
        self.epoch = -1

    @property
    def wrote_best(self) -> bool:
        """True once THIS run has written ckpt_best (distinguishes it from
        a stale ckpt_best left in a reused out_dir by a previous run)."""
        return self.best_result not in (float("inf"), -float("inf"))

    def _improved(self, monitor: float) -> bool:
        return (monitor > self.best_result if self.mode == "max"
                else monitor < self.best_result)

    def step(self, monitor: float, epoch: int) -> bool:
        """Returns True when a new best checkpoint was written."""
        improved = self._improved(monitor)
        if improved:
            self.best_result = monitor
            self.epoch = epoch
            self.save_fn("best")
        self.save_fn("last")
        # epoch -1 is the pre-training warm-start eval: best/last above are
        # wanted, a periodic "e0" of the untrained init is not
        if (self.save_every_epochs and epoch >= 0
                and (epoch + 1) % self.save_every_epochs == 0):
            self.save_fn(f"e{epoch + 1}")
        if self.n_epochs and epoch + 1 >= self.n_epochs:
            self.finalize()
        return improved

    def finalize(self):
        """Record the epoch+score fingerprint of the best checkpoint
        (reference callbacks.py:86-97 / Trainer_MPSCL.py:409-431 rename the
        dir; here the fingerprint goes to a marker file so the stable
        ``ckpt_best`` path keeps working for restore/resume). Epoch -1 is
        the pre-training warm-start eval (run.init_from): its fingerprint
        is ``e0`` — best model = the untrained init."""
        if self.wrote_best and is_writer():
            marker = self.out_dir / "best_fingerprint.txt"
            marker.write_text(
                f"{self.apdx}.e{self.epoch + 1}.Scr{self.best_result:.4f}\n")


class EarlyStopCallback:
    def __init__(self, patience: int = 0, mode: str = "max"):
        self.patience = patience
        self.mode = mode
        self.best = -float("inf") if mode == "max" else float("inf")
        self.best_epoch = -1

    def step(self, monitor: float, epoch: int) -> bool:
        """Returns True when training should stop."""
        improved = (monitor > self.best if self.mode == "max"
                    else monitor < self.best)
        if improved:
            self.best = monitor
            self.best_epoch = epoch
            return False
        return bool(self.patience) and (epoch - self.best_epoch) >= self.patience
