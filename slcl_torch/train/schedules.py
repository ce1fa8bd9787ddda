"""LR schedules (reference utils/lr_adjust.py + Trainer_*.adjust_lr).

A copy of ``slcl_tpu/train/schedules.py`` (plain Python): the port keeps
its own so it imports nothing of ``slcl_tpu``.

Epoch-granular, like the reference (adjust_lr called once per epoch,
Trainer_AdaptSeg.py:119-127).
"""
from __future__ import annotations


def poly_lr(base_lr: float, epoch: int, total_epochs: int, power: float = 0.9) -> float:
    """``lr = base * (1 - epoch/total)**power`` (reference lr_adjust.py:1-17)."""
    frac = min(max(epoch / max(total_epochs, 1), 0.0), 1.0)
    return base_lr * (1.0 - frac) ** power


def linear_lr(base_lr: float, epoch: int, lr_decay: float = 2e-3) -> float:
    """Reference 'linear' = inverse-time decay ``lr / (1 + decay*epoch)``
    (lr_adjust.py:20-25 adjust_learning_rate_custom; default decay
    LEARNING_RATE_DECAY=2e-3, reference config.py:16)."""
    return base_lr / (1.0 + lr_decay * epoch)


def constant_lr(base_lr: float, epoch: int, total_epochs: int) -> float:
    return base_lr


def get_lr(method, base_lr, epoch, total_epochs, power=0.9, end_lr=0.0,
           lr_decay=2e-3):
    if method in (None, "none", "constant"):
        return base_lr
    if method == "poly":
        # reference lr_adjust.py:8-13: poly on (lr - end_lr) + end_lr
        return poly_lr(base_lr - end_lr, epoch, total_epochs, power) + end_lr
    if method == "linear":
        return linear_lr(base_lr, epoch, lr_decay)
    raise ValueError(f"unknown lr schedule {method!r}")
