"""Training state and optimizers (counterpart of ``slcl_tpu/train/state.py``).

The JAX package keeps one immutable PyTree; here the state is the modules
and optimizers themselves, updated in place, plus the EMA class centres,
the step counter and the run's seed. In place of JAX's ``TrainState.rng``
the seed and the step fix every random draw a step makes (MCCL's rMC
partition), so the checkpoint carries no generator state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    seg: nn.Module
    opt_seg: torch.optim.Optimizer
    d_main: Optional[nn.Module] = None
    opt_d_main: Optional[torch.optim.Optimizer] = None
    d_aux: Optional[nn.Module] = None
    opt_d_aux: Optional[torch.optim.Optimizer] = None
    centroids: Optional[torch.Tensor] = None   # (C, F) EMA class centres
    step: int = 0
    seed: int = 0                              # run.seed: the steps' draws


def make_optimizer(name: str, params: Iterable[torch.Tensor], lr: float = 1.0,
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   betas=(0.9, 0.999)) -> torch.optim.Optimizer:
    """SGD/Adam matching ``make_optimizer`` (``state.py:39-71``).

    ``sgd``: ``torch.optim.SGD(momentum, weight_decay)`` is optax's
    ``add_decayed_weights(wd)`` -> ``sgd(lr, momentum)`` from a zero trace
    (buf = m * buf + g + wd * p; p -= lr * buf). ``adam``: Adam with eps
    1e-8, optax's defaults. The LR is set per step with :func:`set_lr`; the
    optimizer is never rebuilt."""
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8)
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def create_train_state(cfg, seg: nn.Module, *, disc: Optional[nn.Module] = None,
                       disc_aux: Optional[nn.Module] = None,
                       centroids: Optional[torch.Tensor] = None) -> TrainState:
    """Optimizers for the segmentor (``cfg.optim``) and each discriminator
    (Adam, betas ``(adv.mmt1, adv.mmt)``), as ``create_train_state`` builds
    them (``state.py:92-125``)."""
    opt_seg = make_optimizer(cfg.optim.optimizer, seg.parameters(), cfg.optim.lr,
                             momentum=cfg.optim.momentum,
                             weight_decay=cfg.optim.weight_decay)
    betas = (cfg.adv.mmt1, cfg.adv.mmt)
    opt_d = (make_optimizer("adam", disc.parameters(), cfg.optim.lr_dis, betas=betas)
             if disc is not None else None)
    opt_da = (make_optimizer("adam", disc_aux.parameters(), cfg.optim.lr_dis, betas=betas)
              if disc_aux is not None else None)
    return TrainState(seg=seg, opt_seg=opt_seg, d_main=disc, opt_d_main=opt_d,
                      d_aux=disc_aux, opt_d_aux=opt_da, centroids=centroids,
                      seed=cfg.run.seed)
