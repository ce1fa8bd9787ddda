"""Training state and optimizers (counterpart of ``slcl_tpu/train/state.py``).

The JAX package keeps one immutable PyTree; here the state is the modules
and optimizers themselves, updated in place, plus the EMA class centres,
the step counter and the run's seed. In place of JAX's ``TrainState.rng``
the seed and the step fix every random draw a step makes (MCCL's rMC
partition, RAIN's noise), so the checkpoint carries no generator state.
With RAIN (``rain.enabled``, ``method=rain``) the state also holds the
frozen style net (``extra["rain"]`` in JAX's state: no gradient, in no
optimizer) and the carried epsilon ``sampling``. The discriminators that
JAX keeps in ``extra`` have fields of their own, each with its Adam:
``d_seg`` (DDFSeg), ``d_ent`` and ``d_point`` (AdaptEvery).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

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
    rain: Optional[nn.Module] = None           # the frozen RAIN net
    sampling: Optional[torch.Tensor] = None    # (n_sty, 512) float32
    d_seg: Optional[nn.Module] = None          # DDFSeg's prediction PatchGAN
    opt_d_seg: Optional[torch.optim.Optimizer] = None
    d_ent: Optional[nn.Module] = None          # AdaptEvery's entropy-map D
    opt_d_ent: Optional[torch.optim.Optimizer] = None
    d_point: Optional[nn.Module] = None        # AdaptEvery's PointNet D
    opt_d_point: Optional[torch.optim.Optimizer] = None


# top-level submodules trained at 10x the base LR on the DeepLab backbones:
# the ASPP classifier heads (``slcl_tpu/train/state.py:102-109``; reference
# deeplabv2.py optim_parameters, lr_adjust.py:15-16)
LR10_MODULES = ("layer5", "layer6")


def param_groups(seg: nn.Module, backbone: str) -> List[dict]:
    """The segmentor's parameter groups: one at the base LR, and for
    ``deeplabv2`` (as in the JAX package, not its ``resnet101`` alias) the
    classifier heads apart with ``lr_mult`` 10."""
    if backbone.lower() != "deeplabv2":
        return [{"params": list(seg.parameters()), "lr_mult": 1.0}]
    head, rest = [], []
    for name, p in seg.named_parameters():
        (head if name.split(".", 1)[0] in LR10_MODULES else rest).append(p)
    return [{"params": rest, "lr_mult": 1.0}, {"params": head, "lr_mult": 10.0}]


def make_optimizer(name: str, params: Iterable, lr: float = 1.0,
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   betas=(0.9, 0.999)) -> torch.optim.Optimizer:
    """SGD/Adam matching ``make_optimizer`` (``state.py:39-71``).

    ``sgd``: ``torch.optim.SGD(momentum, weight_decay)`` is optax's
    ``add_decayed_weights(wd)`` -> ``sgd(lr, momentum)`` from a zero trace
    (buf = m * buf + g + wd * p; p -= lr * buf). ``adam``: Adam with eps
    1e-8, optax's defaults. ``params``: tensors, or groups as
    :func:`param_groups` makes them; a group's ``lr_mult`` (default 1)
    scales the whole update, decay included, as JAX's masked
    ``optax.scale(10)`` after the update does. The LR is set per step with
    :func:`set_lr`; the optimizer is never rebuilt."""
    params = list(params)
    if not params or not isinstance(params[0], dict):
        params = [{"params": params}]
    groups = [{**g, "lr_mult": g.get("lr_mult", 1.0),
               "lr": lr * g.get("lr_mult", 1.0)} for g in params]
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                               weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=tuple(betas), eps=1e-8)
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Each group's LR is ``lr`` times its ``lr_mult``, which the
    optimizer's ``state_dict`` carries, so a restored checkpoint keeps it."""
    for group in opt.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)


def create_train_state(cfg, seg: nn.Module, *, disc: Optional[nn.Module] = None,
                       disc_aux: Optional[nn.Module] = None,
                       centroids: Optional[torch.Tensor] = None) -> TrainState:
    """Optimizers for the segmentor (``cfg.optim``; the DeepLab heads'
    10x group) and each discriminator (Adam, betas ``(adv.mmt1, adv.mmt)``),
    as ``create_train_state`` builds them (``state.py:92-125``)."""
    opt_seg = make_optimizer(cfg.optim.optimizer, param_groups(seg, cfg.model.backbone),
                             cfg.optim.lr,
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


def rain_sampling_rows(cfg) -> int:
    """Rows of the carried sampling: one per stylised image, ``data.bs``
    under ``mulstyle`` (whole-batch styles) and 1 otherwise, ``mulstyle2``
    winning (``slcl_tpu/train/trainer.py:219-226``)."""
    return cfg.data.bs if (cfg.rain.mulstyle and not cfg.rain.mulstyle2) else 1


def create_pretrain_rain_state(cfg, rain: nn.Module) -> TrainState:
    """``pretrain_rain``'s state: the RAIN net is the trained network, Adam
    at ``optim.lr`` over its decoder and fc nets. Its encoder is frozen:
    JAX zeroes the encoder's gradients, so its Adam moments and updates stay
    zero, which is what leaving it out of the optimizer gives."""
    rain.encoder.requires_grad_(False)
    params = [p for p in rain.parameters() if p.requires_grad]
    return TrainState(seg=rain, opt_seg=make_optimizer("adam", params, cfg.optim.lr),
                      seed=cfg.run.seed)
