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

from dataclasses import dataclass, fields
from typing import Dict, Iterable, List, Optional

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
    :func:`set_lr`; the optimizer is never rebuilt. On CUDA it takes the
    form a CUDA graph can replay (:func:`capturable`) for every step, so a
    replayed step (``run.scan_steps``) is the eager step's arithmetic."""
    params = list(params)
    if not params or not isinstance(params[0], dict):
        params = [{"params": params}]
    groups = [{**g, "lr_mult": g.get("lr_mult", 1.0),
               "lr": lr * g.get("lr_mult", 1.0)} for g in params]
    if name == "sgd":
        opt = torch.optim.SGD(groups, lr=lr, momentum=momentum, weight_decay=weight_decay)
    elif name == "adam":
        opt = torch.optim.Adam(groups, lr=lr, betas=tuple(betas), eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if any(p.is_cuda for g in groups for p in g["params"]):
        capturable(opt)
    return opt


def capturable(opt: torch.optim.Optimizer) -> None:
    """Put ``opt`` (its parameters on CUDA) in the form a CUDA graph can
    replay: each group's LR a 0-d float32 tensor on the parameters' device
    (:func:`set_lr` fills it in place), Adam ``capturable`` (its step
    counters on the device and its bias corrections computed there), SGD
    ``fused`` (its foreach update reads a tensor LR back to the host).
    Idempotent; a restored optimizer (``load_state_dict`` takes the
    checkpoint's plain form, :func:`plain_optimizer_state`) takes it again."""
    device = opt.param_groups[0]["params"][0].device
    for group in opt.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32,
                                       device=device)
        if isinstance(opt, torch.optim.Adam):
            group["capturable"] = True
        elif isinstance(opt, torch.optim.SGD):
            group["fused"], group["foreach"] = True, False
        else:
            raise NotImplementedError(f"no capturable form of {type(opt).__name__}")
    for st in opt.state.values():
        if "step" in st and st["step"].device != device:
            st["step"] = st["step"].to(device, torch.float32)
    # eager steps run the capturable form too, knowingly: no warning
    opt._warned_capturable_if_run_uncaptured = True


def plain_form(opt: torch.optim.Optimizer) -> None:
    """The inverse of :func:`capturable` on an optimizer that holds no state
    yet: float LRs, Adam not capturable, SGD not fused. FSDP's sharded
    parameters take it, as before the capturable forms (they are never
    captured: ``run.scan_steps`` runs eagerly on several processes)."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
        if group.get("capturable"):
            group["capturable"] = False
        if group.get("fused"):
            group["fused"], group["foreach"] = None, None


def plain_optimizer_state(sd: dict) -> dict:
    """An optimizer ``state_dict`` in the plain optimizer's form: float LRs,
    Adam not capturable, SGD not fused, step counters on the host; a new
    dict (the optimizer's own state is untouched). A checkpoint so loads on
    any device."""
    groups = []
    for g in sd["param_groups"]:
        g = dict(g)
        if isinstance(g["lr"], torch.Tensor):
            g["lr"] = float(g["lr"])
        if g.get("capturable"):
            g["capturable"] = False
        if g.get("fused"):
            g["fused"], g["foreach"] = None, None
        groups.append(g)
    state = {i: {k: (v.cpu() if k == "step" else v) for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {**sd, "param_groups": groups, "state": state}


def set_lr(opt: torch.optim.Optimizer, lr: Optional[float]) -> None:
    """Each group's LR is ``lr`` times its ``lr_mult``, which the
    optimizer's ``state_dict`` carries, so a restored checkpoint keeps it.
    A group whose LR is a 0-d device tensor (:func:`capturable`) is filled
    in place, so that a captured step reads the new value; ``None``
    leaves every LR as it is (the multi-step runner sets them before each
    step, outside the captured graph)."""
    if lr is None:
        return
    for group in opt.param_groups:
        value = lr * group.get("lr_mult", 1.0)
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(value)
        else:
            group["lr"] = value


def optimizers(state: "TrainState") -> Dict[str, torch.optim.Optimizer]:
    """The state's optimizers by field name (``opt_seg`` first)."""
    return {f.name: getattr(state, f.name) for f in fields(state)
            if f.name.startswith("opt_") and getattr(state, f.name) is not None}


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


def per_image_styles(rain_cfg) -> bool:
    """``mulstyle`` without ``mulstyle2``: a sampling row per image."""
    return bool(rain_cfg.mulstyle and not rain_cfg.mulstyle2)


def rain_sampling_rows(cfg) -> int:
    """Rows of the carried sampling: one per stylised image, ``data.bs``
    under ``mulstyle`` (whole-batch styles) and 1 otherwise, ``mulstyle2``
    winning (``slcl_tpu/train/trainer.py:219-226``)."""
    return cfg.data.bs if per_image_styles(cfg.rain) else 1


def create_pretrain_rain_state(cfg, rain: nn.Module) -> TrainState:
    """``pretrain_rain``'s state: the RAIN net is the trained network, Adam
    at ``optim.lr`` over its decoder and fc nets. Its encoder is frozen:
    JAX zeroes the encoder's gradients, so its Adam moments and updates stay
    zero, which is what leaving it out of the optimizer gives."""
    rain.encoder.requires_grad_(False)
    params = [p for p in rain.parameters() if p.requires_grad]
    return TrainState(seg=rain, opt_seg=make_optimizer("adam", params, cfg.optim.lr),
                      seed=cfg.run.seed)
