from typing import Optional

import torch

from .common import BatchNorm, ConvBNAct, FrozenBatchNorm, SegOutput  # noqa: F401
from .deeplabv2 import DeepLabV2  # noqa: F401
from .discriminators import (  # noqa: F401
    BoundaryDiscriminator, MLPDiscriminator, OutputDiscriminator, PatchGAN,
    UncertaintyDiscriminator,
)
from .drunet import DRUNet  # noqa: F401
from .resnet_unet import ResNetUNet  # noqa: F401
from .unet import UNet  # noqa: F401


def build_segmentor(cfg, generator: Optional[torch.Generator] = None):
    """Backbone factory, name for name ``slcl_tpu/models/common.py::
    build_segmentor``: ``drunet``, ``unet``, ``deeplabv2``/``resnet101``
    and ``resnet50``/``resnet50_unet``. ``layers`` and ``base`` reach
    ResNetUNet only, as in the JAX factory. Each model's ``feat_dim`` is
    the width of its ``dcdr_ft``."""
    name = cfg.backbone.lower()
    g = generator
    if name == "drunet":
        return DRUNet(filters=cfg.filters, in_channels=cfg.in_channels,
                      n_block=cfg.n_block, bottleneck_depth=cfg.bottleneck_depth,
                      n_class=cfg.num_classes, multilvl=cfg.multilvl,
                      phead=cfg.phead, generator=g)
    if name == "unet":
        return UNet(n_class=cfg.num_classes, in_channels=cfg.in_channels, generator=g)
    if name in ("deeplabv2", "resnet101"):
        return DeepLabV2(num_classes=cfg.num_classes, multi_level=cfg.multilvl,
                         in_channels=cfg.in_channels, generator=g)
    if name in ("resnet50", "resnet50_unet"):
        kw = {}
        if getattr(cfg, "layers", ()):
            kw["layers"] = tuple(cfg.layers)
        if getattr(cfg, "base", 64) != 64:
            kw["base"] = cfg.base
        return ResNetUNet(num_classes=cfg.num_classes, multilvl=cfg.multilvl,
                          phead=cfg.phead, feat_dim=cfg.filters,
                          in_channels=cfg.in_channels, generator=g, **kw)
    raise ValueError(f"unknown backbone {cfg.backbone!r}")
