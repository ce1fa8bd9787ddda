from typing import Optional

import torch

from .common import BatchNorm, ConvBNAct, SegOutput  # noqa: F401
from .discriminators import UncertaintyDiscriminator  # noqa: F401
from .drunet import DRUNet  # noqa: F401


def build_segmentor(cfg, generator: Optional[torch.Generator] = None):
    """Backbone factory (``slcl_tpu/models/common.py::build_segmentor``);
    the port carries DRUNet only."""
    name = cfg.backbone.lower()
    if name != "drunet":
        raise NotImplementedError(
            f"backbone {cfg.backbone!r}: slcl_torch ports DRUNet only")
    return DRUNet(filters=cfg.filters, in_channels=cfg.in_channels,
                  n_block=cfg.n_block, bottleneck_depth=cfg.bottleneck_depth,
                  n_class=cfg.num_classes, multilvl=cfg.multilvl,
                  phead=cfg.phead, generator=generator)
