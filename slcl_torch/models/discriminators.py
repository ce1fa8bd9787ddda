"""Entropy-map discriminator (counterpart of
``slcl_tpu/models/discriminators.py::UncertaintyDiscriminator``).

Returns raw logits (BCE-with-logits is applied in the loss). Input and
output are NHWC.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import nchw, nhwc, normal_conv_init_


class UncertaintyDiscriminator(nn.Module):
    """The discriminator of AdaptSeg/AdvEnt/MPSCL (reference GAN.py:90-145):
    4x [4x4 stride-2 pad-2 conv, no bias] + LeakyReLU(0.2), then a 4x4
    stride-2 conv to one logit channel; N(0, 0.02) init. ``base`` is the
    width knob (64 is reference-exact; the stages double)."""

    def __init__(self, in_channels: int = 4, base: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = (base, base * 2, base * 4, base * 8, 1)
        prev = in_channels
        for i, w in enumerate(widths):
            conv = nn.Conv2d(prev, w, 4, stride=2, padding=2, bias=False)
            normal_conv_init_(conv, generator)
            self.add_module(f"conv{i + 1}", conv)
            prev = w
        self.n_convs = len(widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x)
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i + 1}")(x)
            if i < self.n_convs - 1:
                x = F.leaky_relu(x, 0.2)
        return nhwc(x)
