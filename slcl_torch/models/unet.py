"""Vanilla U-Net (reference model/unet_model.py + unet_parts.py).

Counterpart of ``slcl_tpu/models/unet.py::UNet`` with flax's submodule
names: double convs (conv -> BN -> ReLU twice, ``ConvBNAct_0/1``, each
``Conv_0``/``BatchNorm_0``) ``inc``, ``down1..4`` behind 2x2 max-pools,
``up{k}_up`` (ConvTranspose 2x2 stride 2, biased) and ``up{k}_conv`` on
``[skip, upsampled]``, and the 1x1 head ``outc``. ``dcdr_ft`` is the
``base``-channel (64) pre-head decoder output at full resolution.

Input and outputs are NHWC; inside, NCHW tensors in ``channels_last``
memory. Under spatial partitioning (``parallel/spatial.py``) the input is
this rank's band of each image's rows: the forward threads each stage's
global row count through the double convs, the max-pools and the
transposed convolutions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..parallel import spatial as sp
from .common import ConvBNReLU, SegOutput, conv2d, max_pool, nchw, nhwc


class _DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNReLU(in_ch, out_ch, generator=generator)
        self.ConvBNAct_1 = ConvBNReLU(out_ch, out_ch, generator=generator)

    def forward(self, x, rows=None):
        return self.ConvBNAct_1(self.ConvBNAct_0(x, rows), rows)


def _conv_transpose(in_ch: int, out_ch: int, generator=None) -> nn.ConvTranspose2d:
    """2x2 stride-2 transposed conv; uniform(+-1/sqrt(fan_in)) kernel with
    flax's fan_in (2 * 2 * in_ch), zero bias; its forward takes the input's
    global rows (:class:`..parallel.spatial.ConvTranspose2d`)."""
    up = sp.ConvTranspose2d(in_ch, out_ch, 2, stride=2)
    bound = 1.0 / math.sqrt(4 * in_ch)
    with torch.no_grad():
        nn.init.uniform_(up.weight, -bound, bound, generator=generator)
        up.bias.zero_()
    return up


class UNet(nn.Module):
    def __init__(self, n_class: int = 4, base: int = 64, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        f = base
        self.feat_dim = f
        self.inc = _DoubleConv(in_channels, f, g)
        for k in range(1, 5):
            self.add_module(f"down{k}", _DoubleConv(f * 2 ** (k - 1), f * 2 ** k, g))
        for k in range(1, 5):
            out_ch = f * 2 ** (4 - k)
            self.add_module(f"up{k}_up", _conv_transpose(out_ch * 2, out_ch, g))
            self.add_module(f"up{k}_conv", _DoubleConv(out_ch * 2, out_ch, g))
        self.outc = conv2d(f, n_class, 1, generator=g)

    def forward(self, x: torch.Tensor) -> SegOutput:
        """``x`` (N, H, W, C_in) NHWC."""
        rows = sp.image_rows(x)
        skips = [self.inc(nchw(x), rows)]
        for k in range(1, 5):
            skips.append(getattr(self, f"down{k}")(max_pool(skips[-1], rows), rows // 2))
            rows //= 2
        y = skips.pop()
        bottleneck = y
        for k in range(1, 5):
            up = getattr(self, f"up{k}_up")(y, rows)
            rows *= 2
            y = getattr(self, f"up{k}_conv")(torch.cat([skips.pop(), up], dim=1), rows)
        pred = self.outc(y, rows)
        return SegOutput(pred=nhwc(pred), aux=None, dcdr_ft=nhwc(y),
                         bottleneck=nhwc(bottleneck))
