"""DRUNet — dilated-residual U-Net, the paper's native backbone.

Counterpart of ``slcl_tpu/models/drunet.py`` (reference DRUNet.py:13-169),
with flax's submodule names so the weight map is mechanical: ``encoder{i}``
(``ConvBNAct_0/1``), ``conv1_{i}`` (``conv1_1`` is the reference's dead
first-stage merge conv, kept so the parameter counts are 13,483,844 and,
with multilvl, 13,484,104), ``bottleneck{i}``, ``decoder1_{i}``,
``decoder2_{i}a/b``, ``classifier``, ``classifier1`` and ``phead1/2``.

Input and outputs are NHWC; inside, NCHW tensors in ``channels_last``
memory, so the NHWC views are free. Under spatial partitioning
(``parallel/spatial.py``) the input is this rank's band of each image's
rows: the forward threads each stage's global row count through its
convolutions (their halos), pools and resizes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import image_rows
from .common import (ConvBNAct, SegOutput, conv2d, max_pool, nchw, nhwc,
                     upsample_bilinear, upsample_nearest)


class _EncoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_ch, out_ch, generator=generator)
        self.ConvBNAct_1 = ConvBNAct(out_ch, out_ch, generator=generator)

    def forward(self, x, rows=None):
        return self.ConvBNAct_1(self.ConvBNAct_0(x, rows), rows)


class DRUNet(nn.Module):
    def __init__(self, filters: int = 32, in_channels: int = 3, n_block: int = 4,
                 bottleneck_depth: int = 4, n_class: int = 4,
                 multilvl: bool = False, phead: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = filters
        self.n_block = n_block
        self.bottleneck_depth = bottleneck_depth
        self.multilvl = multilvl
        self.phead = phead
        self.feat_dim = filters     # dcdr_ft's width
        g = generator

        prev = in_channels
        for i in range(n_block):
            out_ch = f * 2 ** i
            self.add_module(f"encoder{i + 1}", _EncoderBlock(prev, out_ch, g))
            if i == 0:
                # dead twin of the reference's skipped conv1_1 (never called)
                self.add_module("conv1_1", conv2d(in_channels * 3, out_ch, 1,
                                                  generator=g))
            else:
                self.add_module(f"conv1_{i + 1}",
                                conv2d(out_ch + prev, out_ch, 1, generator=g))
            prev = out_ch

        bneck_ch = f * 2 ** n_block
        for i in range(bottleneck_depth):
            d = 2 ** i
            self.add_module(f"bottleneck{i + 1}",
                            conv2d(prev, bneck_ch, 3, dilation=d, generator=g))
            prev = bneck_ch

        for i in reversed(range(n_block)):
            out_ch = f * 2 ** i
            self.add_module(f"decoder1_{i + 1}", conv2d(prev, out_ch, 3, generator=g))
            self.add_module(f"decoder2_{i + 1}a",
                            ConvBNAct(2 * out_ch, out_ch, generator=g))
            self.add_module(f"decoder2_{i + 1}b",
                            ConvBNAct(out_ch, out_ch, generator=g))
            prev = out_ch

        self.classifier = conv2d(f, n_class, 1, generator=g)
        if multilvl:
            self.classifier1 = conv2d(2 * f, n_class, 1, generator=g)
        if phead:
            self.phead1 = conv2d(f, 2 * f, 1, generator=g)
            self.phead2 = conv2d(2 * f, f, 1, generator=g)

    def forward(self, x: torch.Tensor) -> SegOutput:
        """``x`` (N, H, W, C_in) NHWC."""
        # global rows of each stage (a band of them on this rank under
        # spatial partitioning; None leaves the plain operators)
        rows = image_rows(x)
        in_size = (rows, x.shape[2])
        out = nchw(x)

        skips = []
        res = None
        for i in range(self.n_block):
            block_out = getattr(self, f"encoder{i + 1}")(out, rows)
            skips.append(block_out)
            if i == 0:
                out = max_pool(block_out, rows)
            else:
                merged = torch.cat([block_out, res], dim=1)
                merged = F.leaky_relu(getattr(self, f"conv1_{i + 1}")(merged), 0.01)
                out = max_pool(merged, rows)
            rows //= 2
            res = out

        acc = None
        b = out
        for i in range(self.bottleneck_depth):
            b = F.leaky_relu(getattr(self, f"bottleneck{i + 1}")(b, rows), 0.01)
            acc = b if acc is None else acc + b
        bottleneck = acc

        out = bottleneck
        aux_feat = aux_rows = None
        n_modules = 2 * self.n_block
        mod_idx = 0
        for i in reversed(range(self.n_block)):
            out = upsample_nearest(out, rows)
            rows *= 2
            out = getattr(self, f"decoder1_{i + 1}")(out, rows)
            out = torch.cat([skips.pop(), out], dim=1)
            mod_idx += 1
            out = getattr(self, f"decoder2_{i + 1}a")(out, rows)
            out = getattr(self, f"decoder2_{i + 1}b")(out, rows)
            if self.multilvl and mod_idx == n_modules - 3:
                aux_feat, aux_rows = out, rows
            mod_idx += 1

        decoder_ft = out
        pred = self.classifier(decoder_ft)
        aux = None
        if self.multilvl:
            aux = self.classifier1(upsample_bilinear(aux_feat, in_size, aux_rows))
        if self.phead:
            decoder_ft = self.phead2(F.relu(self.phead1(decoder_ft)))

        return SegOutput(pred=nhwc(pred), aux=None if aux is None else nhwc(aux),
                         dcdr_ft=nhwc(decoder_ft), bottleneck=nhwc(bottleneck))
