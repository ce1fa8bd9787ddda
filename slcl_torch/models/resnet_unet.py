"""ResNet-50 encoder U-Net — the ``smp.Unet('resnet50')`` equivalent that
the paper's ``train_SLCL.py`` trains (``backbone=resnet50, multilvl=True``).

Counterpart of ``slcl_tpu/models/resnet_unet.py::ResNetUNet`` with flax's
submodule names: ``conv1``/``bn1`` (stem), ``layer{L}_{i}`` bottlenecks
(``conv1..3``, ``bn1..3``, ``down_conv``/``down_bn``; the stride on
``conv2``), ``decoder_{i}.conv{1,2}`` (``Conv_0``, ``BatchNorm_0``) with
channels (256, 128, 64, 32, 16), ``seg_head``, ``aux_head`` (multilvl: on
the half-resolution 32-channel stage, bilinearly upsampled with
``align_corners=True``), ``feat_proj`` (a 1x1 conv to ``feat_dim`` when it
is not 16) and ``phead1/2``. ``layers`` and ``base`` shrink the encoder
(64 is reference-exact).

``ResNetUNetPoint`` (AdaptEvery's segmentor) adds a point-cloud head on the
bottleneck: ``point_conv`` (3x3, stride 2), ReLU, global average pool,
``point_fc1`` (8 base), ReLU, ``point_fc2`` -> (N, n_points, 3).

Input and outputs are NHWC; inside, NCHW tensors in ``channels_last``
memory. Under spatial partitioning (``parallel/spatial.py``) the input is
this rank's band of each image's rows: the forward threads each stage's
global row count through the stem, its pool, the bottlenecks' 3x3 and
strided 1x1 convolutions, the decoder's upsamples and convolutions and the
heads (at 224 rows the stages run 112, 56, 28, 14 and 7 rows; each skip
lies on the same bands as the upsampled map it joins).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as dp
from ..parallel import spatial as sp
from .common import (BatchNorm, ConvBNReLU, SegOutput, conv2d, nchw, nhwc,
                     stem_pool, torch_conv_init_, upsample_bilinear,
                     upsample_nearest)


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, generator=None):
    conv = sp.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                     bias=False)
    torch_conv_init_(conv, generator)
    return conv


class _Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, generator=None):
        super().__init__()
        g = generator
        self.conv1 = _conv(in_ch, planes, 1, generator=g)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, generator=g)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1, generator=g)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = downsample
        if downsample:
            self.down_conv = _conv(in_ch, planes * 4, 1, stride, generator=g)
            self.down_bn = BatchNorm(planes * 4)

    def forward(self, x, rows=None):
        """``rows``: the input's global rows (spatial partitioning)."""
        y = F.relu(self.bn1(self.conv1(x, rows)))
        y = F.relu(self.bn2(self.conv2(y, rows)))
        y = self.bn3(self.conv3(y, sp.conv_rows(self.conv2, rows)))
        res = self.down_bn(self.down_conv(x, rows)) if self.downsample else x
        return F.relu(y + res)


class _DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.conv1 = ConvBNReLU(in_ch, out_ch, generator=generator)
        self.conv2 = ConvBNReLU(out_ch, out_ch, generator=generator)

    def forward(self, x, skip, rows=None):
        """``rows``: ``x``'s global rows; ``skip`` has twice as many."""
        x = upsample_nearest(x, rows)
        rows = None if rows is None else 2 * rows
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x, rows), rows)


class ResNetUNet(nn.Module):
    def __init__(self, num_classes: int = 4, layers: Sequence[int] = (3, 4, 6, 3),
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 multilvl: bool = False, phead: bool = False, feat_dim: int = 32,
                 base: int = 64, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.layers = tuple(layers)
        self.multilvl = multilvl
        self.phead = phead
        b = base
        self.conv1 = _conv(in_channels, b, 7, 2, generator=g)
        self.bn1 = BatchNorm(b)
        prev = b
        for li, (blocks, stride) in enumerate(zip(self.layers, (1, 2, 2, 2)), start=1):
            planes = b * 2 ** (li - 1)
            for i in range(blocks):
                self.add_module(f"layer{li}_{i}", _Bottleneck(
                    prev, planes, stride if i == 0 else 1, downsample=i == 0,
                    generator=g))
                prev = planes * 4
        # skips: layer3, layer2, layer1, the stem, none
        skip_ch = (b * 16, b * 8, b * 4, b, 0)
        self.n_dec = len(decoder_channels)
        for i, (ch, sk) in enumerate(zip(decoder_channels, skip_ch)):
            self.add_module(f"decoder_{i}", _DecoderBlock(prev + sk, ch, generator=g))
            prev = ch
        self.seg_head = conv2d(prev, num_classes, 3, generator=g)
        if multilvl:
            self.aux_head = conv2d(decoder_channels[-2], num_classes, 1, generator=g)
        self.feat_dim = feat_dim if feat_dim else prev
        if self.feat_dim != prev:
            self.feat_proj = conv2d(prev, self.feat_dim, 1, generator=g)
        if phead:
            self.phead1 = conv2d(self.feat_dim, self.feat_dim * 2, 1, generator=g)
            self.phead2 = conv2d(self.feat_dim * 2, self.feat_dim, 1, generator=g)

    def bottleneck_rows(self, rows: int) -> int:
        """The global rows of the bottleneck of an image of ``rows`` rows."""
        rows = sp.pool3_rows(sp.conv_rows(self.conv1, rows))
        for li, blocks in enumerate(self.layers, start=1):
            for i in range(blocks):
                rows = sp.conv_rows(getattr(self, f"layer{li}_{i}").conv2, rows)
        return rows

    def _stage(self, x, li: int, rows: int):
        """Stage ``li`` on ``x`` of ``rows`` global rows: (its output, the
        output's global rows)."""
        for i in range(self.layers[li - 1]):
            block = getattr(self, f"layer{li}_{i}")
            x = block(x, rows)
            rows = sp.conv_rows(block.conv2, rows)
        return x, rows

    def forward(self, x: torch.Tensor) -> SegOutput:
        """``x`` (N, H, W, C_in) NHWC."""
        rows = sp.image_rows(x)
        in_size = (rows, x.shape[2])
        c1 = F.relu(self.bn1(self.conv1(nchw(x), rows)))      # H/2
        rows = sp.conv_rows(self.conv1, rows)
        l1, r1 = self._stage(stem_pool(c1, rows), 1, sp.pool3_rows(rows))   # H/4
        l2, r2 = self._stage(l1, 2, r1)                        # H/8
        l3, r3 = self._stage(l2, 3, r2)                        # H/16
        l4, r4 = self._stage(l3, 4, r3)                        # H/32
        y, rows = l4, r4
        feats = []
        for i, skip in enumerate((l3, l2, l1, c1, None)[:self.n_dec]):
            y = getattr(self, f"decoder_{i}")(y, skip, rows)
            rows *= 2
            feats.append((y, rows))
        pred = self.seg_head(y, rows)
        aux = None
        if self.multilvl:
            aux_ft, aux_rows = feats[-2]
            aux = upsample_bilinear(self.aux_head(aux_ft, aux_rows), in_size, aux_rows)
        dcdr_ft = self.feat_proj(y, rows) if hasattr(self, "feat_proj") else y
        if self.phead:
            dcdr_ft = self.phead2(F.relu(self.phead1(dcdr_ft, rows)), rows)
        return SegOutput(pred=nhwc(pred), aux=None if aux is None else nhwc(aux),
                         dcdr_ft=nhwc(dcdr_ft), bottleneck=nhwc(l4))


class ResNetUNetPoint(nn.Module):
    """``slcl_tpu/models/resnet_unet.py::ResNetUNetPoint``: the U-Net as
    ``unet`` and a vertex regression head on its bottleneck; returns
    (SegOutput, vertices (N, n_points, 3)). Under spatial partitioning
    ``point_conv`` reads the bottleneck's halo (at 224 rows its 7 lie in
    bands of 4 and 3, its output's 4 in 2 and 2) and the global average pool
    is the bands' sums over the model ranks (``mesh.sample_sum``) over the
    whole map's pixels: the vertex head after it is the same on every model
    rank of a data rank."""

    def __init__(self, num_classes: int = 4, n_points: int = 300, multilvl: bool = True,
                 layers: Sequence[int] = (3, 4, 6, 3), base: int = 64,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 in_channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.n_points = n_points
        self.unet = ResNetUNet(num_classes, layers, decoder_channels, multilvl=multilvl,
                               base=base, in_channels=in_channels, generator=g)
        self.point_conv = sp.Conv2d(base * 32, base * 4, 3, stride=2, padding=1)
        torch_conv_init_(self.point_conv, g)
        self.point_fc1 = nn.Linear(base * 4, base * 8)
        self.point_fc2 = nn.Linear(base * 8, n_points * 3)
        for fc in (self.point_fc1, self.point_fc2):
            bound = 1.0 / math.sqrt(fc.in_features)
            with torch.no_grad():
                nn.init.uniform_(fc.weight, -bound, bound, generator=g)
                fc.bias.zero_()

    def forward(self, x: torch.Tensor):
        out = self.unet(x)
        rows = self.unet.bottleneck_rows(sp.image_rows(x))
        h = F.relu(self.point_conv(nchw(out.bottleneck), rows))
        if dp.spatial() is None:
            h = h.mean(dim=(2, 3))
        else:
            pixels = sp.conv_rows(self.point_conv, rows) * h.shape[3]
            low = h.dtype in (torch.float16, torch.bfloat16)
            sums = h.sum(dim=(2, 3), dtype=torch.float32 if low else h.dtype)
            h = (dp.sample_sum(sums) / pixels).to(h.dtype)
        v = self.point_fc2(F.relu(self.point_fc1(h)))
        return out, v.reshape(-1, self.n_points, 3)
