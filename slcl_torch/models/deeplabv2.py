"""DeepLab-V2: dilated ResNet-101 + ASPP heads with frozen BatchNorm, the
published model of AdvEnt and AdaptSeg.

Counterpart of ``slcl_tpu/models/deeplabv2.py::DeepLabV2`` with flax's
submodule names: ``conv1``/``bn1`` (stem; its max-pool in ceil mode),
``layer{L}_{i}`` bottlenecks (the stride on ``conv1``, the caffe variant;
layers 3 and 4 dilated by 2 and 4), every norm a :class:`FrozenBatchNorm`,
and the ASPP heads ``layer5`` (aux, on layer 3, multi-level only) and
``layer6`` (main), each the sum of four biased 3x3 convs ``aspp0..3``
dilated 6/12/18/24. Every conv is N(0, 0.01). Both outputs are bilinearly
upsampled to the input with ``align_corners=True``; ``dcdr_ft`` is layer
4's 2048 channels at 1/8 of the input. 42,942,560 parameters with the aux
head.

``BCLDeepLab`` (BCL's ResNetPair5, reference BCL_DeeplabV2.py:100-177) is the
same trunk at stage width ``base`` with one ASPP head ``layer5`` that also
returns its four branches concatenated (4 C channels at 1/8: the space of
BCL's prototypes); ``pair`` adds a target-domain stem (``target_conv1``,
``target_bn1``, ``target_layer1_*``) chosen by ``source=False``.

Input and outputs are NHWC; inside, NCHW tensors in ``channels_last``
memory. Under spatial partitioning (``parallel/spatial.py``) ``DeepLabV2``'s
input is this rank's band of each image's rows: the forward threads each
stage's global row count through the stem, its ceil-mode pool (224 rows go
112, 57, 29), the bottlenecks' strided 1x1 and dilated 3x3 convolutions,
the ASPP's dilated convolutions (halos of up to 24 rows, wider than a band)
and the resizes to the input; ``BCLDeepLab``'s the same way, its
feature-returning ASPP too.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial as sp
from .common import (FrozenBatchNorm, SegOutput, nchw, nhwc, normal_conv_init_,
                     stem_pool, upsample_bilinear)

_STD = 0.01


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, dilation: int = 1,
          bias: bool = False, generator=None) -> nn.Conv2d:
    conv = sp.Conv2d(in_ch, out_ch, kernel, stride=stride,
                     padding=dilation * (kernel // 2), dilation=dilation, bias=bias)
    normal_conv_init_(conv, generator, _STD)
    return conv


class _Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, generator=None):
        super().__init__()
        g = generator
        self.conv1 = _conv(in_ch, planes, 1, stride, generator=g)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, dilation=dilation, generator=g)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1, generator=g)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = downsample
        if downsample:
            self.down_conv = _conv(in_ch, planes * 4, 1, stride, generator=g)
            self.down_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x, rows=None):
        """``rows``: the input's global rows (spatial partitioning)."""
        mid = sp.conv_rows(self.conv1, rows)
        y = F.relu(self.bn1(self.conv1(x, rows)))
        y = F.relu(self.bn2(self.conv2(y, mid)))
        y = self.bn3(self.conv3(y, mid))
        res = self.down_bn(self.down_conv(x, rows)) if self.downsample else x
        return F.relu(y + res)


class _ASPP(nn.Module):
    """Sum of four dilated 3x3 class convs (deeplabv2.py:52-68)."""

    def __init__(self, in_ch: int, num_classes: int,
                 dilations: Sequence[int] = (6, 12, 18, 24), generator=None):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"aspp{i}", _conv(in_ch, num_classes, 3, dilation=d,
                                              bias=True, generator=generator))

    def forward(self, x, rows=None):
        out = self.aspp0(x, rows)
        for i in range(1, self.n):
            out = out + getattr(self, f"aspp{i}")(x, rows)
        return out


class _ASPPWithFeature(_ASPP):
    """The ASPP sum and the concatenation of its branches (BCL_DeeplabV2.py:86-97)."""

    def forward(self, x, rows=None):
        feats = [getattr(self, f"aspp{i}")(x, rows) for i in range(self.n)]
        out = feats[0]
        for y in feats[1:]:
            out = out + y
        return out, torch.cat(feats, dim=1)


class BCLDeepLab(nn.Module):
    """``slcl_tpu/models/deeplabv2.py::BCLDeepLab``: ``forward(x, source)`` ->
    (logits upsampled to the input with ``align_corners=True``, the 4 C
    ASPP features at 1/8), NHWC."""

    def __init__(self, num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                 pair: bool = False, base: int = 64, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.layers = tuple(layers)
        self.pair = pair
        b = base
        prefixes = ("", "target_") if pair else ("",)
        for pre in prefixes:
            self.add_module(f"{pre}conv1", _conv(in_channels, b, 7, 2, generator=g))
            self.add_module(f"{pre}bn1", FrozenBatchNorm(b))
            self._add_stage(f"{pre}layer1", b, b, self.layers[0], 1, 1, g)
        prev = b * 4
        for li, (stride, dil) in zip((2, 3, 4), ((2, 1), (1, 2), (1, 4))):
            planes = b * 2 ** (li - 1)
            self._add_stage(f"layer{li}", prev, planes, self.layers[li - 1], stride, dil, g)
            prev = planes * 4
        self.layer5 = _ASPPWithFeature(prev, num_classes, generator=g)

    def _add_stage(self, name, in_ch, planes, blocks, stride, dilation, g):
        for i in range(blocks):
            self.add_module(f"{name}_{i}", _Bottleneck(
                in_ch if i == 0 else planes * 4, planes, stride if i == 0 else 1,
                dilation, downsample=i == 0, generator=g))

    def _stage(self, x, name: str, blocks: int, rows: int):
        """(the stage's output, its global rows)."""
        for i in range(blocks):
            block = getattr(self, f"{name}_{i}")
            x = block(x, rows)
            rows = sp.conv_rows(block.conv1, rows)
        return x, rows

    def feature_rows(self, rows: int) -> int:
        """The global rows of the features of an image of ``rows`` rows."""
        rows = sp.pool3_rows(sp.conv_rows(self.conv1, rows), True)
        for li, blocks in enumerate(self.layers, start=1):
            for i in range(blocks):
                rows = sp.conv_rows(getattr(self, f"layer{li}_{i}").conv1, rows)
        return rows

    def forward(self, x: torch.Tensor, source: bool = True):
        rows = sp.image_rows(x)
        in_size = (rows, x.shape[2])
        pre = "" if (source or not self.pair) else "target_"
        conv1 = getattr(self, f"{pre}conv1")
        x = F.relu(getattr(self, f"{pre}bn1")(conv1(nchw(x), rows)))
        rows = sp.conv_rows(conv1, rows)
        x, rows = self._stage(stem_pool(x, rows, ceil=True), f"{pre}layer1", self.layers[0],
                              sp.pool3_rows(rows, True))
        for li in (2, 3, 4):
            x, rows = self._stage(x, f"layer{li}", self.layers[li - 1], rows)
        pred, feature = self.layer5(x, rows)
        return nhwc(upsample_bilinear(pred, in_size, rows)), nhwc(feature)


class DeepLabV2(nn.Module):
    def __init__(self, num_classes: int = 4, layers: Sequence[int] = (3, 4, 23, 3),
                 multi_level: bool = False, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.layers = tuple(layers)
        self.multi_level = multi_level
        self.conv1 = _conv(in_channels, 64, 7, 2, generator=g)
        self.bn1 = FrozenBatchNorm(64)
        prev = 64
        for li, (blocks, stride, dil) in enumerate(
                zip(self.layers, (1, 2, 1, 1), (1, 1, 2, 4)), start=1):
            planes = 64 * 2 ** (li - 1)
            for i in range(blocks):
                self.add_module(f"layer{li}_{i}", _Bottleneck(
                    prev, planes, stride if i == 0 else 1, dil, downsample=i == 0,
                    generator=g))
                prev = planes * 4
        self.feat_dim = prev
        if multi_level:
            self.layer5 = _ASPP(prev // 2, num_classes, generator=g)
        self.layer6 = _ASPP(prev, num_classes, generator=g)

    def _stage(self, x, li: int, rows: int):
        """Stage ``li`` on ``x`` of ``rows`` global rows: (its output, the
        output's global rows)."""
        for i in range(self.layers[li - 1]):
            block = getattr(self, f"layer{li}_{i}")
            x = block(x, rows)
            rows = sp.conv_rows(block.conv1, rows)
        return x, rows

    def forward(self, x: torch.Tensor) -> SegOutput:
        """``x`` (N, H, W, C_in) NHWC."""
        rows = sp.image_rows(x)
        in_size = (rows, x.shape[2])
        x = F.relu(self.bn1(self.conv1(nchw(x), rows)))
        rows = sp.conv_rows(self.conv1, rows)
        x, rows = self._stage(stem_pool(x, rows, ceil=True), 1, sp.pool3_rows(rows, True))
        x, rows = self._stage(x, 2, rows)
        x3, r3 = self._stage(x, 3, rows)
        x4, r4 = self._stage(x3, 4, r3)
        aux = None
        if self.multi_level:
            aux = nhwc(upsample_bilinear(self.layer5(x3, r3), in_size, r3))
        pred = upsample_bilinear(self.layer6(x4, r4), in_size, r4)
        return SegOutput(pred=nhwc(pred), aux=aux, dcdr_ft=nhwc(x4), bottleneck=nhwc(x4))
