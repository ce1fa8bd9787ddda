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

Input and outputs are NHWC; inside, NCHW tensors in ``channels_last``
memory.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (FrozenBatchNorm, SegOutput, nchw, nhwc, normal_conv_init_,
                     stem_pool, upsample_bilinear)

_STD = 0.01


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, dilation: int = 1,
          bias: bool = False, generator=None) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
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

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = self.down_bn(self.down_conv(x)) if self.downsample else x
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

    def forward(self, x):
        out = self.aspp0(x)
        for i in range(1, self.n):
            out = out + getattr(self, f"aspp{i}")(x)
        return out


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

    def _stage(self, x, li: int):
        for i in range(self.layers[li - 1]):
            x = getattr(self, f"layer{li}_{i}")(x)
        return x

    def forward(self, x: torch.Tensor) -> SegOutput:
        """``x`` (N, H, W, C_in) NHWC."""
        in_size = x.shape[1:3]
        x = F.relu(self.bn1(self.conv1(nchw(x))))
        x = self._stage(stem_pool(x, ceil=True), 1)
        x = self._stage(x, 2)
        x3 = self._stage(x, 3)
        x4 = self._stage(x3, 4)
        aux = None
        if self.multi_level:
            aux = nhwc(upsample_bilinear(self.layer5(x3), in_size))
        pred = upsample_bilinear(self.layer6(x4), in_size)
        return SegOutput(pred=nhwc(pred), aux=aux, dcdr_ft=nhwc(x4), bottleneck=nhwc(x4))
