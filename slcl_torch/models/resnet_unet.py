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

Input and outputs are NHWC; inside, NCHW tensors in ``channels_last``
memory.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (BatchNorm, ConvBNReLU, SegOutput, conv2d, nchw, nhwc,
                     stem_pool, torch_conv_init_, upsample_bilinear,
                     upsample_nearest)


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, generator=None):
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
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

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(y + res)


class _DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.conv1 = ConvBNReLU(in_ch, out_ch, generator=generator)
        self.conv2 = ConvBNReLU(out_ch, out_ch, generator=generator)

    def forward(self, x, skip):
        x = upsample_nearest(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


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

    def _stage(self, x, li: int):
        for i in range(self.layers[li - 1]):
            x = getattr(self, f"layer{li}_{i}")(x)
        return x

    def forward(self, x: torch.Tensor) -> SegOutput:
        """``x`` (N, H, W, C_in) NHWC."""
        in_size = x.shape[1:3]
        c1 = F.relu(self.bn1(self.conv1(nchw(x))))            # H/2
        l1 = self._stage(stem_pool(c1), 1)                     # H/4
        l2 = self._stage(l1, 2)                                # H/8
        l3 = self._stage(l2, 3)                                # H/16
        l4 = self._stage(l3, 4)                                # H/32
        y = l4
        feats = []
        for i, skip in enumerate((l3, l2, l1, c1, None)[:self.n_dec]):
            y = getattr(self, f"decoder_{i}")(y, skip)
            feats.append(y)
        pred = self.seg_head(y)
        aux = None
        if self.multilvl:
            aux = upsample_bilinear(self.aux_head(feats[-2]), in_size)
        dcdr_ft = self.feat_proj(y) if hasattr(self, "feat_proj") else y
        if self.phead:
            dcdr_ft = self.phead2(F.relu(self.phead1(dcdr_ft)))
        return SegOutput(pred=nhwc(pred), aux=None if aux is None else nhwc(aux),
                         dcdr_ft=nhwc(dcdr_ft), bottleneck=nhwc(l4))
