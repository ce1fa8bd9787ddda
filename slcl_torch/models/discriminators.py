"""Discriminators (counterparts of ``slcl_tpu/models/discriminators.py``):
the entropy-map ``UncertaintyDiscriminator``, DDFSeg's ``PatchGAN``, and
the reference's ``OutputDiscriminator``, ``BoundaryDiscriminator`` and
``MLPDiscriminator`` (GAN.py:8-87,148-210), which no model factory calls.

Each returns raw logits (BCE-with-logits is applied in the loss). Input and
output are NHWC.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial as sp
from .common import nchw, nhwc, normal_conv_init_


class UncertaintyDiscriminator(nn.Module):
    """The discriminator of AdaptSeg/AdvEnt/MPSCL (reference GAN.py:90-145):
    4x [4x4 stride-2 pad-2 conv, no bias] + LeakyReLU(0.2), then a 4x4
    stride-2 conv to one logit channel; N(0, 0.02) init. ``base`` is the
    width knob (64 is reference-exact; the stages double). Under spatial
    partitioning the input is a band of each map's rows and every stage's
    output is resharded by ``parallel/spatial.py`` (224 rows go 113, 57,
    29, 15, 8: uneven bands from the first stage on)."""

    def __init__(self, in_channels: int = 4, base: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = (base, base * 2, base * 4, base * 8, 1)
        prev = in_channels
        for i, w in enumerate(widths):
            conv = sp.Conv2d(prev, w, 4, stride=2, padding=2, bias=False)
            normal_conv_init_(conv, generator)
            self.add_module(f"conv{i + 1}", conv)
            prev = w
        self.n_convs = len(widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = sp.image_rows(x)
        x = nchw(x).to(self.conv1.weight.dtype)     # flax's x.astype(dtype)
        for i in range(self.n_convs):
            conv = getattr(self, f"conv{i + 1}")
            x = conv(x, rows)
            rows = sp.conv_rows(conv, rows)
            if i < self.n_convs - 1:
                x = F.leaky_relu(x, 0.2)
        return nhwc(x)


class _ConvStack(nn.Module):
    """5x [4x4 stride-2 pad-2 conv, no bias] with LeakyReLU(0.2) between,
    widths (64, 128, 256, 512, 1), N(0, 0.02) kernels (GAN.py:90-145); NCHW
    in and out."""

    def __init__(self, in_channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        prev = in_channels
        for i, w in enumerate((64, 128, 256, 512, 1)):
            conv = nn.Conv2d(prev, w, 4, stride=2, padding=2, bias=False)
            normal_conv_init_(conv, generator)
            self.add_module(f"conv{i + 1}", conv)
            prev = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1.weight.dtype)
        for i in range(5):
            x = getattr(self, f"conv{i + 1}")(x)
            if i < 4:
                x = F.leaky_relu(x, 0.2)
        return x


class OutputDiscriminator(nn.Module):
    """The conv stack on the predictions resized bilinearly to ``size`` x
    ``size`` (half-pixel centres, as ``jax.image.resize``), optionally
    softmaxed over the classes (GAN.py:53-87). Shrinking, it antialiases as
    JAX does, with filter weights at the image edges that differ from JAX's
    slightly (``tests/test_torch_discriminators.py``)."""

    def __init__(self, in_channels: int = 4, softmax: bool = False, size: int = 224,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.softmax = softmax
        self.size = size
        self._ConvStack_0 = _ConvStack(in_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x)
        shrink = x.shape[2] > self.size or x.shape[3] > self.size
        x = F.interpolate(x, size=(self.size, self.size), mode="bilinear",
                          align_corners=False, antialias=shrink)
        if self.softmax:
            x = torch.softmax(x, dim=1)
        return nhwc(self._ConvStack_0(x))


class BoundaryDiscriminator(nn.Module):
    """The conv stack on a 1- or 3-channel map (GAN.py:148-210)."""

    def __init__(self, in_channels: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._ConvStack_0 = _ConvStack(in_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nhwc(self._ConvStack_0(nchw(x)))


class MLPDiscriminator(nn.Module):
    """4096-2048-1024-1 MLP with LeakyReLU(0.2) on the flattened (NHWC order)
    input, N(0, 0.02) weights and zero biases (GAN.py:8-50)."""

    def __init__(self, in_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        prev = in_features
        for i, w in enumerate((4096, 2048, 1024, 1)):
            fc = nn.Linear(prev, w)
            with torch.no_grad():
                nn.init.normal_(fc.weight, 0.0, 0.02, generator=generator)
                fc.bias.zero_()
            self.add_module(f"fc{i + 1}", fc)
            prev = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.fc1.weight.dtype)
        for i in range(1, 4):
            x = F.leaky_relu(getattr(self, f"fc{i}")(x), 0.2)
        return self.fc4(x)


class PatchGAN(nn.Module):
    """DDFSeg's InstanceNorm PatchGAN (reference GAN.py:213-295): C64(s2) -
    C128(s2)+IN - C256(s2)+IN - C512(s1)+IN - C1(s1), 4x4 kernels with
    padding 1, LeakyReLU(0.2), N(0, 0.02) kernels and zero biases. The
    instance norms have no scale or bias and flax's default epsilon 1e-6.
    ``aux`` adds a second head on the last features: (out, out_aux).
    Submodule names are flax's (``c0``, ``c{n}``/``in{n}``, ``c_last``,
    ``in_last``, ``head``, ``head_aux``). An input too small for the head
    to keep a pixel raises ``ValueError``. Under spatial partitioning the
    input is a band of each map's rows: the convolutions read their halos
    and reshard (224 rows go 112, 56, 28, 27, 26: uneven bands from the
    stride-1 stages on), the instance norms sum their moments over the model
    ranks, and the size check reads the global rows."""

    def __init__(self, in_channels: int = 1, ndf: int = 64, n_layers: int = 3,
                 aux: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = n_layers
        self.aux = aux

        def conv(i, o, stride):
            c = sp.Conv2d(i, o, 4, stride=stride, padding=1)
            normal_conv_init_(c, generator)
            return c

        self.c0 = conv(in_channels, ndf, 2)
        prev = ndf
        for n in range(1, n_layers):
            mult = min(2 ** n, 8)
            self.add_module(f"c{n}", conv(prev, ndf * mult, 2))
            self.add_module(f"in{n}", sp.InstanceNorm(ndf * mult, eps=1e-6, affine=False))
            prev = ndf * mult
        mult = min(2 ** n_layers, 8)
        self.c_last = conv(prev, ndf * mult, 1)
        self.in_last = sp.InstanceNorm(ndf * mult, eps=1e-6, affine=False)
        self.head = conv(ndf * mult, 1, 1)
        if aux:
            self.head_aux = conv(ndf * mult, 1, 1)

    def _head_size(self, size: int) -> int:
        """The head's output side for an input side ``size``."""
        for _ in range(self.n_layers):
            size = (size - 2) // 2 + 1
        return size - 2

    def forward(self, x: torch.Tensor):
        h, w = sp.image_rows(x), x.shape[2]
        if self._head_size(h) <= 0 or self._head_size(w) <= 0:
            # the patch map would be empty and every mean over it NaN
            raise ValueError(f"PatchGAN input too small: {h}x{w} leaves the head "
                             f"{self._head_size(h)}x{self._head_size(w)}")
        rows = h

        def conv(c, x):
            nonlocal rows
            y = c(x, rows)
            rows = sp.conv_rows(c, rows)
            return y

        x = F.leaky_relu(conv(self.c0, nchw(x).to(self.c0.weight.dtype)), 0.2)
        for n in range(1, self.n_layers):
            x = F.leaky_relu(getattr(self, f"in{n}")(conv(getattr(self, f"c{n}"), x)), 0.2)
        x = F.leaky_relu(self.in_last(conv(self.c_last, x)), 0.2)
        out = nhwc(self.head(x, rows))
        if self.aux:
            return out, nhwc(self.head_aux(x, rows))
        return out
