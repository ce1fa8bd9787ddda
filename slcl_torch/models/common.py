"""Shared model plumbing: output container, inits, flax-matching BatchNorm.

Counterpart of ``slcl_tpu/models/common.py``. Modules compute in NCHW with
``channels_last`` memory; the public tensors of :class:`SegOutput` are NHWC
views of that memory (free ``permute``s), as in the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn


class SegOutput(NamedTuple):
    """Uniform segmentor output (reference ``(pred, aux, dcdr_ft)``)."""
    pred: torch.Tensor                   # (N, H, W, C) main logits
    aux: Optional[torch.Tensor]          # (N, H, W, C) aux logits (multilvl) or None
    dcdr_ft: torch.Tensor                # (N, H, W, F) decoder features
    bottleneck: Optional[torch.Tensor] = None  # (N, h, w, Fb) bottleneck


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def torch_conv_init_(conv: nn.Conv2d, generator: Optional[torch.Generator] = None):
    """variance_scaling(1/3, fan_in, uniform) kernel, zero bias — the flax
    ``torch_conv_init`` (``common.py:38``): uniform(±1/sqrt(fan_in))."""
    fan_in = conv.in_channels // conv.groups * conv.kernel_size[0] * conv.kernel_size[1]
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.uniform_(conv.weight, -bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


def normal_conv_init_(conv: nn.Conv2d, generator: Optional[torch.Generator] = None,
                      std: float = 0.02):
    """N(0, std) kernel, zero bias: the flax ``conv_init(std)``; 0.02 is the
    reference discriminator init (GAN.py:76-80), 0.01 DeepLab's
    (deeplabv2.py:92-93)."""
    with torch.no_grad():
        nn.init.normal_(conv.weight, 0.0, std, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


def conv2d(in_ch: int, out_ch: int, kernel: int = 3, *, dilation: int = 1,
           generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """Stride-1 Conv2d with 'same' symmetric padding and the flax init."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, padding=dilation * (kernel // 2),
                     dilation=dilation)
    torch_conv_init_(conv, generator)
    return conv


class BatchNorm(nn.Module):
    """BatchNorm over the channel dim that matches flax ``nn.BatchNorm``
    (``momentum=0.9``, ``epsilon=1e-5``).

    Train mode normalises with the batch statistics and updates
    ``running = 0.9 * running + 0.1 * batch`` with the *biased* batch
    variance, as flax does. ``F.batch_norm`` updates the running variance
    with the unbiased one; with n reduced elements its result r relates to
    flax's by ``flax = r * (n-1)/n + 0.9 * old / n``, applied in place on
    the (C,) buffer after the call, so the activations take one pass."""

    momentum = 0.9      # flax convention: the weight of the old value
    eps = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def affine(self):
        return self.weight, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.affine()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        # F.batch_norm updates the copies in place and autograd keeps them,
        # so the buffers themselves are written only after the call
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, weight, bias, True,
                         1.0 - self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_(self.momentum / n).add_(var, alpha=(n - 1) / n)
            self.running_mean.copy_(mean)
        return y


class FrozenBatchNorm(BatchNorm):
    """BatchNorm whose scale and bias take no gradient from the loss
    (``slcl_tpu/models/common.py::FrozenBatchNorm``, DeepLabV2's frozen BN):
    batch statistics in training, running statistics updated as
    :class:`BatchNorm` does, the affine parameters detached inside the
    call. They stay parameters: the optimizer step hands them a zero
    gradient (``train/steps.py::_seg_update``), so weight decay shrinks
    them as optax's ``add_decayed_weights`` does in the JAX package."""

    def affine(self):
        return self.weight.detach(), self.bias.detach()


class ConvBNAct(nn.Module):
    """3x3 conv -> LeakyReLU(0.01) -> BN, the DRUNet block order
    (DRUNet.py:29-36 puts BN *after* the activation). Submodule names are
    flax's (``Conv_0``, ``BatchNorm_0``)."""

    def __init__(self, in_ch: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = conv2d(in_ch, features, 3, generator=generator)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(F.leaky_relu(self.Conv_0(x), 0.01))


class ConvBNReLU(nn.Module):
    """Conv (no bias, 'same' padding) -> BN -> ReLU, the UNet block order
    (unet_parts.py:15-22) and ResNetUNet's decoder convs. Submodule names
    are flax's (``Conv_0``, ``BatchNorm_0``)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel, padding=kernel // 2,
                                bias=False)
        torch_conv_init_(self.Conv_0, generator)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def stem_pool(x: torch.Tensor, ceil: bool = False) -> torch.Tensor:
    """3x3 stride-2 max-pool of a ResNet stem. ``ceil=False``: the flax
    models' -inf pad (1, 1) + VALID (ResNetUNet); ``ceil=True``: pad (1, 2),
    torch's ``MaxPool2d(3, 2, 1, ceil_mode=True)`` (DeepLabV2: a 224 input
    gives a 57 pool)."""
    return F.max_pool2d(x, 3, 2, padding=1, ceil_mode=ceil)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample; equals ``jax.image.resize(..., 'nearest')`` for
    an integer factor (output i samples input i // 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` with
    ``align_corners=True``, the reference ``nn.Upsample`` (DRUNet.py:156)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
