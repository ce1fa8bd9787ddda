"""Shared model plumbing: output container, inits, flax-matching BatchNorm.

Counterpart of ``slcl_tpu/models/common.py``. Modules compute in NCHW with
``channels_last`` memory; the public tensors of :class:`SegOutput` are NHWC
views of that memory (free ``permute``s), as in the JAX package.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as dp
from ..parallel import spatial as sp


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


def trunc_normal_init_(module: nn.Module, std: float,
                       generator: Optional[torch.Generator] = None):
    """flax ``truncated_normal(std)`` kernel, zero bias: N(0, std^2) cut at
    +-2 std, not rescaled (``torch.nn.init.trunc_normal_``'s default bounds
    are absolute, so they are given here)."""
    with torch.no_grad():
        nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if module.bias is not None:
            module.bias.zero_()


def conv2d(in_ch: int, out_ch: int, kernel: int = 3, *, dilation: int = 1,
           generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """Stride-1 Conv2d with 'same' symmetric padding and the flax init; its
    forward takes the input's global rows under spatial partitioning
    (:class:`..parallel.spatial.Conv2d`)."""
    conv = sp.Conv2d(in_ch, out_ch, kernel, padding=dilation * (kernel // 2),
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
    the (C,) buffer after the call, so the activations take one pass. At
    one value per channel (n = 1), where ``F.batch_norm`` raises, flax's own
    formula runs: the output is the bias, the batch variance 0. Under data
    parallelism the moments are the global batch's, in two differentiable
    all-reduces over the data ranks: the per-channel sums and the count (the
    count too, since RAIN's stylised rows sit on one rank), then the squared
    deviations from the global mean; the running statistics take them. With
    ``track`` False (:func:`running_stats_frozen`) train mode normalises
    with the batch statistics and leaves the running ones as they are.
    Under spatial partitioning the same two reductions run over every rank
    (each holds a band of rows): the global batch's moments."""

    momentum = 0.9      # flax convention: the weight of the old value
    eps = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.track = True

    def affine(self):
        return self.weight, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.affine()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        if n == 1 or dp.data_parallel():
            return self._flax_train(x, weight, bias)
        # F.batch_norm updates the copies in place and autograd keeps them,
        # so the buffers themselves are written only after the call. With
        # track off the copies are dropped: the op is the same either way,
        # so a checkpointed forward saves the same tensors when it recomputes
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, weight, bias, True,
                         1.0 - self.momentum, self.eps)
        if self.track:
            with torch.no_grad():
                self.running_var.mul_(self.momentum / n).add_(var, alpha=(n - 1) / n)
                self.running_mean.copy_(mean)
        return y

    def _flax_train(self, x, weight, bias):
        """flax's train-mode arithmetic: E[x^2] - E[x]^2 clipped at 0, over
        the global batch under data parallelism."""
        dims = [d for d in range(x.dim()) if d != 1]
        xf = x.to(weight.dtype)
        shape = [1, -1] + [1] * (x.dim() - 2)
        if dp.data_parallel():
            # two passes, as F.batch_norm on one process: E[x^2] - E[x]^2
            # loses the variance of a few values far from zero (one per rank)
            c = x.shape[1]
            tot = dp.all_sum(torch.cat([xf.sum(dims), xf.new_tensor([float(x.numel() // c)])]))
            mean = (tot[:c] / tot[c]).view(shape)
            var = (dp.all_sum((xf - mean).square().sum(dims)) / tot[c]).view(shape)
        else:
            mean = xf.mean(dims, keepdim=True)
            var = ((xf * xf).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * weight.view(shape) + bias.view(shape)
        if self.track:
            with torch.no_grad():
                a = self.momentum
                self.running_mean.mul_(a).add_(mean.reshape(-1), alpha=1.0 - a)
                self.running_var.mul_(a).add_(var.reshape(-1), alpha=1.0 - a)
        return y.to(x.dtype)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Within the block, every :class:`BatchNorm` of ``module`` normalises
    with batch statistics in train mode and keeps its running ones (the JAX
    steps that drop a ``mutable=['batch_stats']`` result)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.track for m in norms]
    for m in norms:
        m.track = False
    try:
        yield
    finally:
        for m, t in zip(norms, before):
            m.track = t


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
    flax's (``Conv_0``, ``BatchNorm_0``). ``rows``: the input's global rows
    (spatial partitioning)."""

    def __init__(self, in_ch: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = conv2d(in_ch, features, 3, generator=generator)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        return self.BatchNorm_0(F.leaky_relu(self.Conv_0(x, rows), 0.01))


class ConvBNReLU(nn.Module):
    """Conv (no bias, 'same' padding) -> BN -> ReLU, the UNet block order
    (unet_parts.py:15-22) and ResNetUNet's decoder convs. Submodule names
    are flax's (``Conv_0``, ``BatchNorm_0``). ``rows``: the input's global
    rows (spatial partitioning)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = sp.Conv2d(in_ch, features, kernel, padding=kernel // 2, bias=False)
        torch_conv_init_(self.Conv_0, generator)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x, rows)))


def max_pool(x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """2x2 stride-2 max-pool; ``rows``: the input's global rows under
    spatial partitioning."""
    if rows is None:
        return F.max_pool2d(x, 2, 2)
    return sp.max_pool(x, rows)


def stem_pool(x: torch.Tensor, rows: Optional[int] = None, ceil: bool = False) -> torch.Tensor:
    """3x3 stride-2 max-pool of a ResNet stem. ``ceil=False``: the flax
    models' -inf pad (1, 1) + VALID (ResNetUNet); ``ceil=True``: pad (1, 2),
    torch's ``MaxPool2d(3, 2, 1, ceil_mode=True)`` (DeepLabV2: a 224 input
    gives a 57 pool). ``rows``: the input's global rows under spatial
    partitioning."""
    if rows is None:
        return F.max_pool2d(x, 3, 2, padding=1, ceil_mode=ceil)
    return sp.max_pool3(x, rows, ceil)


def upsample_nearest(x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """Nearest 2x upsample; equals ``jax.image.resize(..., 'nearest')`` for
    an integer factor (output i samples input i // 2). ``rows``: the input's
    global rows under spatial partitioning."""
    if rows is None:
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return sp.upsample_nearest(x, rows)


def upsample_bilinear(x: torch.Tensor, size, rows: Optional[int] = None) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` with
    ``align_corners=True``, the reference ``nn.Upsample`` (DRUNet.py:156).
    ``rows``: the input's global rows under spatial partitioning, where
    ``size`` is global too."""
    if rows is None:
        return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
    return sp.upsample_bilinear(x, size, rows)


# ---------------------------------------------------------------------------
# Dropout with masks keyed by (module path, call within a pass)
# ---------------------------------------------------------------------------
# (path, call, shape, keep probability, device) -> bool mask of ``shape``
DrawMask = Callable[[str, int, Tuple[int, ...], float, torch.device], torch.Tensor]
_PASSES: List["_Pass"] = []


class _Pass:
    def __init__(self, draw: DrawMask):
        self.draw = draw
        self.calls: Dict[str, int] = {}


@contextlib.contextmanager
def dropout_pass(draw: DrawMask):
    """One pass of a network (a flax ``apply``): each :class:`Dropout` in
    train mode takes its mask from ``draw(path, call, shape, keep, device)``,
    ``call`` counting that module's calls since the pass began. Two passes
    with the same ``draw`` so drop alike, as two ``apply`` calls with one
    dropout key do in flax."""
    _PASSES.append(_Pass(draw))
    try:
        yield
    finally:
        _PASSES.pop()


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode ``where(mask, x / keep, 0)`` with
    ``mask`` true at probability ``keep = 1 - rate``. The mask has the JAX
    package's layout (NHWC for a 4-d NCHW input) and comes from the active
    :func:`dropout_pass`, keyed by ``path``, the module's flax path below the
    network that :func:`name_dropouts` named (``'encoders/_ResBlock_0/
    Dropout_1'``); in train mode outside a pass it raises. Under a spatial
    mesh a 4-d input is a band of an activation of ``rows`` global rows: the
    mask is drawn at those rows and this rank's band of it kept
    (``spatial.bounds``), so the ranks drop as one process does; a 4-d
    input there without ``rows`` raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.path = ""

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = tuple(nhwc(x).shape) if x.dim() == 4 else tuple(x.shape)
        m = dp.spatial() if x.dim() == 4 else None
        if m is not None:
            if rows is None:
                raise ValueError(f"Dropout {self.path!r} under spatial partitioning: "
                                 "the activation's global rows are needed")
            shape = (shape[0], rows, *shape[2:])
        if not _PASSES:
            raise RuntimeError(f"Dropout {self.path!r} in train mode outside a "
                               "dropout_pass: its mask would have no key")
        p = _PASSES[-1]
        call = p.calls.get(self.path, 0)
        p.calls[self.path] = call + 1
        mask = p.draw(self.path, call, shape, keep, x.device)
        if m is not None:
            b = sp.bounds(rows, m.model_size)
            mask = mask[:, b[m.model_rank]:b[m.model_rank + 1]]
        if x.dim() == 4:
            mask = nchw(mask)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def name_dropouts(root: nn.Module) -> None:
    """Set each :class:`Dropout`'s ``path``: its name below ``root`` in
    flax's form (``/`` between modules)."""
    for name, m in root.named_modules():
        if isinstance(m, Dropout):
            m.path = name.replace(".", "/")
