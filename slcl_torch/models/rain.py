"""RAIN: style randomisation through a VAE over AdaIN statistics.

Counterpart of ``slcl_tpu/models/rain.py`` (reference model/RAIN.py): a
VGG-19 encoder through relu4_1 with the relu{1..4}_1 taps, its mirror
decoder, and a VAE over the channel statistics of the style's relu4_1
features: ``fc_encoder`` maps (mean, std) in R^1024 to a latent whose
reparameterised ``sampling = mean + noise * std`` ``fc_decoder`` turns back
into statistics, applied AdaIN-style to the content features.

Submodule names are flax's (``encoder.conv0`` ... ``conv4_1``,
``decoder.d1`` ... ``d7``, ``fc_*.Dense_0..2``), so the weight map is
mechanical. Images and features are NHWC at the interface; inside, NCHW
tensors in ``channels_last`` memory. Each net casts its input to its
weights' dtype (flax's ``x.astype(self.dtype)``), and the AdaIN
statistics and the losses are taken in float32, as in the JAX package; the
trainer keeps the net in float32 outside any autocast region. The noise is
an argument: the module holds no generator.

Gradient cuts, as in the JAX package: the encoder features of the style
and the content are constants; in :meth:`RAIN.losses` the reconstructed
statistics enter AdaIN detached (the reference's staged backward: the fc
nets take no gradient from the content and style losses) and the target of
``loss_r`` is detached; the encoder pass over the decoded image passes
gradients to its input. The encoder's weights take no update: the trainer
freezes them.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as dp
from ..parallel import spatial as sp
from .common import max_pool, nchw, nhwc, upsample_nearest

LATENT = 512


def kaiming_init_(module: nn.Module, generator: Optional[torch.Generator] = None):
    """flax ``variance_scaling(2.0, 'fan_in', 'normal')`` (the JAX package's
    ``kaiming_init``): a normal truncated at two standard deviations, scaled
    so its variance is 2 / fan_in; zero bias."""
    w = module.weight
    fan_in = w[0].numel()
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        module.bias.zero_()


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel mean and std of NHWC features, in float32, dims kept:
    (N, 1, 1, C) each; the variance is unbiased (ddof 1, torch's
    ``var()``, reference utils_.py:190) plus ``eps``. Under spatial
    partitioning ``feat`` is a band of each image's rows and the moments are
    the whole images', the same on every model rank: the sums go over the
    model ranks (``mesh.sample_sum``) in two passes, the mean (with the
    global H x W) and then the squared deviations from it."""
    f = feat.float()
    if dp.spatial() is None:
        mean = f.mean(dim=(1, 2), keepdim=True)
        var = f.var(dim=(1, 2), keepdim=True, correction=1) + eps
        return mean, var.sqrt()
    count = f.new_full((f.shape[0], 1, 1, 1), float(f.shape[1] * f.shape[2]))
    sums = dp.sample_sum(torch.cat([f.sum(dim=(1, 2), keepdim=True), count], dim=-1))
    n = sums[..., -1:]
    mean = sums[..., :-1] / n
    sq = dp.sample_sum(((f - mean) ** 2).sum(dim=(1, 2), keepdim=True))
    return mean, (sq / (n - 1.0) + eps).sqrt()


def calc_feat_mean_std(feat: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(N, 2C): the channel means, then the stds (utils_.py:230-249)."""
    mean, std = calc_mean_std(feat, eps)
    return torch.cat([mean[:, 0, 0, :], std[:, 0, 0, :]], dim=1)


def adain_with_noise(content_feat: torch.Tensor, style_stats: torch.Tensor) -> torch.Tensor:
    """Renormalise NHWC content features to decoded style statistics
    (utils_.py:197-218); ``style_stats`` (N or 1, 2C) broadcasts over the
    content batch."""
    c = content_feat.shape[-1]
    style_mean = style_stats[:, :c][:, None, None, :]
    style_std = style_stats[:, c:][:, None, None, :]
    mean, std = calc_mean_std(content_feat)
    return (content_feat.float() - mean) / std * style_std + style_mean


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared difference in float32, broadcasting as jnp does (a style
    batch of one against the content batch)."""
    return ((a.float() - b.float()) ** 2).mean()


def _refl_conv(in_ch: int, out_ch: int, generator) -> nn.Conv2d:
    """3x3 conv on a reflect-padded input (``jnp.pad(mode='reflect')`` +
    VALID); row-sharded under spatial partitioning."""
    conv = sp.Conv2d(in_ch, out_ch, 3, padding=1, padding_mode="reflect")
    kaiming_init_(conv, generator)
    return conv


class VGGEncoder(nn.Module):
    """VGG-19 through relu4_1; returns the relu{1..4}_1 taps, NCHW."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv0 = nn.Conv2d(3, 3, 1)
        kaiming_init_(self.conv0, g)
        chans = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
                 ("conv2_2", 128, 128), ("conv3_1", 128, 256), ("conv3_2", 256, 256),
                 ("conv3_3", 256, 256), ("conv3_4", 256, 256), ("conv4_1", 256, 512))
        for name, i, o in chans:
            self.add_module(name, _refl_conv(i, o, g))

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> List[torch.Tensor]:
        """``rows``: the input's global rows (spatial partitioning; each
        pool halves them)."""
        half = (lambda r: r // 2) if rows is not None else (lambda r: None)
        x = self.conv0(x.to(self.conv0.weight.dtype))
        r1 = x = F.relu(self.conv1_1(x, rows))
        x = max_pool(F.relu(self.conv1_2(x, rows)), rows)
        rows = half(rows)
        r2 = x = F.relu(self.conv2_1(x, rows))
        x = max_pool(F.relu(self.conv2_2(x, rows)), rows)
        rows = half(rows)
        r3 = x = F.relu(self.conv3_1(x, rows))
        for name in ("conv3_2", "conv3_3", "conv3_4"):
            x = F.relu(getattr(self, name)(x, rows))
        x = max_pool(x, rows)
        r4 = F.relu(self.conv4_1(x, half(rows)))
        return [r1, r2, r3, r4]


class VGGDecoder(nn.Module):
    """The mirror decoder, relu4_1 -> image, nearest x2 upsampling
    (RAIN.py:8-40); NCHW in and out."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        chans = (("d1", 512, 256), ("d2_0", 256, 256), ("d2_1", 256, 256),
                 ("d2_2", 256, 256), ("d3", 256, 128), ("d4", 128, 128),
                 ("d5", 128, 64), ("d6", 64, 64), ("d7", 64, 3))
        for name, i, o in chans:
            self.add_module(name, _refl_conv(i, o, g))

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        """``rows``: the input's global rows (spatial partitioning; each
        upsample doubles them)."""
        double = (lambda r: 2 * r) if rows is not None else (lambda r: None)
        x = upsample_nearest(F.relu(self.d1(x.to(self.d1.weight.dtype), rows)), rows)
        rows = double(rows)
        for name in ("d2_0", "d2_1", "d2_2", "d3"):
            x = F.relu(getattr(self, name)(x, rows))
        x = upsample_nearest(x, rows)
        rows = double(rows)
        x = F.relu(self.d5(F.relu(self.d4(x, rows)), rows))
        x = upsample_nearest(x, rows)
        rows = double(rows)
        return self.d7(F.relu(self.d6(x, rows)), rows)


class _FC(nn.Module):
    """Dense(1024) -> ReLU -> Dense(1024) -> ReLU -> Dense(1024)."""

    def __init__(self, in_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        for i, d in enumerate((in_dim, 1024, 1024)):
            lin = nn.Linear(d, 1024)
            kaiming_init_(lin, generator)
            self.add_module(f"Dense_{i}", lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Dense_0(x.to(self.Dense_0.weight.dtype)))
        return self.Dense_2(F.relu(self.Dense_1(x)))


class FCEncoder(_FC):
    """(mean, std) of 512 channels -> the latent's (mean, std): 1024 -> 1024."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__(2 * LATENT, generator)


class FCDecoder(_FC):
    """A latent sample -> decoded statistics: 512 -> 1024."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__(LATENT, generator)


class RAIN(nn.Module):
    """The RAIN net: 12,784,271 parameters (encoder 3,505,740, decoder
    3,505,219, fc_encoder 3,148,800, fc_decoder 2,624,512)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = VGGEncoder(generator)
        self.decoder = VGGDecoder(generator)
        self.fc_encoder = FCEncoder(generator)
        self.fc_decoder = FCDecoder(generator)

    def encode_with_intermediate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The four NHWC taps of NHWC images (under spatial partitioning of
        this rank's band of their rows, ``image_rows``)."""
        rows = sp.image_rows(x) if dp.spatial() is not None else None
        return [nhwc(f) for f in self.encoder(nchw(x), rows)]

    def decode(self, feat: torch.Tensor, rows: int) -> torch.Tensor:
        """The NHWC image of NHWC relu4_1 features of images of ``rows``
        global rows (relu4_1 has ``rows // 8``)."""
        r = rows // 8 if dp.spatial() is not None else None
        return nhwc(self.decoder(nchw(feat.contiguous()), r))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_with_intermediate(x)[-1]

    def _latent(self, stats: torch.Tensor, noise: torch.Tensor):
        inter = self.fc_encoder(stats)
        mean, std = inter[:, :LATENT], inter[:, LATENT:]
        return mean, std, mean + noise * std

    def sample(self, style: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """``mean + noise * std`` of the style's latent: (N_style, 512)."""
        with torch.no_grad():
            stats = calc_feat_mean_std(self.encode(style))
        return self._latent(stats, noise)[2]

    def losses(self, content: torch.Tensor, style: torch.Tensor, noise: torch.Tensor):
        """Pretraining losses (RAIN.py:217-246): ``(loss_c, loss_s, loss_l,
        loss_r)``; ``noise`` is (N_style, 512) standard normal."""
        with torch.no_grad():
            style_feats = self.encode_with_intermediate(style)
            content_feat = self.encode(content)
        stats = calc_feat_mean_std(style_feats[-1])
        mean, std, sampling = self._latent(stats, noise)
        recons = self.fc_decoder(sampling)
        t = adain_with_noise(content_feat, recons.detach())
        g_t = self.decode(t, sp.image_rows(content))
        g_t_feats = self.encode_with_intermediate(g_t)
        loss_c = _mse(g_t_feats[-1], t.detach())
        loss_s = 0.0
        for gf, sf in zip(g_t_feats, style_feats):
            gm, gs = calc_mean_std(gf)
            sm, ss = calc_mean_std(sf)
            loss_s = loss_s + _mse(gm, sm) + _mse(gs, ss)
        mean_sq, std_sq = mean * mean, std * std
        loss_l = 0.5 * (mean_sq + std_sq - torch.log(std_sq + 1e-5) - 1.0).mean()
        loss_r = _mse(recons, stats.detach())
        return loss_c, loss_s, loss_l, loss_r

    def style_transfer(self, content: torch.Tensor, style: torch.Tensor,
                       sampling: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None):
        """``(stylised NHWC image, sampling)`` (RAIN.py:248-283): the content
        restyled by ``fc_decoder(sampling)``, with a fresh sampling of the
        style from ``noise`` when ``sampling`` is None. Gradients reach
        ``sampling`` through fc_decoder, AdaIN and the decoder (the epsilon
        ascent's path)."""
        with torch.no_grad():
            content_feat = self.encode(content)
        if sampling is None:
            if noise is None:
                raise ValueError("style_transfer without a sampling needs noise")
            sampling = self.sample(style, noise)
        feat = adain_with_noise(content_feat, self.fc_decoder(sampling))
        return self.decode(feat, sp.image_rows(content)), sampling
