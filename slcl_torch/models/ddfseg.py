"""DDFSeg: the disentangled dual-stream CycleGAN networks of UDA.

Counterpart of ``slcl_tpu/models/ddfseg.py`` (reference model/DDFSeg.py):
the shared content encoder ``EncoderC`` (3 -> 32f channels at 1/8, no
dropout), the per-domain content refiners ``EncoderS`` (two dilated
residual blocks and self-attention, dropout 0.25), the per-domain style
encoders ``EncoderDiff`` (-> 32 channels, dropout 0.25), the latent decoder
``DecoderC`` shared by both image paths before each domain's
``ImageDecoder`` (its own inner ``DecoderC``, three transposed convs, a
tanh image with the input's middle channel skip-added), ``DDFNet`` with the
cross-domain swap and the cycle reconstruction, and ``SegDecoder`` (32f ->
classes).

As in the JAX package: conv -> dropout -> norm -> ReLU; BatchNorm is
flax's (momentum 0.9, eps 1e-5), InstanceNorm a GroupNorm of one channel a
group with scale and bias and eps 1e-5; a residual block whose width grows
pads the skip's channels on both sides; the attention takes its softmax
over the pooled positions (axis 1) with both products in float32 (float64
for a float64 input), and its
``gamma`` is a parameter from 0. Kernels are N(0, std^2) cut at 2 std
(flax's ``truncated_normal``), biases zero. A transposed conv is torch's
``ConvTranspose2d(3, 2, padding=1, output_padding=1)``, flax's explicit
(1, 2) padding with the kernel flipped (``utils/convert.py`` flips it).
``slim`` keeps one block of each repeated stack.

Submodule names are flax's (``encoderc``, ``_ConvBlock_0``, ``_ResBlock_3``,
``Conv_0``, ``BatchNorm_1``, ``conv_f``, ``gamma``, ``ConvTranspose_2``,
``GroupNorm_0``, ...). ``DDFNet``, ``SegDecoder`` and their public methods
take and return NHWC tensors; inside, NCHW in ``channels_last`` memory.
Dropout masks come from :func:`.common.dropout_pass`, keyed by the module's
path below ``DDFNet`` or ``SegDecoder``. :class:`DDFSeg` holds both as the
trained generator; its ``forward`` is the evaluation path.

Under spatial partitioning (``parallel/spatial.py``) the images are this
rank's band of each image's rows and every stage threads its global rows
(``rows``): the 7x7, 3x3 and dilated convolutions read their halos, the
pools and the 3x3 stride-2 transposed convolutions reshard, the instance
norms sum their moments over the model ranks (``spatial.InstanceNorm``),
the attention gathers its pooled keys and values, and each dropout keeps
its band of a mask drawn at the global rows. 1x1 convolutions, the
channel pads and the image skip stay local. At 224 rows the content runs
at 28, its pooled attention map at 14.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial as sp
from .common import (BatchNorm, Dropout, SegOutput, max_pool, name_dropouts, nchw,
                     nhwc, trunc_normal_init_)

NGF = 32


def _norm(kind: str, ch: int) -> Optional[nn.Module]:
    if kind == "batch":
        return BatchNorm(ch)
    if kind == "ins":
        return sp.InstanceNorm(ch, eps=1e-5)
    return None


def _pooled(rows: Optional[int], n: int = 1) -> Optional[int]:
    """The global rows after ``n`` 2x2 pools (None: none given)."""
    return None if rows is None else rows >> n


class _ConvBlock(nn.Module):
    """'same' conv -> dropout -> norm (``batch``, ``ins`` or ``none``) -> ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stddev: float = 0.01,
                 norm: str = "batch", relu: bool = True, dropout: float = 0.0,
                 generator=None):
        super().__init__()
        self.Conv_0 = sp.Conv2d(in_ch, features, kernel, padding=kernel // 2)
        trunc_normal_init_(self.Conv_0, stddev, generator)
        if dropout:
            self.Dropout_0 = Dropout(dropout)
        self.norm = norm
        if norm == "batch":
            self.BatchNorm_0 = _norm(norm, features)
        elif norm == "ins":
            self.GroupNorm_0 = _norm(norm, features)
        self.relu = relu

    def forward(self, x, rows=None):
        """``rows``: the input's global rows (spatial partitioning)."""
        x = self.Conv_0(x, rows)
        if hasattr(self, "Dropout_0"):
            x = self.Dropout_0(x, rows)
        if self.norm == "batch":
            x = self.BatchNorm_0(x)
        elif self.norm == "ins":
            x = self.GroupNorm_0(x)
        return F.relu(x) if self.relu else x


class _ResBlock(nn.Module):
    """Two convs and a skip; ``dilation`` > 1: dilated convs (dropout, BN),
    else two :class:`_ConvBlock`; a wider output pads the skip's channels
    on both sides (Resnet_block_ds, DDFSeg.py:64-79)."""

    def __init__(self, in_ch: int, features: int, norm: str = "batch",
                 dropout: float = 0.25, dilation: int = 1, generator=None):
        super().__init__()
        g = generator
        self.dilation = dilation
        self.pad = (features - in_ch) // 2
        if dilation > 1:
            d = dilation
            for i, ci in enumerate((in_ch, features)):
                conv = sp.Conv2d(ci, features, 3, padding=d, dilation=d)
                trunc_normal_init_(conv, 0.01, g)
                self.add_module(f"Conv_{i}", conv)
                self.add_module(f"Dropout_{i}", Dropout(dropout))
                self.add_module(f"BatchNorm_{i}", BatchNorm(features))
        else:
            self._ConvBlock_0 = _ConvBlock(in_ch, features, norm=norm, dropout=dropout,
                                           generator=g)
            self._ConvBlock_1 = _ConvBlock(features, features, norm=norm, relu=False,
                                           dropout=dropout, generator=g)

    def forward(self, x, rows=None):
        if self.dilation > 1:
            y = F.relu(self.BatchNorm_0(self.Dropout_0(self.Conv_0(x, rows), rows)))
            y = self.BatchNorm_1(self.Dropout_1(self.Conv_1(y, rows), rows))
        else:
            y = self._ConvBlock_1(self._ConvBlock_0(x, rows), rows)
        if self.pad:
            x = F.pad(x, (0, 0, 0, 0, self.pad, self.pad))
        return F.relu(y + x)


class _Attention(nn.Module):
    """SAGAN self-attention (DDFSeg.py:145-173): 1x1 blocks f, g (C/8) and
    h (C/2), f and h max-pooled 2x2; beta = softmax over the pooled
    positions of f.g; o = h.beta back to C by ``conv_o``; gamma * o + x.
    Under a spatial mesh every rank attends over the whole image: the pooled
    f and h of every model rank are gathered (``spatial.gather_rows``); g,
    beta's columns and o stay on the band. The two products are taken in
    float32, as JAX's, or in float64 for a float64 input.
    """

    def __init__(self, features: int, dropout: float = 0.25, generator=None):
        super().__init__()
        c, g = features, generator
        self.features = c
        self.conv_f = _ConvBlock(c, c // 8, kernel=1, dropout=dropout, generator=g)
        self.conv_g = _ConvBlock(c, c // 8, kernel=1, dropout=dropout, generator=g)
        self.conv_h = _ConvBlock(c, c // 2, kernel=1, dropout=dropout, generator=g)
        self.conv_o = _ConvBlock(c // 2, c, kernel=1, relu=False, dropout=dropout,
                                 generator=g)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x, rows=None):
        n, c, h, w = x.shape
        f = sp.gather_rows(max_pool(self.conv_f(x, rows), rows), _pooled(rows))
        g = self.conv_g(x, rows)
        hmap = sp.gather_rows(max_pool(self.conv_h(x, rows), rows), _pooled(rows))
        with torch.autocast(device_type=x.device.type, enabled=False):
            t = torch.promote_types(x.dtype, torch.float32)
            f2 = f.flatten(2).transpose(1, 2).to(t)              # (N, HW/4, C/8)
            g2 = g.flatten(2).transpose(1, 2).to(t)              # (N, HW, C/8)
            beta = torch.softmax(torch.bmm(f2, g2.transpose(1, 2)), dim=1)
            h2 = hmap.flatten(2).transpose(1, 2).to(t)           # (N, HW/4, C/2)
            o = torch.bmm(beta.transpose(1, 2), h2)               # (N, HW, C/2)
        o = o.transpose(1, 2).reshape(n, c // 2, h, w).to(hmap.dtype)
        o = self.conv_o(o.contiguous(memory_format=torch.channels_last), rows)
        return self.gamma * o + x


class EncoderC(nn.Module):
    """The shared content encoder (DDFSeg.py:93-119): 3 -> 32f channels at
    1/8, built without dropout."""

    def __init__(self, filters: int = 16, slim: bool = False, in_channels: int = 3,
                 generator=None):
        super().__init__()
        f, g = filters, generator
        self._ConvBlock_0 = _ConvBlock(in_channels, f, kernel=7, generator=g)
        # (output width, max-pool after it)
        plan = [(f, True), (2 * f, True), (4 * f, False)]
        plan += [] if slim else [(4 * f, False)]
        plan[-1] = (plan[-1][0], True)
        plan += [(8 * f, False)]
        plan += ([(8 * f, False)] + [(16 * f, False)] * 4) if not slim else [(16 * f, False)]
        plan += [(32 * f, False)] + ([] if slim else [(32 * f, False)])
        self.plan = plan
        prev = f
        for i, (ch, _) in enumerate(plan):
            self.add_module(f"_ResBlock_{i}", _ResBlock(prev, ch, dropout=0.0, generator=g))
            prev = ch

    def out_rows(self, rows: int) -> int:
        """The global rows of the content map of an image of ``rows``."""
        return _pooled(rows, sum(pool for _, pool in self.plan))

    def forward(self, x, rows=None):
        x = self._ConvBlock_0(x, rows)
        for i, (_, pool) in enumerate(self.plan):
            x = getattr(self, f"_ResBlock_{i}")(x, rows)
            if pool:
                x = max_pool(x, rows)
                rows = _pooled(rows)
        return x


class EncoderS(nn.Module):
    """A domain's content refiner (DDFSeg.py:194-209): dilated residual
    blocks and attention at 32f channels."""

    def __init__(self, filters: int = 16, slim: bool = False, generator=None):
        super().__init__()
        c = 32 * filters
        self.n_res = 1 if slim else 2
        for i in range(self.n_res):
            self.add_module(f"_ResBlock_{i}", _ResBlock(c, c, dilation=2, generator=generator))
        self._Attention_0 = _Attention(c, dropout=0.25, generator=generator)

    def forward(self, x, rows=None):
        for i in range(self.n_res):
            x = getattr(self, f"_ResBlock_{i}")(x, rows)
        return self._Attention_0(x, rows)


class EncoderDiff(nn.Module):
    """A domain's style encoder -> 32 channels at 1/8 (DDFSeg.py:212-237),
    dropout 0.25 everywhere."""

    def __init__(self, filters: int = 8, slim: bool = False, in_channels: int = 3,
                 generator=None):
        super().__init__()
        f, g = filters, generator
        self._ConvBlock_0 = _ConvBlock(in_channels, f, kernel=7, dropout=0.25, generator=g)
        widths = [f, 2 * f, 4 * f] + ([] if slim else [4 * f])
        self.pools = {0, 1, len(widths) - 1}
        prev = f
        for i, ch in enumerate(widths):
            self.add_module(f"_ResBlock_{i}", _ResBlock(prev, ch, generator=g))
            prev = ch
        self.n_res = len(widths)
        self._ConvBlock_1 = _ConvBlock(prev, 32, dropout=0.25, generator=g)
        self._ConvBlock_2 = _ConvBlock(32, 32, dropout=0.25, generator=g)

    def forward(self, x, rows=None):
        x = self._ConvBlock_0(x, rows)
        for i in range(self.n_res):
            x = getattr(self, f"_ResBlock_{i}")(x, rows)
            if i in self.pools:
                x = max_pool(x, rows)
                rows = _pooled(rows)
        return self._ConvBlock_2(self._ConvBlock_1(x, rows), rows)


class DecoderC(nn.Module):
    """The latent decoder (DDFSeg.py:253-270): a conv to 4 ngf (instance
    norm, no dropout) and ``n_res`` instance-norm residual blocks with
    dropout 0.25."""

    def __init__(self, in_ch: int, ngf: int = NGF, n_res: int = 4, generator=None):
        super().__init__()
        self.n_res = n_res
        self._ConvBlock_0 = _ConvBlock(in_ch, ngf * 4, stddev=0.02, norm="ins",
                                       generator=generator)
        for i in range(n_res):
            self.add_module(f"_ResBlock_{i}", _ResBlock(ngf * 4, ngf * 4, norm="ins",
                                                        dropout=0.25, generator=generator))

    def forward(self, x, rows=None):
        x = self._ConvBlock_0(x, rows)
        for i in range(self.n_res):
            x = getattr(self, f"_ResBlock_{i}")(x, rows)
        return x


def _upsampler(module: nn.Module, in_ch: int, widths, generator) -> int:
    """Add ``ConvTranspose_i`` + ``GroupNorm_i`` pairs (x2 each) to ``module``."""
    for i, ch in enumerate(widths):
        t = sp.ConvTranspose2d(in_ch, ch, 3, stride=2, padding=1, output_padding=1)
        trunc_normal_init_(t, 0.02, generator)
        module.add_module(f"ConvTranspose_{i}", t)
        module.add_module(f"GroupNorm_{i}", sp.InstanceNorm(ch, eps=1e-5))
        in_ch = ch
    return in_ch


def _upsample(module: nn.Module, x, rows=None, n: int = 3):
    """(the upsampled ``x``, its global rows)."""
    for i in range(n):
        t = getattr(module, f"ConvTranspose_{i}")
        x = F.relu(getattr(module, f"GroupNorm_{i}")(t(x, rows)))
        rows = sp.transpose_rows(t, rows)
    return x, rows


class ImageDecoder(nn.Module):
    """A domain's image decoder (DDFSeg.py:273-292): inner ``DecoderC``,
    three transposed convs (2 ngf, 2 ngf, ngf), a 7x7 conv to one channel,
    plus the input image's middle channel, tanh. ``x`` and ``img`` NCHW."""

    def __init__(self, skip: bool = True, ngf: int = NGF, n_res: int = 4, generator=None):
        super().__init__()
        self.skip = skip
        self.DecoderC_0 = DecoderC(ngf * 4, ngf=ngf, n_res=n_res, generator=generator)
        last = _upsampler(self, ngf * 4, (ngf * 2, ngf * 2, ngf), generator)
        self._ConvBlock_0 = _ConvBlock(last, 1, kernel=7, stddev=0.02, norm="none",
                                       relu=False, generator=generator)

    def forward(self, x, img, rows=None):
        """``rows``: ``x``'s global rows (spatial partitioning)."""
        x, rows = _upsample(self, self.DecoderC_0(x, rows), rows)
        x = self._ConvBlock_0(x, rows)
        if self.skip:
            x = x + img[:, 1:2].to(x.dtype)
        return torch.tanh(x)


class DDFNet(nn.Module):
    """The disentanglement net with the cross-domain swap and the cycle
    reconstruction (DDFSeg.py:295-345)."""

    def __init__(self, filters: int = 16, style_filters: int = 8, ngf: int = NGF,
                 slim: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        n_res = 1 if slim else 4
        self.encoderc = EncoderC(filters, slim, generator=g)
        self.encoders = EncoderS(filters, slim, generator=g)
        self.encodert = EncoderS(filters, slim, generator=g)
        self.style_encoder_s = EncoderDiff(style_filters, slim, generator=g)
        self.style_encoder_t = EncoderDiff(style_filters, slim, generator=g)
        # the latent decoder shared by both image paths (DDFSeg.py:306)
        self.dec_shared = DecoderC(32 * filters + 32, ngf=ngf, n_res=n_res, generator=g)
        self.decoders = ImageDecoder(ngf=ngf, n_res=n_res, generator=g)
        self.decodert = ImageDecoder(ngf=ngf, n_res=n_res, generator=g)
        name_dropouts(self)

    def content_rows(self, rows: int) -> int:
        """The global rows of the content and style maps of ``rows``-row images."""
        return self.encoderc.out_rows(rows)

    def _content_s(self, x, rows=None):
        return self.encoders(self.encoderc(x, rows), self.content_rows(rows))

    def _content_t(self, x, rows=None):
        return self.encodert(self.encoderc(x, rows), self.content_rows(rows))

    def content_s(self, x: torch.Tensor) -> torch.Tensor:
        """Source-domain content features of NHWC images, NHWC."""
        return nhwc(self._content_s(nchw(x), sp.image_rows(x)))

    def content_t(self, x: torch.Tensor) -> torch.Tensor:
        return nhwc(self._content_t(nchw(x), sp.image_rows(x)))

    def forward(self, imgs: torch.Tensor, imgt: torch.Tensor) -> Dict[str, torch.Tensor]:
        """NHWC images of each domain -> the JAX package's output dict
        (NHWC); the call order is flax's, which fixes both the running
        statistics' updates and each dropout's call count."""
        xs, xt = nchw(imgs), nchw(imgt)
        r = sp.image_rows(imgs)
        rc = self.content_rows(r)

        def decode(decoder, content, style, img):
            return decoder(self.dec_shared(torch.cat([content, style], 1), rc), img, rc)

        content_s = self._content_s(xs, r)
        content_t = self._content_t(xt, r)
        style_s = self.style_encoder_s(xs, r)
        style_t = self.style_encoder_t(xt, r)
        style_s_from_t = self.style_encoder_s(xt, r)       # should -> 0
        style_t_from_s = self.style_encoder_t(xs, r)       # should -> 0
        fake_s_t = decode(self.decodert, content_s, style_t, xs)
        fake_t_s = decode(self.decoders, content_t, style_s, xt)
        fake_s_t3 = torch.cat([fake_s_t] * 3, 1)
        fake_t_s3 = torch.cat([fake_t_s] * 3, 1)
        recon_content_t = self._content_s(fake_t_s3, r)
        recon_style_s = self.style_encoder_s(fake_t_s3, r)
        recon_content_s = self._content_t(fake_s_t3, r)
        recon_style_t = self.style_encoder_t(fake_s_t3, r)
        recon_imgs = decode(self.decoders, recon_content_s, recon_style_s, fake_s_t3)
        recon_imgt = decode(self.decodert, recon_content_t, recon_style_t, fake_t_s3)
        out = {"style_s_from_t": style_s_from_t, "style_t_from_s": style_t_from_s,
               "fake_img_s_t": fake_s_t, "fake_img_t_s": fake_t_s,
               "recon_imgs": recon_imgs, "recon_imgt": recon_imgt,
               "recon_content_s": recon_content_s, "content_t": content_t,
               "content_s": content_s}
        return {k: nhwc(v) for k, v in out.items()}


class SegDecoder(nn.Module):
    """32f -> classes (DDFSeg.py:348-374): a conv (instance norm, dropout
    0.25), instance-norm residual blocks (dropout 0.25), three transposed
    convs and a 7x7 class conv. NHWC in and out."""

    def __init__(self, num_classes: int = 4, ngf: int = NGF, slim: bool = False,
                 in_channels: int = 512, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.n_res = 1 if slim else 4
        self._ConvBlock_0 = _ConvBlock(in_channels, ngf * 4, stddev=0.02, norm="ins",
                                       dropout=0.25, generator=g)
        for i in range(self.n_res):
            self.add_module(f"_ResBlock_{i}", _ResBlock(ngf * 4, ngf * 4, norm="ins",
                                                        dropout=0.25, generator=g))
        last = _upsampler(self, ngf * 4, (ngf * 2, ngf * 2, ngf), g)
        self._ConvBlock_1 = _ConvBlock(last, num_classes, kernel=7, stddev=0.02,
                                       norm="none", relu=False, generator=g)
        name_dropouts(self)

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        """``rows``: ``x``'s global rows under spatial partitioning (default:
        its band's times the model ranks, an even split)."""
        rows = sp.image_rows(x) if rows is None else rows
        x = self._ConvBlock_0(nchw(x), rows)
        for i in range(self.n_res):
            x = getattr(self, f"_ResBlock_{i}")(x, rows)
        x, rows = _upsample(self, x, rows)
        return nhwc(self._ConvBlock_1(x, rows))


class DDFSeg(nn.Module):
    """DDFSeg's generator, ``ddfnet`` and ``segdecoder`` (the JAX trainer's
    ``{'ddfnet', 'segdecoder'}`` tree). ``forward(x)`` evaluates as the JAX
    trainer does, ``SegDecoder(content_s(x))``, as a :class:`SegOutput`
    whose ``dcdr_ft`` is the prediction."""

    def __init__(self, num_classes: int = 4, filters: int = 16, style_filters: int = 8,
                 ngf: int = NGF, slim: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ddfnet = DDFNet(filters, style_filters, ngf, slim, generator=generator)
        self.segdecoder = SegDecoder(num_classes, ngf, slim, in_channels=32 * filters,
                                     generator=generator)

    def forward(self, x: torch.Tensor) -> SegOutput:
        pred = self.segdecoder(self.ddfnet.content_s(x),
                               self.ddfnet.content_rows(sp.image_rows(x)))
        return SegOutput(pred=pred, aux=None, dcdr_ft=pred)
