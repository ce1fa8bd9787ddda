"""Row-sharded operators for spatial partitioning (``mesh.spatial``; the
port of what GSPMD does for JAX's ``spatial_shard_batch``).

Under a spatial mesh (:func:`.mesh.spatial`) each model rank of a data
rank holds a band of each image's rows. A tensor of ``rows`` global rows
lies on the model ranks by :func:`bounds`: rank ``m`` holds rows
``[b[m], b[m + 1])``, ``ceil(rows / M)`` a rank and fewer (or none) on the
last. A network's input is split evenly (the Trainer requires it); each
operator here maps the global rows of its input to those of its output,
and its output is laid out by :func:`bounds` again, whatever the input's
layout was, so an uneven stage (the discriminator's 224 -> 113 -> 57 ...,
or a bottleneck of 7 rows over 4 ranks) reshards as GSPMD does.

Every operator is the same three steps on every rank:

1. the input rows its output band reads, ``[lo, hi)`` in global rows,
   fetched by :class:`_Fetch`: its own rows locally, its neighbours' (or
   any rank's, for a halo wider than a band) through one all-reduce over
   the model group of a buffer with a slot per (reader, owner) pair, and
   the operator's padding value outside ``[0, rows)`` (the image's true
   top and bottom edges: zeros, or ``-inf`` for a max-pool; a reflect-padded
   convolution reads the mirrored image rows there, which may lie on
   another rank).
   The backward sends each slot's gradient back to its owner the same way
   and adds it there. Only all-reduces, which gloo runs on CUDA tensors as
   well as NCCL; no exchange at all where no rank reads another's rows (a
   pool whose bands line up);
2. the operator on the fetched rows with no row padding (its column
   padding as before);
3. its output narrowed to the band. A rank whose band is empty computes
   one row from zero rows and keeps none of it, so that every rank runs the
   same operators, and the same collectives in the backward.

Outside a spatial mesh each operator is the plain one.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import mesh as dp


def bounds(rows: int, parts: int) -> List[int]:
    """Rank ``m`` of ``parts`` holds global rows ``[b[m], b[m + 1])``."""
    per = -(-rows // parts)
    return [min(m * per, rows) for m in range(parts + 1)]


def image_rows(x: torch.Tensor) -> int:
    """The global rows of a network's NHWC input: under a spatial mesh its
    local rows times the model ranks (an input is split evenly)."""
    m = dp.spatial()
    return x.shape[1] if m is None else x.shape[1] * m.model_size


def _plan(rows: int, reads: Sequence[Tuple[int, int]], parts: int):
    """The slots of one exchange: ``(reader, owner, lo, hi, offset)`` for
    every global row range ``[lo, hi)`` that ``reader`` reads from another
    rank ``owner``, at ``offset`` in the buffer; and the buffer's rows."""
    b = bounds(rows, parts)
    slots, at = [], 0
    for reader, (lo, hi) in enumerate(reads):
        for owner in range(parts):
            if owner == reader:
                continue
            s, e = max(lo, b[owner]), min(hi, b[owner + 1])
            if s < e:
                slots.append((reader, owner, s, e, at))
                at += e - s
    return slots, at


class _Fetch(torch.autograd.Function):
    """Global rows ``[lo, hi)`` of a row-sharded NCHW tensor on this rank
    (``fill`` outside ``[0, rows)``), from every rank's ``reads``."""

    @staticmethod
    def forward(ctx, x, rows, reads, mesh, fill=0.0):
        rank, parts = mesh.model_rank, mesh.model_size
        b = bounds(rows, parts)
        if x.shape[2] != b[rank + 1] - b[rank]:
            raise ValueError(f"spatial: rank {rank} holds {x.shape[2]} rows of a "
                             f"{rows}-row tensor, its band is {b[rank]}:{b[rank + 1]}")
        slots, total = _plan(rows, reads, parts)
        lo, hi = reads[rank]
        n, c, _, w = x.shape
        buf = None
        if total:
            buf = x.new_zeros((n, c, total, w))
            for reader, owner, s, e, at in slots:
                if owner == rank:
                    buf[:, :, at:at + e - s] = x[:, :, s - b[rank]:e - b[rank]]
            dist.all_reduce(buf, group=mesh.model_group)
        out = _zeros(x, (n, c, hi - lo, w))
        if fill != 0.0:
            # every row inside [0, rows) is written below
            out.fill_(fill)
        own_s, own_e = max(lo, b[rank]), min(hi, b[rank + 1])
        if own_s < own_e:
            out[:, :, own_s - lo:own_e - lo] = x[:, :, own_s - b[rank]:own_e - b[rank]]
        for reader, owner, s, e, at in slots:
            if reader == rank:
                out[:, :, s - lo:e - lo] = buf[:, :, at:at + e - s]
        ctx.plan = (rows, reads, mesh, slots, total, tuple(x.shape))
        return out

    @staticmethod
    def backward(ctx, grad):
        rows, reads, mesh, slots, total, shape = ctx.plan
        rank, parts = mesh.model_rank, mesh.model_size
        b = bounds(rows, parts)
        lo, hi = reads[rank]
        dx = _zeros(grad, shape)
        own_s, own_e = max(lo, b[rank]), min(hi, b[rank + 1])
        if own_s < own_e:
            dx[:, :, own_s - b[rank]:own_e - b[rank]] += grad[:, :, own_s - lo:own_e - lo]
        if total:
            n, c, _, w = shape
            buf = grad.new_zeros((n, c, total, w))
            for reader, owner, s, e, at in slots:
                if reader == rank:
                    buf[:, :, at:at + e - s] = grad[:, :, s - lo:e - lo]
            dist.all_reduce(buf, group=mesh.model_group)
            for reader, owner, s, e, at in slots:
                if owner == rank:
                    dx[:, :, s - b[rank]:e - b[rank]] += buf[:, :, at:at + e - s]
        return dx, None, None, None, None


def _zeros(like: torch.Tensor, shape) -> torch.Tensor:
    """Zeros of ``shape`` in ``like``'s type, device and memory format."""
    fmt = (torch.channels_last if like.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       memory_format=fmt).zero_()


def _reads(rows_in: int, rows_out: int, parts: int, span) -> List[Tuple[int, int]]:
    """Each rank's input rows ``[lo, hi)`` for its output band; ``span(o0,
    o1)`` gives them for a non-empty band ``[o0, o1)``. An empty band reads
    ``span(0, 1)``'s length of zero rows below the image."""
    b = bounds(rows_out, parts)
    out = []
    for m in range(parts):
        if b[m] < b[m + 1]:
            out.append(span(b[m], b[m + 1]))
        else:
            lo, hi = span(0, 1)
            out.append((rows_in + 1, rows_in + 1 + hi - lo))
    return out


def _mirror(g: int, rows: int) -> int:
    """The row that ``jnp.pad(mode='reflect')`` puts at global row ``g`` of
    a ``rows``-row tensor: row -k is row k, row rows - 1 + k is rows - 1 - k."""
    if g < 0:
        return -g
    return 2 * (rows - 1) - g if g >= rows else g


def _fetch_reflect(x: torch.Tensor, rows: int, reads, mesh) -> torch.Tensor:
    """:class:`_Fetch` of ``reads`` with the rows outside ``[0, rows)``
    mirrored: each rank fetches the image rows its reads map to (a mirrored
    row may lie on another rank: a band of one row reads its neighbour's),
    then picks them in order. The pick's backward adds a mirrored row's
    gradient to the fetched row, and the fetch's sends it to its owner. An
    empty band's read (below the image, :func:`_reads`) stays zeros."""
    picks, fetch = [], []
    for lo, hi in reads:
        if lo > rows:
            picks.append(None)
            fetch.append((lo, hi))
            continue
        src = [_mirror(g, rows) for g in range(lo, hi)]
        picks.append(src)
        fetch.append((min(src), max(src) + 1))
    xs = _Fetch.apply(x, rows, fetch, mesh)
    src, (lo, hi) = picks[mesh.model_rank], fetch[mesh.model_rank]
    if src is None or src == list(range(lo, hi)):
        return xs
    return xs.index_select(2, torch.tensor([s - lo for s in src], device=x.device))


def _rowwise(x: torch.Tensor, rows_in: int, rows_out: int, span, fn, first,
             fill=0.0) -> torch.Tensor:
    """Steps 1-3 of the module docstring: ``fn`` on the fetched rows
    ``[lo, hi)`` (``fill`` outside the image, or ``"reflect"``: the image's
    rows mirrored at its edges) gives output rows from global row
    ``first(lo)`` on; the band is kept."""
    m = dp.spatial()
    parts, rank = m.model_size, m.model_rank
    reads = _reads(rows_in, rows_out, parts, span)
    if fill == "reflect":
        xs = _fetch_reflect(x, rows_in, reads, m)
    else:
        xs = _Fetch.apply(x, rows_in, reads, m, fill)
    y = fn(xs)
    b = bounds(rows_out, parts)
    start = b[rank] - first(reads[rank][0]) if b[rank] < b[rank + 1] else 0
    if start == 0 and y.shape[2] == b[rank + 1] - b[rank]:
        return y
    # a copy, not a view: a module's view output loses FSDP's backward hook
    # to any in-place op on it
    return y.narrow(2, start, b[rank + 1] - b[rank]).clone()


def conv_rows(conv: nn.Conv2d, rows: Optional[int]) -> Optional[int]:
    """The global output rows of ``conv`` on ``rows`` input rows (None:
    none given, the plain operators)."""
    if rows is None:
        return None
    k, s, p, d = conv.kernel_size[0], conv.stride[0], conv.padding[0], conv.dilation[0]
    return (rows + 2 * p - d * (k - 1) - 1) // s + 1


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and state dict) whose forward
    takes the input's global ``rows``: under a spatial mesh it reads its
    halo from the neighbouring bands and pads zero rows only at the image's
    edges (``padding_mode="reflect"``: the image's rows mirrored there, RAIN's
    ``jnp.pad(mode='reflect')``). A module, so that FSDP's hooks gather its
    weights."""

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        if dp.spatial() is None or rows is None:
            return super().forward(x)
        k, s, p, d = self.kernel_size[0], self.stride[0], self.padding[0], self.dilation[0]
        if k == 1 and s == 1 and p == 0 and x.shape[2]:
            return super().forward(x)          # row-local: no halo (an empty
            # band, which torch's convolution refuses, takes the steps below)
        span = lambda o0, o1: (o0 * s - p, (o1 - 1) * s - p + d * (k - 1) + 1)
        reflect = self.padding_mode == "reflect"
        if reflect:
            cols = self.padding[1]
            fn = lambda xs: F.conv2d(F.pad(xs, (cols, cols, 0, 0), mode="reflect"),
                                     self.weight, self.bias, (s, self.stride[1]), 0,
                                     (d, self.dilation[1]), self.groups)
        else:
            fn = lambda xs: F.conv2d(xs, self.weight, self.bias, (s, self.stride[1]),
                                     (0, self.padding[1]), (d, self.dilation[1]),
                                     self.groups)
        return _rowwise(x, rows, conv_rows(self, rows), span, fn, lambda lo: (lo + p) // s,
                        fill="reflect" if reflect else 0.0)


def max_pool(x: torch.Tensor, rows: int) -> torch.Tensor:
    """2x2 stride-2 max-pool of a (row-sharded) NCHW tensor of ``rows``
    global rows. Local where the bands line up (even bands)."""
    if dp.spatial() is None:
        return F.max_pool2d(x, 2, 2)
    return _rowwise(x, rows, rows // 2, lambda o0, o1: (2 * o0, 2 * o1),
                    lambda xs: F.max_pool2d(xs, 2, 2), lambda lo: lo // 2)


def pool3_rows(rows: int, ceil: bool = False) -> int:
    """The output rows of :func:`max_pool3` on ``rows`` input rows (torch's
    ``MaxPool2d(3, 2, 1, ceil_mode=ceil)``: a ceil-mode window must start
    inside the input or its top padding)."""
    out = (-(-(rows - 1) // 2) if ceil else (rows - 1) // 2) + 1
    return out - 1 if ceil and (out - 1) * 2 >= rows + 1 else out


def max_pool3(x: torch.Tensor, rows: int, ceil: bool = False) -> torch.Tensor:
    """3x3 stride-2 max-pool with one ``-inf`` row and column of padding
    (``ceil``: torch's ceil mode, padding the bottom by two) of a
    (row-sharded) NCHW tensor of ``rows`` global rows: a ResNet stem's pool.
    Output row ``i`` reads input rows ``2i - 1 .. 2i + 1``; rows outside the
    image are ``-inf``, so a window reaches the same arg-max (and routes its
    gradient to the same input) as the unsharded pool's."""
    if dp.spatial() is None:
        return F.max_pool2d(x, 3, 2, padding=1, ceil_mode=ceil)
    return _rowwise(x, rows, pool3_rows(rows, ceil), lambda o0, o1: (2 * o0 - 1, 2 * o1),
                    lambda xs: F.max_pool2d(xs, 3, 2, padding=(0, 1), ceil_mode=ceil),
                    lambda lo: (lo + 1) // 2, fill=-math.inf)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (the same parameters and state dict) whose
    forward takes the input's global ``rows``. Input row ``i`` reaches output
    rows ``stride * i - padding + dilation * j`` (``j`` < kernel): an output
    band reads the input rows whose reach covers it (UNet's 2x2 stride-2
    up-convolution: row ``o // 2``; DDFSeg's 3x3 stride 2, padding 1,
    output padding 1: rows ``(o - 1) // 2`` to ``(o + 1) // 2``, one row of
    the next band), and nothing past the image's last row; a band whose last
    output rows lie in ``output_padding`` computes them as the unsharded
    operator does."""

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        if dp.spatial() is None or rows is None:
            return super().forward(x)
        k, s, p, d = self.kernel_size[0], self.stride[0], self.padding[0], self.dilation[0]
        rows_out = transpose_rows(self, rows)
        reach = d * (k - 1)

        def span(o0, o1):
            return max(0, -(-(o0 + p - reach) // s)), min(rows, (o1 - 1 + p) // s + 1)

        m = dp.spatial()
        b = bounds(rows_out, m.model_size)
        o0, o1 = b[m.model_rank], b[m.model_rank + 1]
        extra = 0
        if o0 < o1:
            lo, hi = span(o0, o1)
            # rows past the last input's reach: the output padding's
            extra = max(0, o1 - (s * lo - p) - ((hi - lo - 1) * s + reach + 1))
        fn = lambda xs: F.conv_transpose2d(xs, self.weight, self.bias, (s, self.stride[1]),
                                           (0, self.padding[1]),
                                           (extra, self.output_padding[1]), self.groups,
                                           (d, self.dilation[1]))
        return _rowwise(x, rows, rows_out, span, fn, lambda lo: s * lo - p)


def transpose_rows(conv: nn.ConvTranspose2d, rows: Optional[int]) -> Optional[int]:
    """The global output rows of the transposed convolution ``conv`` on
    ``rows`` input rows (None: none given)."""
    if rows is None:
        return None
    k, s, p, d = conv.kernel_size[0], conv.stride[0], conv.padding[0], conv.dilation[0]
    return (rows - 1) * s - 2 * p + d * (k - 1) + conv.output_padding[0] + 1


class InstanceNorm(nn.GroupNorm):
    """Instance norm, ``nn.GroupNorm`` with one channel a group (the same
    ``weight`` and ``bias`` when ``affine``, the same state dict): each
    image's and channel's moments over its pixels, the variance biased.
    Under a spatial mesh the input is a band of each image's rows and the
    moments are the whole image's, the same on every model rank: two passes
    summed over the model ranks (``mesh.sample_sum``), the mean with the
    pixel count, then the squared deviations from it; in float32 for a
    half-precision input, whose output is float32 under autocast (as
    ``group_norm``'s is)."""

    def __init__(self, channels: int, eps: float = 1e-5, affine: bool = True):
        super().__init__(channels, channels, eps=eps, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if dp.spatial() is None:
            return super().forward(x)
        low = x.dtype in (torch.float16, torch.bfloat16)
        xf = x.float() if low else x
        c = x.shape[1]
        count = xf.new_full((x.shape[0], 1), float(x.shape[2] * x.shape[3]))
        sums = dp.sample_sum(torch.cat([xf.sum(dim=(2, 3)), count], dim=1))
        n = sums[:, c:]
        mean = (sums[:, :c] / n)[:, :, None, None]
        var = (dp.sample_sum((xf - mean).square().sum(dim=(2, 3))) / n)[:, :, None, None]
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        if low and not torch.is_autocast_enabled(x.device.type):
            y = y.to(x.dtype)
        return y


class _Gather(torch.autograd.Function):
    """The whole tensor of ``rows`` global rows on every model rank: each
    rank's band in its slot of zeros, summed over the model group. The
    backward sums the cotangents over the group and keeps this rank's band."""

    @staticmethod
    def forward(ctx, x, rows, mesh):
        b, r = bounds(rows, mesh.model_size), mesh.model_rank
        if x.shape[2] != b[r + 1] - b[r]:
            raise ValueError(f"spatial: rank {r} holds {x.shape[2]} rows of a "
                             f"{rows}-row tensor, its band is {b[r]}:{b[r + 1]}")
        out = x.new_zeros((x.shape[0], x.shape[1], rows, x.shape[3]))
        out[:, :, b[r]:b[r + 1]] = x
        dist.all_reduce(out, group=mesh.model_group)
        ctx.band, ctx.mesh = (b[r], b[r + 1]), mesh
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.model_group)
        return grad[:, :, ctx.band[0]:ctx.band[1]], None, None


def gather_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """All ``rows`` global rows of a row-sharded NCHW tensor on every model
    rank, differentiable (SAGAN attention's pooled keys and values, which
    every pixel of the image attends to); ``x`` itself outside a spatial
    mesh."""
    m = dp.spatial()
    if m is None:
        return x
    return _Gather.apply(x, rows, m)


def nearest_source_rows(rows_in: int, rows_out: int) -> List[int]:
    """The input row that a nearest resize of ``rows_in`` rows to
    ``rows_out`` samples for each output row, ``floor((i + 0.5) * in /
    out)``: torch's ``nearest-exact`` rule, read from torch itself."""
    src = F.interpolate(torch.arange(rows_in, dtype=torch.float32).view(1, 1, -1, 1),
                        size=(rows_out, 1), mode="nearest-exact")
    return [int(v) for v in src.view(-1).tolist()]


def resize_labels(labels: torch.Tensor, size, rows: Optional[int] = None) -> torch.Tensor:
    """Nearest resize (``floor((i + 0.5) * in / out)``, as
    ``jax.image.resize(..., 'nearest')``) of NHW integer labels of ``rows``
    global rows to ``size`` (global rows, columns); the plain resize without
    ``rows`` or a spatial mesh. Under a spatial mesh each
    output row of this rank's band (:func:`bounds` of the output rows) takes
    the input row of its **global** source coordinate, which may lie on the
    next rank's band (224 -> 29: row 14 of rank 0's 15 reads row 112)."""
    rows_out, cols = int(size[0]), int(size[1])
    m = dp.spatial()
    if m is None or rows is None:
        out = F.interpolate(labels[:, None].float(), size=(rows_out, cols),
                            mode="nearest-exact")
        return out[:, 0].to(labels.dtype)
    src = nearest_source_rows(rows, rows_out)
    b = bounds(rows_out, m.model_size)
    reads = [(src[b[r]], src[b[r + 1] - 1] + 1) if b[r] < b[r + 1] else (rows + 1, rows + 2)
             for r in range(m.model_size)]
    xs = _Fetch.apply(labels[:, None], rows, reads, m)
    o0, o1 = b[m.model_rank], b[m.model_rank + 1]
    if o0 == o1:
        return labels.new_zeros((labels.shape[0], 0, cols))
    lo = reads[m.model_rank][0]
    picked = xs.index_select(2, torch.tensor([src[o] - lo for o in range(o0, o1)],
                                             device=labels.device))
    out = F.interpolate(picked.float(), size=(o1 - o0, cols), mode="nearest-exact")
    return out[:, 0].to(labels.dtype)


def upsample_nearest(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Nearest 2x upsample: output row ``i`` samples input row ``i // 2``."""
    if dp.spatial() is None:
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return _rowwise(x, rows, 2 * rows, lambda o0, o1: (o0 // 2, (o1 - 1) // 2 + 1),
                    lambda xs: F.interpolate(xs, scale_factor=2, mode="nearest"),
                    lambda lo: 2 * lo)


def upsample_bilinear(x: torch.Tensor, size, rows: int) -> torch.Tensor:
    """Bilinear resize with ``align_corners=True`` to ``size`` (global
    rows, columns) of an NCHW tensor of ``rows`` global rows: under a
    spatial mesh each output row interpolates between the two input rows
    around its **global** source coordinate (the rows of a band are not an
    image of their own), then the columns as ``F.interpolate`` does."""
    if dp.spatial() is None:
        return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
    rows_out, cols_out = int(size[0]), int(size[1])
    scale = (rows - 1) / (rows_out - 1) if rows_out > 1 else 0.0
    src = lambda o: o * scale

    def span(o0, o1):
        return math.floor(src(o0)), min(math.floor(src(o1 - 1)) + 2, rows)

    m = dp.spatial()
    b = bounds(rows_out, m.model_size)
    o0, o1 = b[m.model_rank], b[m.model_rank + 1]

    band = range(o0, o1) if o1 > o0 else range(0, 1)    # an empty band: one row of zeros

    def fn(xs):
        lo = math.floor(src(band[0]))
        y = torch.tensor([src(o) for o in band], dtype=torch.float64)
        i0 = (y.floor().long() - lo).clamp(max=xs.shape[2] - 1)
        i1 = (i0 + 1).clamp(max=xs.shape[2] - 1)
        frac = (y - y.floor()).to(xs.dtype).to(xs.device).view(1, 1, -1, 1)
        top = xs.index_select(2, i0.to(xs.device))
        bottom = xs.index_select(2, i1.to(xs.device))
        r = top + (bottom - top) * frac
        return F.interpolate(r, size=(r.shape[2], cols_out), mode="bilinear",
                             align_corners=True)

    return _rowwise(x, rows, rows_out, span, fn, lambda lo: o0)
