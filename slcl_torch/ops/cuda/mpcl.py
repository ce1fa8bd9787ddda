"""MPCL (margin-preserving contrastive loss): CUDA kernel wrapper and plain
version.

The kernel (``slcl_torch/csrc/mpcl.cu``) replaces
``slcl_tpu/ops/pallas/mpcl_kernel.py::mpcl_loss_fused``: it takes RAW
(M, F) features, normalises them per row, and returns the scalar loss; its
backward is a second kernel that recomputes each row and returns dfeats
(zero for the detached prototypes).

Under data parallelism (:mod:`slcl_torch.parallel.mesh`) the forward's
streaming pass and final pass run apart: the per-block (num, den) pairs are
all-reduced over the pixel group in between (the data ranks, and under
spatial partitioning the model ranks too: each holds a band of rows), so
the loss is the global
batch's (the mean over all ranks' rows, or the weighted sum over the global
``sum(sel) + 1e-4``), and the backward takes the global ``den`` and the sum
of the ranks' cotangents. The plain version reduces the same two sums.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import (F32, I32, IP, VP, build, check, choose, ptr, raise_on_error, register,
               stream_of)
from ...parallel import mesh as dp

FWD = register("mpcl_fwd", "slcl_torch/csrc/mpcl.cu",
               "slcl_tpu/ops/pallas/mpcl_kernel.py:134")
BWD = register("mpcl_bwd", "slcl_torch/csrc/mpcl.cu",
               "slcl_tpu/ops/pallas/mpcl_kernel.py:195")
# the general family (any C and F): csrc/general.cuh
FWD_GEN = register("mpcl_fwd_general", "slcl_torch/csrc/mpcl.cu + csrc/general.cuh",
                   "slcl_tpu/ops/pallas/mpcl_kernel.py:134")
BWD_GEN = register("mpcl_bwd_general", "slcl_torch/csrc/mpcl.cu + csrc/general.cuh",
                   "slcl_tpu/ops/pallas/mpcl_kernel.py:195")

_MARGIN = [F32, F32, F32, F32, F32, I32, F32]  # T, cos_m, sin_m, th, mm, easy, scale
_SIGS = {
    "mpcl_num_partials": (I32, [I32, I32, I32, IP]),
    "mpcl_fwd": (I32, [VP, I32, VP, VP, VP, I32, I32, I32, *_MARGIN, VP, VP, VP]),
    "mpcl_bwd": (I32, [VP, I32, VP, VP, VP, I32, I32, I32, *_MARGIN, VP, VP, VP, VP]),
    "mpcl_fwd_partial": (I32, [VP, I32, VP, VP, VP, I32, I32, I32, F32, F32, F32, F32, F32,
                               I32, VP, IP, VP]),
    "mpcl_fwd_final": (I32, [VP, I32, I32, I32, F32, VP, VP]),
    "mpcl_occupancy": (I32, [I32, I32, I32, IP, IP]),
}
# the general family's entries take the templated ones' arguments (the
# final pass is shared); its occupancy query also takes C
_SIGS.update({k.replace("mpcl_", "mpcl_gen_", 1): v for k, v in _SIGS.items()
              if k in ("mpcl_num_partials", "mpcl_fwd_partial", "mpcl_bwd")})
_SIGS["mpcl_gen_occupancy"] = (I32, [I32, I32, I32, I32, IP, IP])


def margin_consts(margin: float):
    """(cos m, sin m, th = cos(pi - m), mm = sin(pi - m) * m)."""
    return (math.cos(margin), math.sin(margin), math.cos(math.pi - margin),
            math.sin(math.pi - margin) * margin)


# ---------------------------------------------------------------------------
# plain version (follows slcl_tpu/ops/losses.py:225-320)
# ---------------------------------------------------------------------------
def mpcl_loss_normalized(features: torch.Tensor, labels: torch.Tensor,
                         class_centers: torch.Tensor, *, temperature: float = 0.07,
                         base_temperature: float = 0.07, margin: float = 0.5,
                         easy_margin: bool = False,
                         pixel_sel_loc: Optional[torch.Tensor] = None,
                         num_classes: int = 4) -> torch.Tensor:
    """MPCL over already L2-normalised (N, F) features and (C, F) prototypes
    (``losses.py::mpcl_loss``). Both row maxima are detached, as in jnp."""
    features = features.float()
    class_centers = class_centers.float()
    cos_m, sin_m, th, mm = margin_consts(margin)
    cosine = features @ class_centers.T
    logits = cosine / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 1e-4, 1.0))
    phi = cosine * cos_m - sine * sin_m
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine > th, phi, cosine - mm)
    phi_logits = phi / temperature
    phi_logits = phi_logits - phi_logits.max(dim=1, keepdim=True).values.detach()
    lab = labels.reshape(-1).long()
    valid = (lab >= 0) & (lab < num_classes)
    mask = F.one_hot(torch.where(valid, lab, 0), num_classes).float()
    mask = mask * valid[:, None].float()
    mixed = logits * (1.0 - mask) + phi_logits * mask
    log_prob = mixed - torch.log(torch.exp(mixed).sum(dim=1, keepdim=True) + 1e-4)
    mean_log_prob_pos = (mask * log_prob).sum(dim=1)
    scale = temperature / base_temperature
    if pixel_sel_loc is not None:
        sel = pixel_sel_loc.float().reshape(-1)
        num, den = (sel * mean_log_prob_pos).sum(), sel.sum()
        if dp.data_parallel():
            num, den = dp.all_sum(torch.stack([num, den]))
        return -scale * num / (den + 1e-4)
    return -scale * dp.gmean(mean_log_prob_pos)


def mpcl_plain(feats: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor,
               sel: Optional[torch.Tensor] = None, *, temperature: float = 0.1,
               base_temperature: float = 1.0, margin: float = 0.4,
               easy_margin: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: raw (M, F) feats are
    normalised as ``x / (||x|| + 1e-12)``, then :func:`mpcl_loss_normalized`."""
    f = feats.float()
    fn = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-12)
    return mpcl_loss_normalized(fn, labels, centers, temperature=temperature,
                                base_temperature=base_temperature, margin=margin,
                                easy_margin=easy_margin, pixel_sel_loc=sel,
                                num_classes=centers.shape[0])


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------
def _check_inputs(feats, labels, centers, sel):
    if feats.dim() != 2:
        raise ValueError(f"feats: expected (M, F), got {tuple(feats.shape)}")
    m, f = feats.shape
    dev = feats.device
    check(feats, "feats", (torch.bfloat16, torch.float32))
    check(labels, "labels", (torch.int32,), (m,), dev)
    check(centers, "centers", (torch.float32,), (centers.shape[0], f), dev)
    check(sel, "sel", (torch.float32,), (m,), dev)


def _args(feats, labels, centers, sel, T, margin, easy, scale):
    m, f = feats.shape
    return (ptr(feats), int(feats.dtype == torch.bfloat16), ptr(labels), ptr(sel),
            ptr(centers), m, f, centers.shape[0], T, *margin_consts(margin),
            int(easy), scale)


def _route(feats, centers, route):
    """(the C entries' prefix, the launch counters, the shape) of a call."""
    r, shape = choose(route, centers.shape[0], 1, feats.shape[1], feats.dtype, ("rows",))
    if r == "general":
        return "mpcl_gen_", (FWD_GEN, BWD_GEN), shape
    return "mpcl_", (FWD, BWD), shape


def mpcl_fwd_cuda(feats, labels, centers, sel, T, margin, easy, scale,
                  reduce=None, m_total: int = 0, route=None) -> torch.Tensor:
    """Launch the forward's streaming pass and final pass (the C entries
    ``mpcl_fwd_partial`` / ``_final``, which together launch what
    ``mpcl_fwd`` does); returns ``stats`` = [loss, sum(sel*mlpp), den].
    ``reduce`` (data parallelism) takes the streaming pass's (num, den)
    pairs in place between the two (their sum over the ranks), and the
    final pass averages over ``m_total`` rows when there is no ``sel``.
    ``route`` ("templated" / "general") overrides :func:`route`'s choice
    by shape (the general family at a shape the templated one takes)."""
    _check_inputs(feats, labels, centers, sel)
    pre, (counter, _), shape = _route(feats, centers, route)
    lib = build.load("mpcl", _SIGS)
    n_pairs = ctypes.c_int()
    bf16 = int(feats.dtype == torch.bfloat16)
    with torch.cuda.device(feats.device):
        if pre == "mpcl_":
            rc = lib.mpcl_num_partials(bf16, *feats.shape, ctypes.byref(n_pairs))
        else:
            rc = lib.mpcl_gen_num_partials(bf16, *feats.shape, ctypes.byref(n_pairs))
        raise_on_error(rc, pre + "num_partials", shape)
        parts = torch.empty(2 * n_pairs.value, dtype=torch.float32, device=feats.device)
        stats = torch.empty(3, dtype=torch.float32, device=feats.device)
        args = _args(feats, labels, centers, sel, T, margin, easy, scale)
        grid = ctypes.c_int()
        raise_on_error(getattr(lib, pre + "fwd_partial")(
            *args[:-1], ptr(parts), ctypes.byref(grid), stream_of(feats)),
            pre + "fwd_partial", shape)
        if reduce is not None:
            reduce(parts)
        rc = lib.mpcl_fwd_final(ptr(parts), grid.value, int(m_total or feats.shape[0]),
                                int(sel is not None), scale, ptr(stats), stream_of(feats))
    raise_on_error(rc, "mpcl_fwd_final")
    counter.launches += 1
    return stats


def mpcl_bwd_cuda(feats, labels, centers, sel, T, margin, easy, scale,
                  grad_out, stats, route=None) -> torch.Tensor:
    """Launch the backward; returns dfeats in feats' dtype."""
    _check_inputs(feats, labels, centers, sel)
    check(grad_out, "grad_out", (torch.float32,), (1,), feats.device)
    check(stats, "stats", (torch.float32,), (3,), feats.device)
    pre, (_, counter), shape = _route(feats, centers, route)
    lib = build.load("mpcl", _SIGS)
    dfeats = torch.empty_like(feats)
    with torch.cuda.device(feats.device):
        rc = getattr(lib, pre + "bwd")(
            *_args(feats, labels, centers, sel, T, margin, easy, scale), ptr(grad_out),
            ptr(stats), ptr(dfeats), stream_of(feats))
    raise_on_error(rc, pre + "bwd", shape)
    counter.launches += 1
    return dfeats


class _MPCLFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, labels, centers, sel, T, base_T, margin, easy):
        scale = T / base_T
        mesh = dp.kernel_mesh()
        stats = mpcl_fwd_cuda(feats, labels, centers, sel, T, margin, easy, scale,
                              m_total=feats.shape[0] * dp.pixel_size(), **dp.kernel_forward(mesh))
        ctx.save_for_backward(feats, labels, centers, sel, stats)
        ctx.consts = (T, margin, easy, scale)
        ctx.mesh = mesh
        return stats[0].clone()

    @staticmethod
    def backward(ctx, grad):
        feats, labels, centers, sel, stats = ctx.saved_tensors
        T, margin, easy, scale = ctx.consts
        dfeats = mpcl_bwd_cuda(feats, labels, centers, sel, T, margin, easy, scale,
                               dp.kernel_grad(ctx.mesh, grad), stats)
        dcenters = torch.zeros_like(centers) if ctx.needs_input_grad[2] else None
        return dfeats, None, dcenters, None, None, None, None, None


def mpcl(feats: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor,
         sel: Optional[torch.Tensor] = None, *, temperature: float = 0.1,
         base_temperature: float = 1.0, margin: float = 0.4,
         easy_margin: bool = False) -> torch.Tensor:
    """MPCL over raw (M, F) ``feats``, (M,) ``labels`` and (C, F) normalised
    ``centers``; ``sel`` (M,) weights the rows (loss / (sum(sel) + 1e-4)),
    else the mean over M. CUDA tensors go to the kernel (labels int32, sel
    float32, centers float32), CPU tensors to :func:`mpcl_plain`."""
    if feats.is_cuda:
        return _MPCLFn.apply(feats, labels, centers, sel, temperature,
                             base_temperature, margin, easy_margin)
    return mpcl_plain(feats, labels, centers, sel, temperature=temperature,
                      base_temperature=base_temperature, margin=margin,
                      easy_margin=easy_margin)
