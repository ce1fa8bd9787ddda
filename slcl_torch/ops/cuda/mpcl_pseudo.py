"""Fused target branch (pseudo-labels + gap mask + MPCL): CUDA kernel
wrapper and plain version.

The kernel (``slcl_torch/csrc/mpcl_pseudo.cu``) replaces
``slcl_tpu/ops/pallas/mpcl_pseudo_kernel.py::mpcl_pseudo_fused``: it takes
RAW (M, F) target features and (C, F) normalised prototypes, derives each
row's first-occurrence argmax label and top1-top2 gap mask from its own
cosines, and returns the scalar MPCL loss weighted by that mask. Its
backward is a second kernel that recomputes each row and returns dfeats;
labels and mask are selections and get no gradient, nor do the prototypes.
Under data parallelism its forward splits as MPCL's does (``mpcl.py``): the
denominator ``sum(sel) + 1e-4`` is the global batch's.
"""
from __future__ import annotations

import ctypes

import torch

from . import (F32, I32, IP, VP, build, check, choose, ptr, raise_on_error, register,
               stream_of)
from ...parallel import mesh as dp
from .mpcl import _MARGIN, margin_consts, mpcl_plain
from .pseudo_label import pseudo_label_plain

FWD = register("mpcl_pseudo_fwd", "slcl_torch/csrc/mpcl_pseudo.cu",
               "slcl_tpu/ops/pallas/mpcl_pseudo_kernel.py:156")
BWD = register("mpcl_pseudo_bwd", "slcl_torch/csrc/mpcl_pseudo.cu",
               "slcl_tpu/ops/pallas/mpcl_pseudo_kernel.py:179")
# the general family (any C and F): csrc/general.cuh
FWD_GEN = register("mpcl_pseudo_fwd_general",
                   "slcl_torch/csrc/mpcl_pseudo.cu + csrc/general.cuh",
                   "slcl_tpu/ops/pallas/mpcl_pseudo_kernel.py:156")
BWD_GEN = register("mpcl_pseudo_bwd_general",
                   "slcl_torch/csrc/mpcl_pseudo.cu + csrc/general.cuh",
                   "slcl_tpu/ops/pallas/mpcl_pseudo_kernel.py:179")

_SIGS = {
    "mpcl_pseudo_num_partials": (I32, [I32, I32, I32, IP]),
    "mpcl_pseudo_fwd": (I32, [VP, I32, VP, I32, I32, I32, *_MARGIN, F32, VP, VP, VP]),
    "mpcl_pseudo_bwd": (I32, [VP, I32, VP, I32, I32, I32, *_MARGIN, F32, VP, VP, VP,
                              VP]),
    "mpcl_pseudo_fwd_partial": (I32, [VP, I32, VP, I32, I32, I32, *_MARGIN[:-1], F32, VP,
                                      IP, VP]),
    "mpcl_pseudo_fwd_final": (I32, [VP, I32, I32, F32, VP, VP]),
    "mpcl_pseudo_occupancy": (I32, [I32, I32, I32, IP, IP]),
}
# the general family's entries take the templated ones' arguments (the
# final pass is shared); its occupancy query also takes C
_SIGS.update({k.replace("mpcl_pseudo_", "mpcl_pseudo_gen_", 1): v for k, v in _SIGS.items()
              if k in ("mpcl_pseudo_num_partials", "mpcl_pseudo_fwd_partial",
                       "mpcl_pseudo_bwd")})
_SIGS["mpcl_pseudo_gen_occupancy"] = (I32, [I32, I32, I32, I32, IP, IP])


def mpcl_pseudo_plain(feats: torch.Tensor, centers: torch.Tensor, *,
                      temperature: float = 0.1, base_temperature: float = 1.0,
                      margin: float = 0.2, easy_margin: bool = False,
                      pixel_sel_th: float = 0.25) -> torch.Tensor:
    """The kernel's function in plain PyTorch, the two-op composition that
    ``mpcl_pseudo_kernel.py:163-166`` names: pseudo-labels and gap mask from
    the detached features, then :func:`mpcl_plain` weighted by the mask."""
    labels, sel = pseudo_label_plain(feats, centers, pixel_sel_th)
    return mpcl_plain(feats, labels, centers, sel, temperature=temperature,
                      base_temperature=base_temperature, margin=margin,
                      easy_margin=easy_margin)


def _check_inputs(feats, centers):
    if feats.dim() != 2:
        raise ValueError(f"feats: expected (M, F), got {tuple(feats.shape)}")
    check(feats, "feats", (torch.bfloat16, torch.float32))
    check(centers, "centers", (torch.float32,), (centers.shape[0], feats.shape[1]),
          feats.device)


def _args(feats, centers, T, margin, easy, scale, sel_th):
    m, f = feats.shape
    return (ptr(feats), int(feats.dtype == torch.bfloat16), ptr(centers), m, f,
            centers.shape[0], T, *margin_consts(margin), int(easy), scale,
            float(sel_th))


def _route(feats, centers, route):
    """(the C entries' prefix, the launch counters, the shape) of a call."""
    r, shape = choose(route, centers.shape[0], 1, feats.shape[1], feats.dtype, ("rows",))
    if r == "general":
        return "mpcl_pseudo_gen_", (FWD_GEN, BWD_GEN), shape
    return "mpcl_pseudo_", (FWD, BWD), shape


def mpcl_pseudo_fwd_cuda(feats, centers, T, margin, easy, scale, sel_th,
                         reduce=None, route=None) -> torch.Tensor:
    """Launch the forward's streaming pass and final pass (the C entries
    ``mpcl_pseudo_fwd_partial`` / ``_final``, which together launch what
    ``mpcl_pseudo_fwd`` does); returns ``stats`` = [loss, sum(sel*mlpp),
    den]. ``reduce`` (data parallelism) takes the streaming pass's (num,
    den) pairs in place between the two (their sum over the ranks).
    ``route`` overrides the choice of family by shape."""
    _check_inputs(feats, centers)
    pre, (counter, _), shape = _route(feats, centers, route)
    lib = build.load("mpcl_pseudo", _SIGS)
    n_pairs = ctypes.c_int()
    bf16 = int(feats.dtype == torch.bfloat16)
    with torch.cuda.device(feats.device):
        if pre == "mpcl_pseudo_":
            rc = lib.mpcl_pseudo_num_partials(bf16, *feats.shape, ctypes.byref(n_pairs))
        else:
            rc = lib.mpcl_pseudo_gen_num_partials(bf16, *feats.shape, ctypes.byref(n_pairs))
        raise_on_error(rc, pre + "num_partials", shape)
        parts = torch.empty(2 * n_pairs.value, dtype=torch.float32, device=feats.device)
        stats = torch.empty(3, dtype=torch.float32, device=feats.device)
        args = _args(feats, centers, T, margin, easy, scale, sel_th)
        grid = ctypes.c_int()
        raise_on_error(getattr(lib, pre + "fwd_partial")(
            *args[:-2], args[-1], ptr(parts), ctypes.byref(grid), stream_of(feats)),
            pre + "fwd_partial", shape)
        if reduce is not None:
            reduce(parts)
        rc = lib.mpcl_pseudo_fwd_final(ptr(parts), grid.value, feats.shape[0], scale,
                                       ptr(stats), stream_of(feats))
    raise_on_error(rc, "mpcl_pseudo_fwd_final")
    counter.launches += 1
    return stats


def mpcl_pseudo_bwd_cuda(feats, centers, T, margin, easy, scale, sel_th,
                         grad_out, stats, route=None) -> torch.Tensor:
    """Launch the backward; returns dfeats in feats' dtype."""
    _check_inputs(feats, centers)
    check(grad_out, "grad_out", (torch.float32,), (1,), feats.device)
    check(stats, "stats", (torch.float32,), (3,), feats.device)
    pre, (_, counter), shape = _route(feats, centers, route)
    lib = build.load("mpcl_pseudo", _SIGS)
    dfeats = torch.empty_like(feats)
    with torch.cuda.device(feats.device):
        rc = getattr(lib, pre + "bwd")(
            *_args(feats, centers, T, margin, easy, scale, sel_th), ptr(grad_out),
            ptr(stats), ptr(dfeats), stream_of(feats))
    raise_on_error(rc, pre + "bwd", shape)
    counter.launches += 1
    return dfeats


class _MPCLPseudoFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, centers, T, base_T, margin, easy, sel_th):
        scale = T / base_T
        mesh = dp.kernel_mesh()
        stats = mpcl_pseudo_fwd_cuda(feats, centers, T, margin, easy, scale, sel_th,
                                     **dp.kernel_forward(mesh))
        ctx.save_for_backward(feats, centers, stats)
        ctx.consts = (T, margin, easy, scale, sel_th)
        ctx.mesh = mesh
        return stats[0].clone()

    @staticmethod
    def backward(ctx, grad):
        feats, centers, stats = ctx.saved_tensors
        T, margin, easy, scale, sel_th = ctx.consts
        dfeats = mpcl_pseudo_bwd_cuda(feats, centers, T, margin, easy, scale, sel_th,
                                      dp.kernel_grad(ctx.mesh, grad), stats)
        dcenters = torch.zeros_like(centers) if ctx.needs_input_grad[1] else None
        return dfeats, dcenters, None, None, None, None, None


def mpcl_pseudo(feats: torch.Tensor, centers: torch.Tensor, *,
                temperature: float = 0.1, base_temperature: float = 1.0,
                margin: float = 0.2, easy_margin: bool = False,
                pixel_sel_th: float = 0.25) -> torch.Tensor:
    """Target-branch MPCL over raw (M, F) ``feats`` and (C, F) normalised
    float32 ``centers``, with labels and mask derived from the features.
    CUDA tensors go to the kernel, CPU tensors to :func:`mpcl_pseudo_plain`."""
    if feats.is_cuda:
        return _MPCLPseudoFn.apply(feats, centers, temperature, base_temperature,
                                   margin, easy_margin, pixel_sel_th)
    return mpcl_pseudo_plain(feats, centers, temperature=temperature,
                             base_temperature=base_temperature, margin=margin,
                             easy_margin=easy_margin, pixel_sel_th=pixel_sel_th)
