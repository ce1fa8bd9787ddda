"""Soft (or hard) class centroids per partition: CUDA kernel wrapper, its
backward, and plain version.

The forward kernel (``slcl_torch/csrc/soft_centroids.cu``) replaces
``slcl_tpu/ops/pallas/centroid_kernel.py::soft_centroids_fused``. That TPU
kernel is forward-only; CNR backpropagates through the target centroids
into the features (and, with soft weights, into the probabilities), which
jnp autodiff does on the JAX main path, so the port adds a backward kernel.
With ``with_std`` both kernels also take MCCL's per-class feature spread
around partition 0's centroid (``CentroidResult.stddevs``,
``slcl_tpu/ops/centroids.py:137-146``) and its gradient, in the same pass.

Under data parallelism (:mod:`slcl_torch.parallel.mesh`) the forward splits
where the TPU kernel ends: the streaming pass gives each block's partition
sums, weight totals, certain-pixel count (and with the std Σw·x², raw
moments, so one reduction serves), those are all-reduced over the pixel
group (the data ranks, times the model ranks under spatial partitioning),
and the final pass divides by the global totals; the backward sums the
cotangents over the ranks and runs on the global centroids and counts.
The plain version takes the same split.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import (F32, I32, IP, VP, build, check, choose, ptr, raise_on_error, register,
               stream_of)
from ...parallel import mesh as dp

FWD = register("soft_centroids_fwd", "slcl_torch/csrc/soft_centroids.cu",
               "slcl_tpu/ops/pallas/centroid_kernel.py:64")
BWD = register("soft_centroids_bwd", "slcl_torch/csrc/soft_centroids.cu",
               "slcl_tpu/ops/centroids.py:76 (jnp autodiff; the Pallas kernel has no bwd)")
# the std variant (MCCL's stdmin): kernels of their own, counted apart
FWD_STD = register("soft_centroids_fwd_std", "slcl_torch/csrc/soft_centroids.cu",
                   "slcl_tpu/ops/pallas/centroid_kernel.py:64 with the stddevs of "
                   "slcl_tpu/ops/centroids.py:137-146")
BWD_STD = register("soft_centroids_bwd_std", "slcl_torch/csrc/soft_centroids.cu",
                   "slcl_tpu/ops/centroids.py:76,137-146 (jnp autodiff of the centroids "
                   "and stddevs; the Pallas kernel has no bwd)")

# the general family (any C, P and F): csrc/centroids_gen.cuh, the same
# four rows
_GEN = "slcl_torch/csrc/soft_centroids.cu + csrc/centroids_gen.cuh"
FWD_GEN = register("soft_centroids_fwd_general", _GEN, FWD.replaces)
BWD_GEN = register("soft_centroids_bwd_general", _GEN, BWD.replaces)
FWD_STD_GEN = register("soft_centroids_fwd_std_general", _GEN, FWD_STD.replaces)
BWD_STD_GEN = register("soft_centroids_bwd_std_general", _GEN, BWD_STD.replaces)
# (forward, backward) counters by (family, std)
_COUNTERS = {("templated", False): (FWD, BWD), ("templated", True): (FWD_STD, BWD_STD),
             ("general", False): (FWD_GEN, BWD_GEN), ("general", True): (FWD_STD_GEN, BWD_STD_GEN)}

_EPS = 1e-7
_SIGS = {
    "soft_centroids_partials_size": (I32, [I32, I32, I32, I32, I32, I32, IP]),
    "soft_centroids_fwd": (I32, [VP, I32, VP, VP, I32, I32, I32, I32, F32, I32,
                                 VP, VP, VP, VP, VP, VP, VP]),
    "soft_centroids_bwd": (I32, [VP, I32, VP, VP, I32, I32, I32, I32, F32, I32,
                                 VP, VP, VP, VP, VP, VP, VP, VP, VP]),
    "soft_centroids_fwd_partial": (I32, [VP, I32, VP, VP, I32, I32, I32, I32, F32, I32, I32,
                                         VP, IP, VP]),
    "soft_centroids_fwd_final": (I32, [VP, I32, I32, I32, I32, I32, VP, VP, VP, VP, VP, VP]),
    "soft_centroids_occupancy": (I32, [I32, I32, I32, I32, I32, IP, IP]),
}
# the general family's entries take the templated ones' arguments; its
# occupancy query also takes C and, for the backward's form, with_dprobs
_SIGS.update({k.replace("soft_centroids_", "soft_centroids_gen_", 1): v
              for k, v in _SIGS.items()
              if k in ("soft_centroids_partials_size", "soft_centroids_fwd_partial",
                       "soft_centroids_fwd_final", "soft_centroids_bwd")})
_SIGS["soft_centroids_gen_occupancy"] = (I32, [I32, I32, I32, I32, I32, I32, I32, IP, IP])


def certain_mask(probs: torch.Tensor, threshold: float) -> torch.Tensor:
    """1 where max prob >= threshold (only when 0 < threshold < 1), else 1."""
    if 0.0 < threshold < 1.0:
        return (probs.max(dim=-1).values >= threshold).float()
    return torch.ones(probs.shape[0], dtype=torch.float32, device=probs.device)


def soft_centroids_plain(feats: torch.Tensor, probs: torch.Tensor,
                         assign: Optional[torch.Tensor] = None, *, partition: int = 1,
                         threshold: float = 0.0, weighted: bool = True,
                         with_std: bool = False) -> Tuple[torch.Tensor, ...]:
    """(M, F) feats, (M, C) probs, (M,) partition ids -> (centroids (P, C, F),
    ratio), and with ``with_std`` the per-class stddevs (C,) third.
    Differentiable by autograd. Follows
    ``slcl_tpu/ops/centroids.py::target_soft_centroids`` with the partition
    assignment given: the stddevs take the weights of all partitions,
    W = sum w + 1e-7 and S2 = sum w f^2, around partition 0's centroid,
    std = sqrt(mean_f max(S2 / W - c0^2, 0) + 1e-7). A row whose id lies
    outside [0, P) has no weight in either. Under data parallelism the sums
    (sums, counts, certain rows, and W and S2) are all-summed over the data
    ranks before the divisions: the global batch's centroids."""
    feats = feats.float()
    probs = probs.float()
    C = probs.shape[1]
    certain = certain_mask(probs, threshold)
    if weighted:
        weights = probs * certain[:, None]
    else:
        hard = F.one_hot(torch.argmax(probs, dim=-1), C).float()
        weights = hard * certain[:, None]
    if partition > 1:
        if assign is None:
            raise ValueError("assign is required when partition > 1 (rMC)")
        a = assign.long()
        ok = (a >= 0) & (a < partition)
        part = F.one_hot(torch.where(ok, a, 0), partition).float() * ok[:, None].float()
        w_pc = weights[:, None, :] * part[:, :, None]
        w_flat = w_pc.reshape(-1, partition * C)
        sums = (w_flat.T @ feats).reshape(partition, C, -1)
        counts = w_flat.sum(dim=0).reshape(partition, C, 1)
        weights = w_pc.sum(dim=1)       # the rows' weights in any partition
    else:
        sums = (weights.T @ feats)[None]
        counts = weights.sum(dim=0)[None, :, None]
    if with_std:
        w_total = weights.sum(dim=0)[:, None]
        s2 = weights.T @ (feats * feats)
    if dp.data_parallel():
        f = feats.shape[1]
        parts = [sums.reshape(-1), counts.reshape(-1), certain.sum()[None]]
        if with_std:
            parts += [w_total.reshape(-1), s2.reshape(-1)]
        flat = dp.all_sum(torch.cat(parts))
        n = [partition * C * f, partition * C, 1] + ([C, C * f] if with_std else [])
        pieces = torch.split(flat, n)
        sums = pieces[0].reshape(partition, C, f)
        counts = pieces[1].reshape(partition, C, 1)
        ratio = pieces[2][0] / (feats.shape[0] * dp.pixel_size())
        if with_std:
            w_total, s2 = pieces[3].reshape(C, 1), pieces[4].reshape(C, f)
    else:
        ratio = certain.mean()
    cents = sums / (counts + _EPS)
    if not with_std:
        return cents, ratio
    mean_sq = s2 / (w_total + _EPS)
    var = torch.maximum(mean_sq - cents[0] * cents[0], torch.zeros_like(mean_sq))
    return cents, ratio, torch.sqrt(var.mean(dim=-1) + _EPS)


def _check_inputs(feats, probs, assign, partition):
    if feats.dim() != 2 or probs.dim() != 2 or probs.shape[0] != feats.shape[0]:
        raise ValueError(f"feats (M, F) / probs (M, C) expected, got "
                         f"{tuple(feats.shape)} / {tuple(probs.shape)}")
    m = feats.shape[0]
    check(feats, "feats", (torch.bfloat16, torch.float32))
    check(probs, "probs", (torch.float32,), None, feats.device)
    if partition > 1:
        if assign is None:
            raise ValueError("assign is required when partition > 1 (rMC)")
        check(assign, "assign", (torch.int32,), (m,), feats.device)


def _route(feats, probs, partition, with_std, route):
    """(the C entries' prefix, the (forward, backward) counters, the shape)
    of a call."""
    r, shape = choose(route, probs.shape[1], partition, feats.shape[1], feats.dtype,
                      ("centroid_fwd", "centroid_final", "centroid_bwd"), bool(with_std))
    pre = "soft_centroids_" if r == "templated" else "soft_centroids_gen_"
    return pre, _COUNTERS[(r, bool(with_std))], shape


def soft_centroids_fwd_cuda(feats, probs, assign, partition, threshold, weighted,
                            with_std: bool = False, reduce=None, m_total: int = 0,
                            route=None):
    """Launch the forward's two kernels, the streaming pass and the final
    pass (the C entries ``soft_centroids_fwd_partial`` / ``_final``, which
    together launch what ``soft_centroids_fwd`` does); returns (centroids
    (P, C, F), counts (P*C,), ratio), and with ``with_std`` also (stddevs
    (C,), S2 (C, F)): the std variant. ``reduce`` (data parallelism) takes
    the streaming pass's partials in place between the two (their sum over
    the ranks), and the final pass divides by the totals of ``m_total``
    rows. ``route`` overrides the choice of family by shape."""
    _check_inputs(feats, probs, assign, partition)
    m, f = feats.shape
    C = probs.shape[1]
    pre, (counter, _), shape = _route(feats, probs, partition, with_std, route)
    lib = build.load("soft_centroids", _SIGS)
    dev = feats.device
    bf16 = int(feats.dtype == torch.bfloat16)
    n_part = ctypes.c_int()
    with torch.cuda.device(dev):
        if pre == "soft_centroids_":
            rc = lib.soft_centroids_partials_size(bf16, m, f, partition, C, int(with_std),
                                                  ctypes.byref(n_part))
        else:
            rc = lib.soft_centroids_gen_partials_size(bf16, m, f, partition, C,
                                                      int(with_std), ctypes.byref(n_part))
        raise_on_error(rc, pre + "partials_size", shape)
        parts = torch.empty(n_part.value, dtype=torch.float32, device=dev)
        cents = torch.empty((partition, C, f), dtype=torch.float32, device=dev)
        counts = torch.empty(partition * C, dtype=torch.float32, device=dev)
        ratio = torch.empty((), dtype=torch.float32, device=dev)
        std = torch.empty(C, dtype=torch.float32, device=dev) if with_std else None
        s2 = torch.empty((C, f), dtype=torch.float32, device=dev) if with_std else None
        grid = ctypes.c_int()
        raise_on_error(getattr(lib, pre + "fwd_partial")(
            ptr(feats), bf16, ptr(probs), ptr(assign) if partition > 1 else None, m, f, C,
            partition, float(threshold), int(weighted), int(with_std), ptr(parts),
            ctypes.byref(grid), stream_of(feats)), pre + "fwd_partial", shape)
        if reduce is not None:
            reduce(parts)
        rc = getattr(lib, pre + "fwd_final")(
            ptr(parts), grid.value, int(m_total or m), f, C, partition, ptr(cents),
            ptr(counts), ptr(ratio), ptr(s2), ptr(std), stream_of(feats))
    raise_on_error(rc, pre + "fwd_final", shape)
    counter.launches += 1
    if with_std:
        return cents, counts, ratio, std, s2
    return cents, counts, ratio


def soft_centroids_bwd_cuda(feats, probs, assign, partition, threshold, weighted,
                            dcents, cents, counts, need_dprobs: bool,
                            dstd=None, std=None, s2=None, route=None):
    """Launch the backward; returns (dfeats in feats' dtype, dprobs or None).
    ``dstd`` (C,) takes the std variant, with the forward's ``std`` and ``s2``.
    ``route`` overrides the choice of family by shape."""
    _check_inputs(feats, probs, assign, partition)
    m, f = feats.shape
    C = probs.shape[1]
    dev = feats.device
    check(dcents, "dcents", (torch.float32,), (partition, C, f), dev)
    check(cents, "cents", (torch.float32,), (partition, C, f), dev)
    check(counts, "counts", (torch.float32,), (partition * C,), dev)
    if dstd is not None:
        check(dstd, "dstd", (torch.float32,), (C,), dev)
        check(std, "std", (torch.float32,), (C,), dev)
        check(s2, "s2", (torch.float32,), (C, f), dev)
    pre, (_, counter), shape = _route(feats, probs, partition, dstd is not None, route)
    lib = build.load("soft_centroids", _SIGS)
    dfeats = torch.empty_like(feats)
    dprobs = (torch.empty_like(probs) if (need_dprobs and weighted) else None)
    with torch.cuda.device(dev):
        rc = getattr(lib, pre + "bwd")(
            ptr(feats), int(feats.dtype == torch.bfloat16), ptr(probs),
            ptr(assign) if partition > 1 else None, m, f, C, partition,
            float(threshold), int(weighted), ptr(dcents), ptr(cents), ptr(counts),
            ptr(dfeats), ptr(dprobs), ptr(dstd),
            ptr(s2) if dstd is not None else None,
            ptr(std) if dstd is not None else None, stream_of(feats))
    raise_on_error(rc, pre + "bwd", shape)
    counter.launches += 1
    return dfeats, dprobs          # hard weights: None, no gradient to probs


class _SoftCentroidsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, probs, assign, partition, threshold, weighted, with_std):
        mesh = dp.kernel_mesh()
        out = soft_centroids_fwd_cuda(feats, probs, assign, partition, threshold,
                                      weighted, with_std,
                                      m_total=feats.shape[0] * dp.pixel_size(),
                                      **dp.kernel_forward(mesh))
        cents, counts, ratio = out[:3]
        ctx.save_for_backward(feats, probs, assign, cents, counts, *out[3:])
        ctx.consts = (partition, threshold, weighted)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(ratio)
        # an output the loss does not use gets None, not zeros: the backward
        # then takes the std variant only when the std has a gradient
        ctx.set_materialize_grads(False)
        return (cents, ratio, out[3]) if with_std else (cents, ratio)

    @staticmethod
    def backward(ctx, dcents, _dratio, dstd=None):
        feats, probs, assign, cents, counts, *std_s2 = ctx.saved_tensors
        partition, threshold, weighted = ctx.consts
        dcents = torch.zeros_like(cents) if dcents is None else dcents.float().contiguous()
        std_args = {}
        if dstd is not None:
            std_args = dict(dstd=dstd.float().contiguous(), std=std_s2[0], s2=std_s2[1])
        if ctx.mesh is not None:
            # the global centroids' cotangent: the sum of every rank's
            dcents = dp.sum_over(ctx.mesh, dcents.clone())
            if dstd is not None:
                std_args["dstd"] = dp.sum_over(ctx.mesh, std_args["dstd"].clone())
        dfeats, dprobs = soft_centroids_bwd_cuda(
            feats, probs, assign, partition, threshold, weighted, dcents, cents, counts,
            ctx.needs_input_grad[1], **std_args)
        return dfeats, dprobs, None, None, None, None, None


def soft_centroids(feats: torch.Tensor, probs: torch.Tensor,
                   assign: Optional[torch.Tensor] = None, *, partition: int = 1,
                   threshold: float = 0.0, weighted: bool = True,
                   with_std: bool = False) -> Tuple[torch.Tensor, ...]:
    """(centroids (P, C, F), ratio), and with ``with_std`` the stddevs (C,).
    CUDA tensors go to the kernels (probs float32, assign int32), CPU tensors
    to :func:`soft_centroids_plain`."""
    if feats.is_cuda:
        return _SoftCentroidsFn.apply(feats, probs, assign, partition,
                                      float(threshold), bool(weighted), bool(with_std))
    return soft_centroids_plain(feats, probs, assign, partition=partition,
                                threshold=threshold, weighted=weighted,
                                with_std=with_std)
