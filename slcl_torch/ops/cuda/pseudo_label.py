"""Cosine pseudo-labels + top1-top2 gap mask: CUDA kernel wrapper and plain
version.

The kernel (``slcl_torch/csrc/pseudo_label.cu``) replaces
``slcl_tpu/ops/pallas/pseudo_label_kernel.py::pseudo_label_fused``. No
gradient: both inputs are detached.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import (F32, I32, IP, VP, build, check, choose, ptr, raise_on_error, register,
               stream_of)

KERNEL = register("pseudo_label", "slcl_torch/csrc/pseudo_label.cu",
                  "slcl_tpu/ops/pallas/pseudo_label_kernel.py:31")
# the general family (any C and F): csrc/general.cuh
KERNEL_GEN = register("pseudo_label_general",
                      "slcl_torch/csrc/pseudo_label.cu + csrc/general.cuh",
                      "slcl_tpu/ops/pallas/pseudo_label_kernel.py:31")

_SIGS = {"pseudo_label": (I32, [VP, I32, VP, I32, I32, I32, F32, VP, VP, VP]),
         "pseudo_label_occupancy": (I32, [I32, I32, IP, IP])}
# the general kernel takes the templated one's arguments; its occupancy
# query also takes C
_SIGS["pseudo_label_gen"] = _SIGS["pseudo_label"]
_SIGS["pseudo_label_gen_occupancy"] = (I32, [I32, I32, I32, IP, IP])


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """``x / (||x|| + 1e-12)`` over the last dim, in f32 (the jnp form)."""
    x = x.float()
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def pseudo_label_plain(feats: torch.Tensor, centers: torch.Tensor,
                       pixel_sel_th: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, F) raw feats, (C, F) raw centres -> (labels (M,) int32 first-
    occurrence argmax, mask (M,) f32 = top1 - top2 > th). Follows
    ``slcl_tpu/ops/centroids.py::generate_pseudo_label``."""
    cosine = normalize_rows(feats.detach()) @ normalize_rows(centers.detach()).T
    top2 = torch.topk(cosine, 2, dim=1).values
    mask = ((top2[:, 0] - top2[:, 1]) > pixel_sel_th).float()
    return torch.argmax(cosine, dim=1).to(torch.int32), mask


def pseudo_label_cuda(feats: torch.Tensor, centers: torch.Tensor,
                      pixel_sel_th: float = 0.25,
                      route=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel of the family :func:`route` picks by shape (or
    ``route``, "templated" / "general")."""
    if feats.dim() != 2:
        raise ValueError(f"feats: expected (M, F), got {tuple(feats.shape)}")
    m, f = feats.shape
    check(feats, "feats", (torch.bfloat16, torch.float32))
    cen = normalize_rows(centers.detach()).contiguous()
    check(cen, "centers", (torch.float32,), (cen.shape[0], f), feats.device)
    C = cen.shape[0]
    r, shape = choose(route, C, 1, f, feats.dtype, ("rows",))
    entry, counter = ("pseudo_label", KERNEL) if r == "templated" else ("pseudo_label_gen",
                                                                        KERNEL_GEN)
    labels = torch.empty(m, dtype=torch.int32, device=feats.device)
    mask = torch.empty(m, dtype=torch.float32, device=feats.device)
    lib = build.load("pseudo_label", _SIGS)
    with torch.cuda.device(feats.device):
        rc = getattr(lib, entry)(ptr(feats), int(feats.dtype == torch.bfloat16), ptr(cen),
                                 m, f, C, float(pixel_sel_th), ptr(labels), ptr(mask),
                                 stream_of(feats))
    raise_on_error(rc, entry, shape)
    counter.launches += 1
    return labels, mask


def pseudo_label(feats: torch.Tensor, centers: torch.Tensor,
                 pixel_sel_th: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if feats.is_cuda:
        return pseudo_label_cuda(feats.detach(), centers, pixel_sel_th)
    return pseudo_label_plain(feats, centers, pixel_sel_th)
