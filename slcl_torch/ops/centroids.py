"""Class-centroid / pseudo-label engine, main-path subset.

Counterpart of ``slcl_tpu/ops/centroids.py``: EMA source class centres
(``update_class_center_iter`` for MPSCL/SLCL, ``source_centroids`` for
MCCL), cosine pseudo-labels, and soft (or hard) target centroids, with
their per-class stddevs on request, given the partition assignment as an
input. The pseudo-labels and the target
centroids go to CUDA kernels for CUDA tensors and to their plain versions
for CPU tensors. All reductions accumulate in float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda.pseudo_label import pseudo_label
from .cuda.soft_centroids import soft_centroids
from .losses import nearest_resize_labels

_EPS = 1e-7


class CentroidResult(NamedTuple):
    centroids: torch.Tensor    # (P, C, F)
    ratio: torch.Tensor        # scalar: fraction of pixels above threshold
    stddevs: Optional[torch.Tensor] = None   # (C,) when asked for (stdmin)


def _flatten_feats(decoder_ft: torch.Tensor):
    n, h, w, f = decoder_ft.shape
    return decoder_ft.reshape(n * h * w, f), (n, h, w)


def source_centroids(decoder_ft: torch.Tensor, labels: torch.Tensor, *,
                     num_classes: int = 4, previous: Optional[torch.Tensor] = None,
                     momentum: float = 0.95,
                     bootstrap: Optional[bool] = None) -> torch.Tensor:
    """Per-class means of the features under hard labels, ``sums / (counts
    + 1e-7)`` (an absent class gives a zero mean, not its previous centre),
    then, with ``previous``, the EMA ``momentum * previous + (1 - momentum)
    * means``; ``bootstrap`` (the first step without a centre file) returns
    the means alone. decoder_ft (N, H, W, F); labels (N, H', W') int,
    nearest-resized to the feature grid. Returns (C, F) float32; not
    detached."""
    feats, (n, h, w) = _flatten_feats(decoder_ft)
    feats = feats.float()
    if tuple(labels.shape[1:]) != (h, w):
        labels = nearest_resize_labels(labels, (h, w))
    onehot = F.one_hot(labels.reshape(-1).long(), num_classes).float()
    sums = onehot.T @ feats
    counts = onehot.sum(dim=0)[:, None]
    cents = sums / (counts + _EPS)
    if previous is None or bootstrap:
        return cents
    return momentum * previous.float() + (1.0 - momentum) * cents


def update_class_center_iter(decoder_ft: torch.Tensor, labels: torch.Tensor,
                             class_centers: torch.Tensor, *, momentum: float = 0.9,
                             num_classes: int = 4,
                             bootstrap: Optional[bool] = None) -> torch.Tensor:
    """Iteration-wise EMA of source class centres from detached features;
    classes absent from the batch keep their previous centre. ``bootstrap``
    (the first step from zero-initialised centres) adopts the batch means
    outright. decoder_ft (N, H, W, F); labels (N, H', W') int."""
    feats, (n, h, w) = _flatten_feats(decoder_ft.detach())
    feats = feats.float()
    if tuple(labels.shape[1:]) != (h, w):
        labels = nearest_resize_labels(labels, (h, w))
    onehot = F.one_hot(labels.reshape(-1).long(), num_classes).float()
    sums = onehot.T @ feats
    counts = onehot.sum(dim=0)[:, None]
    prev = class_centers.float()
    batch_means = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), prev)
    if bootstrap:
        return batch_means
    return momentum * prev + (1.0 - momentum) * batch_means


def generate_pseudo_label(decoder_ft_t: torch.Tensor, class_centers: torch.Tensor, *,
                          pixel_sel_th: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine pseudo-labels + top1-top2 gap mask for target pixels.
    decoder_ft_t (N, H, W, F) -> (labels (N*H*W,) int32, mask (N*H*W,) f32)."""
    feats, _ = _flatten_feats(decoder_ft_t.detach())
    return pseudo_label(feats.contiguous(), class_centers.detach(), pixel_sel_th)


def target_soft_centroids(decoder_ft: torch.Tensor, soft_label: torch.Tensor, *,
                          partition: int = 1, assign: Optional[torch.Tensor] = None,
                          threshold: float = 0.0, weighted_ave: bool = True,
                          num_classes: int = 4, with_std: bool = False) -> CentroidResult:
    """Soft-labelled (and partitioned) target centroids. decoder_ft
    (N, H, W, F); soft_label (N, H, W, C) softmax probs at the feature
    resolution; ``assign`` (N*H*W,) partition ids in [0, P), required when
    ``partition > 1``. Returns centroids of shape (P, C, F), and with
    ``with_std`` the per-class stddevs (C,) around partition 0's centroid
    over all partitions' weights (MCCL's stdmin), from the same pass."""
    feats, (n, h, w) = _flatten_feats(decoder_ft)
    if tuple(soft_label.shape[1:3]) != (h, w):
        raise ValueError("soft_label must be at the feature resolution "
                         f"{(h, w)}, got {tuple(soft_label.shape[1:3])}")
    probs = soft_label.float().reshape(-1, num_classes)
    if assign is not None and feats.is_cuda:
        assign = assign.to(torch.int32).contiguous()
    return CentroidResult(*soft_centroids(feats.contiguous(), probs.contiguous(), assign,
                                          partition=partition, threshold=threshold,
                                          weighted=weighted_ave, with_std=with_std))
