"""Class-centroid / pseudo-label engine.

Counterpart of ``slcl_tpu/ops/centroids.py``: EMA source class centres
(``update_class_center_iter`` for MPSCL/SLCL, ``source_centroids`` for
MCCL), cosine pseudo-labels, and soft (or hard) target centroids, with
their per-class stddevs on request, given the partition assignment as an
input. The pseudo-labels and the target
centroids go to CUDA kernels for CUDA tensors and to their plain versions
for CPU tensors. All reductions accumulate in float32. BCL's per-round
pseudo-labels: class-balanced thresholds (``gene_thres``, numpy on the
host), ``thres_cb_plabel``, ``gene_plabel_prop``, ``mask_fusion`` and
``pseudo_label_accuracy``.

Under data parallelism the source centres' per-class sums and counts are
all-summed over the pixel group before the division (the global batch's
means); the target centroids reduce inside :func:`soft_centroids`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda.pseudo_label import pseudo_label
from .cuda.soft_centroids import soft_centroids
from ..parallel import mesh as dp
from ..parallel.spatial import resize_labels

_EPS = 1e-7


def _class_sums(onehot: torch.Tensor, feats: torch.Tensor):
    """(sums (C, F), counts (C, 1)) of the rows per class, over the global
    batch under data parallelism (one all-reduce)."""
    sums = onehot.T @ feats
    counts = onehot.sum(dim=0)[:, None]
    if dp.data_parallel():
        sums, counts = dp.all_sum(torch.cat([sums, counts], dim=1)).split(
            [feats.shape[1], 1], dim=1)
    return sums, counts


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
        labels = resize_labels(labels, (h, w))
    onehot = F.one_hot(labels.reshape(-1).long(), num_classes).float()
    sums, counts = _class_sums(onehot, feats)
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
        labels = resize_labels(labels, (h, w))
    onehot = F.one_hot(labels.reshape(-1).long(), num_classes).float()
    sums, counts = _class_sums(onehot, feats)
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


# ---------------------------------------------------------------------------
# BCL pseudo-labels (reference utils_.py:1179-1296, Trainer_BCL.py:165-220)
# ---------------------------------------------------------------------------
def thres_cb_plabel(probs: torch.Tensor, thresholds: torch.Tensor,
                    num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-balanced pseudo-labels from NHWC softmax ``probs`` and (C,)
    thresholds: the argmax where its probability reaches its class's
    threshold, else 255; returns (plabel NHW int64, mask NHW float32)."""
    conf, pred = probs.max(dim=-1)
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=probs.device)[pred]
    mask = conf.float() >= th
    return torch.where(mask, pred, torch.full_like(pred, 255)), mask.float()


def gene_plabel_prop(probs: torch.Tensor, prop: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each image's most confident ``prop`` fraction of pixels keeps its
    argmax (ties at the k-th value kept too), 255 elsewhere; probs NHWC."""
    conf, pred = probs.max(dim=-1)
    flat = conf.reshape(conf.shape[0], -1)
    k = max(int(prop * flat.shape[1]), 1)
    kth = flat.topk(k, dim=1).values[:, -1:]
    mask = (flat >= kth).reshape(conf.shape)
    return torch.where(mask, pred, torch.full_like(pred, 255)), mask.float()


def mask_fusion(plabel_a: torch.Tensor, plabel_b: torch.Tensor) -> torch.Tensor:
    """Agreement of two pseudo-label maps, 255 where they differ."""
    return torch.where(plabel_a == plabel_b, plabel_a, torch.full_like(plabel_a, 255))


def pseudo_label_accuracy(plabel: torch.Tensor, label: torch.Tensor,
                          ignore: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """(accuracy over the non-ignored pixels, their share of all pixels)."""
    valid = plabel != ignore
    correct = valid & (plabel == label)
    return (correct.sum() / torch.clamp(valid.sum(), min=1),
            valid.float().mean())


def gene_thres(probs_flat, labels_flat, prop: float, num_classes: int) -> np.ndarray:
    """Per-class thresholds on the host (numpy): for each class, the linear
    ``1 - prop`` quantile of the max-probabilities of the pixels predicted as
    it, capped at 0.999; 1.0 for a class no pixel predicts. (C,) float32."""
    probs_flat = np.asarray(probs_flat)
    labels_flat = np.asarray(labels_flat)
    th = np.zeros((num_classes,), np.float32)
    for k in range(num_classes):
        vals = probs_flat[labels_flat == k]
        if vals.size == 0:
            th[k] = 1.0
        else:
            th[k] = min(float(np.quantile(vals, max(0.0, 1.0 - prop))), 0.999)
    return th
