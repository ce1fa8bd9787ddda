"""Segmentation / adversarial / contrastive / BCL / Chamfer losses.

Counterpart of ``slcl_tpu/ops/losses.py``: logits and features NHWC, labels
NHW, class centres (C, F); every loss accumulates in float32 whatever the
activation dtype. ``mpcl_loss_calc`` and ``mpcl_pseudo_loss`` send CUDA
tensors to their kernels and CPU tensors to the plain versions.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda.mpcl import mpcl, mpcl_loss_normalized as mpcl_loss  # noqa: F401
from .cuda.mpcl_pseudo import mpcl_pseudo

_EPS = 1e-7


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean pixel-wise CE; logits NHWC, labels NHW int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def jaccard_loss(logits: torch.Tensor, labels: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Soft IoU over softmax probs vs one-hot labels, per class over (B,H,W)."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    dims = tuple(range(labels.dim()))
    intersection = (probs * onehot).sum(dim=dims)
    union = (probs + onehot).sum(dim=dims) - intersection
    return 1.0 - (intersection / (union + eps)).mean()


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over the pixels whose label is not ``ignore_index`` (BCL's
    pseudo-label CE); 0 when every pixel is ignored. logits NHWC, labels NHW."""
    valid = (labels != ignore_index).float()
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def loss_calc(logits: torch.Tensor, labels: torch.Tensor, jaccard: bool = False) -> torch.Tensor:
    """CE (+ optional Jaccard)."""
    loss = cross_entropy_loss(logits, labels)
    if jaccard:
        loss = loss + jaccard_loss(logits, labels)
    return loss


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Soft squared-denominator Dice: per-(batch, class) 2*sum(p*g) /
    (sum(p^2) + sum(g^2) + eps), summed over classes, averaged over batch,
    then ``1 - total/C``."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    spatial = tuple(range(1, labels.dim()))
    num = (probs * onehot).sum(dim=spatial)
    den1 = (probs * probs).sum(dim=spatial)
    den2 = (onehot * onehot).sum(dim=spatial)
    dice = 2.0 * num / (den1 + den2 + eps)
    return 1.0 - dice.sum() / dice.shape[0] / num_classes


def loss_entropy(probs: torch.Tensor, smooth: float = 1e-7, mode: str = "mean") -> torch.Tensor:
    """Normalised entropy minimisation (the AdvEnt direct term):
    ``-1/log(C) * sum_c p log(p + smooth)`` per pixel, averaged over all
    pixels ('mean') or summed per sample then averaged ('sum'). probs NHWC."""
    probs = probs.float()
    pix = (-1.0 / math.log(probs.shape[-1])) * (probs * torch.log(probs + smooth)).sum(dim=-1)
    if mode == "mean":
        return pix.mean()
    if mode == "sum":
        return pix.sum(dim=tuple(range(1, pix.dim()))).mean()
    raise NotImplementedError(mode)


def loss_class_prior(probs: torch.Tensor, prior, w: float) -> torch.Tensor:
    """Hinge on the predicted class marginals: ``sum(relu(w*prior - mean))``,
    the mean over every axis but the class one. probs NHWC."""
    probs = probs.float()
    marginal = probs.mean(dim=tuple(range(probs.dim() - 1)))
    prior = torch.as_tensor(prior, dtype=torch.float32, device=probs.device)
    return torch.relu(w * prior - marginal).sum()


def prob_2_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Per-pixel weighted self-information ``-p * log2(p+eps) / log2(C)``."""
    probs = probs.float()
    return -probs * torch.log2(probs + _EPS) / math.log2(probs.shape[-1])


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross entropy with logits against a constant target."""
    x = logits.float()
    return (torch.clamp(x, min=0) - x * target + torch.log1p(torch.exp(-x.abs()))).mean()


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared difference, in float32."""
    return ((a.float() - b.float()) ** 2).mean()


def bcl_entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """BCL's per-pixel entropy map (NHW) from NHWC logits: the softmax p,
    then ``-sum p * log_softmax(p)`` -- the log-softmax *of the
    probabilities*, as the reference (utils/loss.py:121-130) has it."""
    p = torch.softmax(logits.float(), dim=-1)
    return -(p * F.log_softmax(p, dim=-1)).sum(dim=-1)


def bcl_prototype_similarity(feature: torch.Tensor, label_small: torch.Tensor,
                             feature2: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, h, w): the class prototypes of ``feature`` (h, w, F) under
    ``label_small`` (h, w; 255 ignored; an absent class has a zero
    prototype), unit rows, against ``feature2``'s pixels, each feature
    column normalised over the *pixels* (axis 0, as the reference's
    cosine_similarity_BCL does); exact-zero cosines become -1, then x10."""
    h, w, f = feature.shape
    lab = label_small.reshape(-1).long()
    feat = feature.float().reshape(-1, f)
    onehot = F.one_hot(torch.where(lab == 255, torch.full_like(lab, num_classes), lab),
                       num_classes + 1).float()[:, :num_classes]
    counts = onehot.sum(dim=0)
    protos = (onehot.T @ feat) / torch.clamp(counts[:, None], min=1.0)
    protos = torch.where(counts[:, None] > 0, protos, torch.zeros_like(protos))
    protos_n = protos / (torch.linalg.vector_norm(protos, dim=1, keepdim=True) + 1e-12)
    feat2 = feature2.float().reshape(-1, f)
    feat2_n = feat2 / (torch.linalg.vector_norm(feat2, dim=0, keepdim=True) + 1e-12)
    cs = protos_n @ feat2_n.T
    cs = torch.where(cs == 0, torch.full_like(cs, -1.0), cs)
    return (cs * 10.0).reshape(num_classes, h, w)


def batch_pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (B, N, M) between point sets (B, N, D) and (B, M, D),
    ``|x|^2 + |y|^2 - 2 x.y`` clipped at 0 (reference utils/loss.py:608-620)."""
    x, y = x.float(), y.float()
    xx = (x * x).sum(dim=-1)[:, :, None]
    yy = (y * y).sum(dim=-1)[:, None, :]
    zz = torch.einsum("bnd,bmd->bnm", x, y)
    return torch.clamp(xx + yy - 2.0 * zz, min=0.0)


def chamfer_loss(x: torch.Tensor, y: torch.Tensor, smooth: float = 1e-7) -> torch.Tensor:
    """Symmetric nearest-neighbour (Chamfer) loss of two point sets, the
    distances ``sqrt(d^2 + smooth)`` (reference ``batch_NN_loss``)."""
    d = torch.sqrt(batch_pairwise_dist(x, y) + smooth)
    return d.min(dim=2).values.mean(dim=1).mean() + d.min(dim=1).values.mean(dim=1).mean()


def _safe_norm(x: torch.Tensor, dim: int = 1, tiny: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite gradient at exactly-zero vectors."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return torch.sqrt(torch.clamp(sq, min=tiny * tiny))


def cnr_loss(centroid_s: torch.Tensor, centroid_t: torch.Tensor) -> torch.Tensor:
    """Centroid-Norm Regulariser: MSE between per-class centroid L2 norms."""
    norm_s = _safe_norm(centroid_s.float())[:, 0]
    norm_t = _safe_norm(centroid_t.float())[:, 0]
    return ((norm_t - norm_s) ** 2).mean()


def centroid_contrastive_loss(centroid_s: torch.Tensor, centroid_t: torch.Tensor, *,
                              bg: bool = False, split: bool = False, norm: bool = True,
                              tau: Optional[float] = None) -> torch.Tensor:
    """Inter/intra centroid InfoNCE between two (C, F) centroid sets (MCCL):
    for each anchor class i (1..C-1 unless ``bg``), with t and s unit rows,
    -log((exp<t_i,s_i> + exp<t_i,t_i>) / (sum_j exp<t_i,s_j> + sum_j
    exp<t_i,t_j> + 1e-7)), summed; ``split`` halves the nominator into two
    -log terms. No temperature unless ``tau`` is given, as the JAX package's
    MCCL step calls it. Norms by :func:`_safe_norm`, so an all-zero centroid
    has a finite gradient."""
    centroid_s = centroid_s.float()
    centroid_t = centroid_t.float()
    if norm:
        centroid_s = centroid_s / (_safe_norm(centroid_s) + _EPS)
        centroid_t = centroid_t / (_safe_norm(centroid_t) + _EPS)
    sim_st = centroid_t @ centroid_s.T
    sim_tt = centroid_t @ centroid_t.T
    if tau is not None:
        sim_st = sim_st / tau
        sim_tt = sim_tt / tau
    exp_st = torch.exp(sim_st)
    exp_tt = torch.exp(sim_tt)
    start = 0 if bg else 1
    diag_st = torch.diagonal(exp_st)[start:]
    diag_tt = torch.diagonal(exp_tt)[start:]
    denom = exp_st[start:].sum(dim=1) + exp_tt[start:].sum(dim=1)
    if split:
        logit = 0.5 * (-torch.log(diag_st / (denom + _EPS))
                       - torch.log(diag_tt / (denom + _EPS)))
    else:
        logit = -torch.log((diag_st + diag_tt) / (denom + _EPS))
    return logit.sum()


def seg_pseudo_loss(probs_t: torch.Tensor, threshold: float,
                    num_classes: int) -> torch.Tensor:
    """Calibrated self-training entropy on confident target pixels: probs
    times C / e, ``-detach(cal) * log(cal)``, masked where the max prob
    exceeds ``threshold``, mean over every element."""
    p = probs_t.float()
    cal = p * num_classes / math.e
    loss = -cal.detach() * torch.log(cal)
    mask = (p.max(dim=-1, keepdim=True).values > threshold).float()
    return (loss * mask).mean()


def nearest_resize_labels(labels: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHW integer labels; samples input
    floor((i + 0.5) * in / out), as ``jax.image.resize(..., 'nearest')``."""
    out = F.interpolate(labels[:, None].float(), size=tuple(size), mode="nearest-exact")
    return out[:, 0].to(labels.dtype)


def _unit_centers(class_centers: torch.Tensor) -> torch.Tensor:
    """(C, F) centres over ``||c|| + 1e-12``, in f32, as jnp normalises them."""
    centers = class_centers.float()
    return centers / (torch.linalg.vector_norm(centers, dim=-1, keepdim=True) + 1e-12)


def mpcl_loss_calc(feats: torch.Tensor, labels: torch.Tensor,
                   class_centers: torch.Tensor, *, temperature: float = 0.1,
                   base_temperature: float = 1.0, margin: float = 0.4,
                   easy_margin: bool = False,
                   pixel_sel_loc: Optional[torch.Tensor] = None,
                   resize_labels: bool = True) -> torch.Tensor:
    """Normalise + flatten wrapper around MPCL. feats NHWC; labels NHW (hard)
    or already flat (N,); centres (C, F), normalised here as in jnp. The row
    normalisation happens inside :func:`mpcl` (kernel or plain version)."""
    n, h, w, c = feats.shape
    if resize_labels and labels.dim() == 3 and tuple(labels.shape[1:]) != (h, w):
        labels = nearest_resize_labels(labels, (h, w))
    flat = feats.reshape(n * h * w, c).contiguous()
    lab = labels.reshape(-1)
    sel = None if pixel_sel_loc is None else pixel_sel_loc.float().reshape(-1).contiguous()
    centers = _unit_centers(class_centers)
    if flat.is_cuda:
        lab = lab.to(torch.int32).contiguous()
        centers = centers.contiguous()
    return mpcl(flat, lab, centers, sel, temperature=temperature,
                base_temperature=base_temperature, margin=margin,
                easy_margin=easy_margin)


def mpcl_pseudo_loss(feats: torch.Tensor, class_centers: torch.Tensor, *,
                     temperature: float = 0.1, base_temperature: float = 1.0,
                     margin: float = 0.2, easy_margin: bool = False,
                     pixel_sel_th: float = 0.25) -> torch.Tensor:
    """The target branch in one call: cosine pseudo-labels and top1-top2 gap
    mask from ``feats`` (NHWC) against the centres, then MPCL on those labels
    weighted by the mask (``generate_pseudo_label`` + ``mpcl_loss_calc(...,
    pixel_sel_loc=mask, resize_labels=False)``). Centres (C, F) are
    normalised here as in :func:`mpcl_loss_calc`."""
    flat = feats.reshape(-1, feats.shape[-1]).contiguous()
    return mpcl_pseudo(flat, _unit_centers(class_centers).contiguous(),
                       temperature=temperature, base_temperature=base_temperature,
                       margin=margin, easy_margin=easy_margin, pixel_sel_th=pixel_sel_th)
