"""Segmentation / adversarial / contrastive / BCL / Chamfer losses.

Counterpart of ``slcl_tpu/ops/losses.py``: logits and features NHWC, labels
NHW, class centres (C, F); every loss accumulates in float32 whatever the
activation dtype. ``mpcl_loss_calc`` and ``mpcl_pseudo_loss`` send CUDA
tensors to their kernels and CPU tensors to the plain versions.

Under data parallelism (:mod:`slcl_torch.parallel.mesh`) each loss over
batch rows is the global batch's on every rank: its sums and counts go
through one differentiable all-reduce before the division (``gmean``,
``global_sums``). Under spatial partitioning the same reductions run over
every rank (each holds a band of each image's rows), and a per-sample sum
(Dice's, the summed entropy's) first over the model ranks
(``sample_sum``). With one rank holding the pixels the arithmetic is the
one-process one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda.mpcl import mpcl, mpcl_loss_normalized as mpcl_loss  # noqa: F401
from .cuda.mpcl_pseudo import mpcl_pseudo
from ..parallel.mesh import all_sum, data_parallel, global_sums, gmean, sample_sum, spatial
from ..parallel.spatial import resize_labels

_EPS = 1e-7


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean pixel-wise CE; logits NHWC, labels NHW int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -gmean(logp.gather(-1, labels[..., None].long()))


def jaccard_loss(logits: torch.Tensor, labels: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Soft IoU over softmax probs vs one-hot labels, per class over (B,H,W)."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    dims = tuple(range(labels.dim()))
    intersection = (probs * onehot).sum(dim=dims)
    total = (probs + onehot).sum(dim=dims)
    if data_parallel():
        intersection, total = all_sum(torch.cat([intersection, total])).split(num_classes)
    union = total - intersection
    return 1.0 - (intersection / (union + eps)).mean()


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over the pixels whose label is not ``ignore_index`` (BCL's
    pseudo-label CE); 0 when every pixel is ignored. logits NHWC, labels NHW."""
    valid = (labels != ignore_index).float()
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    num, den = global_sums((nll * valid).sum(), valid.sum())
    return num / torch.clamp(den, min=1.0)


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
    num, den1, den2 = sample_sum(torch.stack([num, den1, den2])).unbind()
    dice = 2.0 * num / (den1 + den2 + eps)
    if data_parallel():
        total, rows = global_sums(dice.sum(), dice.shape[0])
        return 1.0 - total / rows / num_classes
    return 1.0 - dice.sum() / dice.shape[0] / num_classes


def loss_entropy(probs: torch.Tensor, smooth: float = 1e-7, mode: str = "mean") -> torch.Tensor:
    """Normalised entropy minimisation (the AdvEnt direct term):
    ``-1/log(C) * sum_c p log(p + smooth)`` per pixel, averaged over all
    pixels ('mean') or summed per sample then averaged ('sum'). probs NHWC."""
    probs = probs.float()
    pix = (-1.0 / math.log(probs.shape[-1])) * (probs * torch.log(probs + smooth)).sum(dim=-1)
    if mode == "mean":
        return gmean(pix)
    if mode == "sum":
        return gmean(sample_sum(pix.sum(dim=tuple(range(1, pix.dim())))))
    raise NotImplementedError(mode)


def loss_class_prior(probs: torch.Tensor, prior, w: float) -> torch.Tensor:
    """Hinge on the predicted class marginals: ``sum(relu(w*prior - mean))``,
    the mean over every axis but the class one. probs NHWC."""
    probs = probs.float()
    dims = tuple(range(probs.dim() - 1))
    if data_parallel():
        n = probs.numel() // probs.shape[-1]
        total = all_sum(torch.cat([probs.sum(dim=dims), probs.new_tensor([float(n)])]))
        marginal = total[:-1] / total[-1]
    else:
        marginal = probs.mean(dim=dims)
    # filled entry by entry: no host-to-device copy, which a captured step
    # cannot make
    prior_t = torch.empty(len(prior), dtype=torch.float32, device=probs.device)
    for k, v in enumerate(prior):
        prior_t[k] = v
    return torch.relu(w * prior_t - marginal).sum()


def prob_2_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Per-pixel weighted self-information ``-p * log2(p+eps) / log2(C)``."""
    probs = probs.float()
    return -probs * torch.log2(probs + _EPS) / math.log2(probs.shape[-1])


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross entropy with logits against a constant target."""
    x = logits.float()
    return gmean(torch.clamp(x, min=0) - x * target + torch.log1p(torch.exp(-x.abs())))


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared difference, in float32."""
    return gmean((a.float() - b.float()) ** 2)


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
    cosine_similarity_BCL does); exact-zero cosines become -1, then x10.
    Under spatial partitioning the maps are this rank's band of the image's
    rows: the prototypes' sums, the class counts and ``feature2``'s squared
    column norms are summed over the model ranks (``sample_sum``), so each
    band's cosines are the whole image's."""
    h, w, f = feature.shape
    lab = label_small.reshape(-1).long()
    feat = feature.float().reshape(-1, f)
    onehot = F.one_hot(torch.where(lab == 255, torch.full_like(lab, num_classes), lab),
                       num_classes + 1).float()[:, :num_classes]
    if spatial() is None:
        sums, counts = onehot.T @ feat, onehot.sum(dim=0)
    else:
        both = sample_sum(torch.cat([onehot.T @ feat, onehot.sum(dim=0)[:, None]], dim=1))
        sums, counts = both[:, :f], both[:, f]
    protos = sums / torch.clamp(counts[:, None], min=1.0)
    protos = torch.where(counts[:, None] > 0, protos, torch.zeros_like(protos))
    protos_n = protos / (torch.linalg.vector_norm(protos, dim=1, keepdim=True) + 1e-12)
    feat2 = feature2.float().reshape(-1, f)
    if spatial() is None:
        norm2 = torch.linalg.vector_norm(feat2, dim=0, keepdim=True)
    else:
        sq = sample_sum(feat2.square().sum(dim=0, keepdim=True))
        norm2 = torch.sqrt(torch.clamp(sq, min=torch.finfo(sq.dtype).tiny))
    feat2_n = feat2 / (norm2 + 1e-12)
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
    return gmean(d.min(dim=2).values.mean(dim=1)) + gmean(d.min(dim=1).values.mean(dim=1))


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
    return gmean(loss * mask)


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
        labels = resize_labels(labels, (h, w))
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


# ---------------------------------------------------------------------------
# Pixel-level supervised contrastive (SupCon / Local / Block), mixup SupCon
# and soft-target CE (``slcl_tpu/ops/losses.py:335-429,500-503``). No step
# calls them; the contrastive ones pair the pixels of the rows they are
# given (under data parallelism, a rank's own).
# ---------------------------------------------------------------------------
def _supcon_from_mask(feats: torch.Tensor, mask: torch.Tensor, temperature: float):
    """Per-row mean log-probability of the positives in ``mask`` (self-pairs
    dropped) over the (n, n) logits of ``feats``."""
    n = feats.shape[0]
    logits = (feats @ feats.T) / temperature
    logits_mask = 1.0 - torch.eye(n, dtype=feats.dtype, device=feats.device)
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    return (mask * log_prob).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1e-12)


def supcon_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None, *,
                temperature: float = 0.07) -> torch.Tensor:
    """Supervised contrastive loss over pre-normalised pixel features of
    several views (reference utils/loss.py:315-387): features (B, V, H, W,
    F), labels (B, V, H, W). Positives share a label (the background's
    anchors left out of the mean), or without labels are the same pixel in
    another view."""
    b, v = features.shape[:2]
    f = features.shape[-1]
    feats = features.float().transpose(0, 1).reshape(-1, f)
    n = feats.shape[0]
    if labels is not None:
        lab = labels.transpose(0, 1).reshape(-1, 1)
        mask = (lab == lab.T).float()
        non_bg = (lab.reshape(-1) != 0).float()
    else:
        eye = torch.eye(n // v, dtype=torch.float32, device=feats.device)
        mask = eye.repeat(v, v)
        non_bg = None
    loss = -_supcon_from_mask(feats, mask, temperature)
    if non_bg is not None:
        return (loss * non_bg).sum() / torch.clamp(non_bg.sum(), min=1e-12)
    return loss.mean()


def local_con_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None, *,
                   temperature: float = 0.7, stride: int = 4) -> torch.Tensor:
    """:func:`supcon_loss` on every ``stride``-th pixel of each axis
    (reference utils/loss.py:390-413)."""
    feats = features[:, :, ::stride, ::stride, :]
    labs = None if labels is None else labels[:, :, ::stride, ::stride]
    return supcon_loss(feats, labs, temperature=temperature)


def block_con_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None, *,
                   temperature: float = 0.7, block_size: int = 32) -> torch.Tensor:
    """:func:`supcon_loss` over non-overlapping ``block_size`` tiles,
    averaged over the tiles with a non-zero label (all tiles without labels),
    0 when there is none (reference utils/loss.py:416-466)."""
    div = features.shape[2] // block_size
    total = features.new_zeros((), dtype=torch.float32)
    denom = features.new_zeros((), dtype=torch.float32)
    for i in range(div):
        for j in range(div):
            rows = slice(i * block_size, (i + 1) * block_size)
            cols = slice(j * block_size, (j + 1) * block_size)
            fb = features[:, :, rows, cols, :]
            if labels is not None:
                lb = labels[:, :, rows, cols]
                nonzero = (lb.sum() > 0).float()
                total = total + supcon_loss(fb, lb, temperature=temperature) * nonzero
                denom = denom + nonzero
            else:
                total = total + supcon_loss(fb, temperature=temperature)
                denom = denom + 1.0
    return torch.where(denom > 0, total / torch.clamp(denom, min=1.0), torch.zeros_like(total))


def interpolated_supcon_loss(features: torch.Tensor, labels_a: torch.Tensor,
                             labels_b: torch.Tensor, lam: float, *,
                             temperature: float = 0.07) -> torch.Tensor:
    """Mixup SupCon: positives weighted ``lam`` by ``labels_a``'s equality and
    ``1 - lam`` by ``labels_b``'s (reference utils/losses.py:6-68). features
    (N, F) normalised; labels (N,)."""
    la, lb = labels_a.reshape(-1, 1), labels_b.reshape(-1, 1)
    mask = lam * (la == la.T).float() + (1.0 - lam) * (lb == lb.T).float()
    return -_supcon_from_mask(features.float(), mask, temperature).mean()


def softmax_cross_entropy_soft(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    """Mean over the rows of the CE against soft targets (reference
    utils/losses.py:70-92); the global batch's mean under data parallelism."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return gmean((-soft_targets.float() * logp).sum(dim=-1))
