"""Train steps of the remaining UDA methods: DDFSeg, AdaptEvery and BCL.

Counterpart of ``slcl_tpu/train/steps_extra.py``; ``step(state, batch,
sched) -> metrics`` as in :mod:`.steps`, updating ``state`` in place.

  ddfseg     DDFNet + SegDecoder (``state.seg``, a :class:`DDFSeg`) against
             three PatchGANs: ``d_main`` on target images (the source-to-
             target fakes), ``d_aux`` on source images with its aux head,
             ``d_seg`` on predictions; one Adam step of the generator at
             ``sched['lr']``, then each discriminator's on detached tensors
             at ``sched['lr_dis']``.
  adaptevery ResNetUNetPoint (multilvl) against ``d_main``/``d_aux`` on the
             target softmax, ``d_ent`` on its entropy map and the PointNet
             ``d_point`` on the predicted target vertices, with the Chamfer
             loss on the source vertices.
  bcl        BCLDeepLab: CE on source, CE on the round's target pseudo-labels
             (255 ignored), BCL's entropy and the bidirectional prototype
             metric loss on the first image of each domain; one SGD step.

Dropout (DDFSeg's nets and PointNet) is on in the steps, as in the JAX
package. Its masks are keyed by the module's path and its call within a
pass, a pass being one application of a network (a flax ``apply``): the
three SegDecoder passes of a DDFSeg step drop alike, and so do the three
``d_point`` passes of an AdaptEvery step. ``draw_dropout(step, path, call,
shape, keep, device)`` gives the masks when passed; by default they come
from a generator on the step's device seeded by splitmix64 of the salted
(seed, step, path, call), so a restored checkpoint repeats them. The JAX
step throws away ``d_point``'s updated running statistics: here its
BatchNorms use batch statistics and keep their running ones.

Under data parallelism the masks are drawn at the global batch's shape and
each rank keeps its rows, and BCL's metric loss (on the global batch's
first image of each domain) is data rank 0's: the other ranks ignore every
pixel of it. Under spatial partitioning each rank holds a band of every
image's rows: a dropout mask is drawn at the activation's global rows and
the module keeps its band (``models/common.py::Dropout``); BCL's metric
loss reads image 0's band, its labels resized on global coordinates
(``parallel/spatial.py::resize_labels``) and its prototypes summed over the
model ranks (``losses.bcl_prototype_similarity``); AdaptEvery's vertex
branch is the same on every model rank of a data rank, and its losses and
PointNet's BatchNorm count those replicas in both their sums and counts.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.common import dropout_pass, running_stats_frozen
from ..ops import losses as L
from ..parallel import mesh as dp
from ..parallel import spatial as sp
from .state import TrainState
from .steps import Generators, Metrics, _d_acc, _seg_update, autocast, net_update, splitmix64

DrawDropout = Callable[[int, str, int, Tuple[int, ...], float, torch.device], torch.Tensor]

# salt of the dropout stream: (seed, step) seeds another stream than the
# rMC draw's and RAIN's noise
_DROPOUT_SALT = 0x44524F504F555421


def dropout_seed(seed: int, step: int, path: str, call: int) -> int:
    """The generator seed of one dropout mask: splitmix64 of the salted
    (seed, step), mixed again with the module path's CRC-32 and the call."""
    pair = ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)
    key = (zlib.crc32(path.encode()) << 24) ^ call
    return splitmix64(splitmix64(pair ^ _DROPOUT_SALT) ^ key)


def dropout_draw(gens: Generators, seed: int, step: int, path: str, call: int,
                 shape, keep: float, device: torch.device) -> torch.Tensor:
    """One dropout mask (true where kept) of step ``step`` of a run seeded
    ``seed``: uniforms from the generator seeded by :func:`dropout_seed`."""
    g = gens.seeded(device, dropout_seed(seed, step, path, call))
    return torch.rand(tuple(shape), generator=g, device=device) < keep


class Dropouts:
    """A step's dropout masks: ``draw_dropout`` when given, else
    :func:`dropout_draw`."""

    def __init__(self, draw_dropout: Optional[DrawDropout] = None):
        self.hook = draw_dropout
        self.gens = Generators()

    def for_step(self, seed: int, step: int):
        """The ``dropout_pass`` draw of step ``step``: the global batch's
        mask, this data rank's rows of it (``shape``'s rows are already the
        global ones under spatial partitioning: ``Dropout`` keeps its band)."""
        def draw(path, call, shape, keep, device):
            shape = dp.global_shape(shape)
            if self.hook is not None:
                return dp.local_rows(self.hook(step, path, call, shape, keep, device))
            return dp.local_rows(dropout_draw(self.gens, seed, step, path, call, shape,
                                              keep, device))
        return draw


def _out(metrics: Metrics) -> Metrics:
    return {k: v.detach().float() for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# DDFSeg
# ---------------------------------------------------------------------------
def make_ddfseg_step(cfg, draw_dropout: Optional[DrawDropout] = None) -> Callable:
    """Reference Trainer_DDFSeg.train_epoch (:290-465), weights from
    ``cfg.ddfseg``. ``state.seg`` holds ``ddfnet`` and ``segdecoder``;
    ``d_main`` discriminates target images, ``d_aux`` (aux head) source
    images, ``d_seg`` predictions. The generator's ``d_seg`` term sees the
    target prediction detached, as in the JAX step."""
    dd = cfg.ddfseg
    dropouts = Dropouts(draw_dropout)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        img_s, labels_s, img_t = batch["img_s"], batch["lab_s"], batch["img_t"]
        amp = autocast(cfg.model.dtype, img_s.device)
        draw = dropouts.for_step(state.seed, state.step)
        ddfnet, segdecoder = state.seg.ddfnet, state.seg.segdecoder
        rows = ddfnet.content_rows(sp.image_rows(img_s))
        state.seg.train()
        with amp:
            with dropout_pass(draw):
                out = ddfnet(img_s, img_t)
            # three passes of the seg decoder, each its own (same masks)
            preds = []
            for key in ("content_s", "recon_content_s", "content_t"):
                with dropout_pass(draw):
                    preds.append(segdecoder(out[key], rows))
        pred_s, pred_recon_s, pred_t = preds
        seg_loss = L.cross_entropy_loss(pred_s, labels_s) + L.dice_loss(pred_s, labels_s)
        recon_seg_loss = (L.cross_entropy_loss(pred_recon_s, labels_s)
                          + L.dice_loss(pred_recon_s, labels_s))
        zero_s = dp.gmean(out["style_s_from_t"].float() ** 2)
        zero_t = dp.gmean(out["style_t_from_s"].float() ** 2)
        cyc_s = L.mse_loss(out["recon_imgs"], img_s[..., 1:2])
        cyc_t = L.mse_loss(out["recon_imgt"], img_t[..., 1:2])
        with amp:
            d_t_fake = state.d_main(out["fake_img_s_t"])
            d_seg_fake = state.d_seg(pred_t.detach())
            d_s_out, d_s_aux = state.d_aux(out["fake_img_t_s"])
        adv_t = L.bce_with_logits(d_t_fake, 1.0)
        adv_seg = L.bce_with_logits(d_seg_fake, 1.0)
        adv_s = L.bce_with_logits(d_s_out, 1.0)
        adv_s_aux = L.bce_with_logits(d_s_aux, 1.0)
        total = (dd.w_seg * (seg_loss + recon_seg_loss)
                 + dd.w_cyc * (cyc_s + cyc_t) + dd.w_zero * (zero_s + zero_t)
                 + dd.w_adv_t * adv_t + dd.w_adv_seg * adv_seg
                 + dd.w_adv_s * adv_s + dd.w_adv_aux * adv_s_aux)
        metrics: Metrics = {"seg_s": seg_loss, "seg_fake_st": recon_seg_loss,
                            "cyc_loss_s": cyc_s, "cyc_loss_t": cyc_t,
                            "zero_loss_s": zero_s, "zero_loss_t": zero_t,
                            "loss_adv_t": adv_t, "loss_adv_s": adv_s,
                            "loss_adv_seg": adv_seg}
        _seg_update(state, total, sched["lr"])

        # the discriminators on detached tensors
        fake_st = out["fake_img_s_t"].detach()
        fake_ts = out["fake_img_t_s"].detach()
        recon_s = out["recon_imgs"].detach()
        pred_t, pred_recon_s = pred_t.detach(), pred_recon_s.detach()
        lr_dis = sched["lr_dis"]
        with amp:
            rt, ft = state.d_main(img_t[..., 1:2]), state.d_main(fake_st)
        net_update(state.d_main, state.opt_d_main,
                   0.5 * L.bce_with_logits(rt, 1.0) + 0.5 * L.bce_with_logits(ft, 0.0), lr_dis)
        with amp:
            rs, _ = state.d_aux(img_s[..., 1:2])
            _, recon_aux = state.d_aux(recon_s)
            fs, fake_aux = state.d_aux(fake_ts)
        net_update(state.d_aux, state.opt_d_aux,
                   0.5 * L.bce_with_logits(rs, 1.0) + 0.5 * L.bce_with_logits(recon_aux, 1.0)
                   + 0.5 * L.bce_with_logits(fs, 0.0) + 0.5 * L.bce_with_logits(fake_aux, 0.0),
                   lr_dis)
        with amp:
            real, fake = state.d_seg(pred_recon_s), state.d_seg(pred_t)
        net_update(state.d_seg, state.opt_d_seg,
                   0.5 * L.bce_with_logits(real, 1.0) + 0.5 * L.bce_with_logits(fake, 0.0),
                   lr_dis)
        metrics.update({"d_t_acc_real": _d_acc(rt.detach(), True),
                        "d_t_acc_fake": _d_acc(ft.detach(), False),
                        "d_s_acc_real": _d_acc(rs.detach(), True),
                        "d_s_acc_fake": _d_acc(fs.detach(), False)})
        state.step += 1
        return _out(metrics)

    return step


# ---------------------------------------------------------------------------
# AdaptEvery
# ---------------------------------------------------------------------------
def _entropy(probs: torch.Tensor) -> torch.Tensor:
    return -probs * torch.log(probs + 1e-10)


def _disc_loss(disc, a, b, amp) -> torch.Tensor:
    with amp:
        oa, ob = disc(a), disc(b)
    return 0.5 * L.bce_with_logits(oa, 1.0) + 0.5 * L.bce_with_logits(ob, 0.0)


def make_adaptevery_step(cfg, draw_dropout: Optional[DrawDropout] = None) -> Callable:
    """Reference Trainer_AdaptEvery.train_epoch (:195-470), weights from
    ``cfg.adv``: CE + Jaccard on source (and ``w_seg_aux`` times the aux
    head's), ``wp`` times the Chamfer loss on the source vertices, and the
    adversarial terms of ``d_main``/``d_aux`` (target softmax), ``d_ent``
    (target entropy map) and ``d_point`` (predicted target vertices, in
    its own float32, outside autocast); then each discriminator's Adam step. ``d_point`` runs in
    train mode with its running statistics kept, one pass per call."""
    a = cfg.adv
    dropouts = Dropouts(draw_dropout)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        img_s, labels_s = batch["img_s"], batch["lab_s"]
        vert_s, img_t = batch["vert_s"], batch["img_t"]
        amp = autocast(cfg.model.dtype, img_s.device)
        draw = dropouts.for_step(state.seed, state.step)
        d_point = state.d_point

        def point_logits(verts):
            # outside autocast, in the PointNet's own dtype (flax's dtype)
            with dropout_pass(draw), running_stats_frozen(d_point):
                return d_point(verts.to(d_point.Dense_0.weight.dtype))[0]

        state.seg.train()
        d_point.train()
        with amp:
            out_s, vert_pred_s = state.seg(img_s)
            out_t, vert_pred_t = state.seg(img_t)
        loss_seg = L.loss_calc(out_s.pred, labels_s, jaccard=True)
        loss_seg_aux = L.loss_calc(out_s.aux, labels_s, jaccard=True)
        loss_point = L.chamfer_loss(vert_pred_s, vert_s)
        probs_t = torch.softmax(out_t.pred.float(), dim=-1)
        probs_t_aux = torch.softmax(out_t.aux.float(), dim=-1)
        ent_t = _entropy(probs_t)
        with amp:
            adv = L.bce_with_logits(state.d_main(probs_t), 1.0)
            adv_aux = L.bce_with_logits(state.d_aux(probs_t_aux), 1.0)
            adv_ent = L.bce_with_logits(state.d_ent(ent_t), 1.0)
        adv_point = L.bce_with_logits(point_logits(vert_pred_t), 1.0)
        total = (loss_seg + a.w_seg_aux * loss_seg_aux + a.wp * loss_point
                 + a.w_dis * adv + a.w_dis_aux * adv_aux + a.w_d_ent * adv_ent
                 + a.w_d_point * adv_point)
        metrics: Metrics = {"seg_s": loss_seg, "seg_s_aux": loss_seg_aux,
                            "loss_point": loss_point, "loss_adv": adv,
                            "loss_adv_aux": adv_aux, "loss_adv_ent": adv_ent,
                            "loss_adv_point": adv_point}
        _seg_update(state, total, sched["lr"])

        probs = {k: torch.softmax(v.detach().float(), dim=-1) for k, v in
                 (("s", out_s.pred), ("s_aux", out_s.aux), ("t", out_t.pred),
                  ("t_aux", out_t.aux))}
        lr_dis = sched["lr_dis"]
        net_update(state.d_main, state.opt_d_main,
                   _disc_loss(state.d_main, probs["s"], probs["t"], amp), lr_dis)
        net_update(state.d_aux, state.opt_d_aux,
                   _disc_loss(state.d_aux, probs["s_aux"], probs["t_aux"], amp), lr_dis)
        net_update(state.d_ent, state.opt_d_ent,
                   _disc_loss(state.d_ent, _entropy(probs["s"]), ent_t.detach(), amp), lr_dis)
        loss_pt = (0.5 * L.bce_with_logits(point_logits(vert_pred_s.detach()), 1.0)
                   + 0.5 * L.bce_with_logits(point_logits(vert_pred_t.detach()), 0.0))
        net_update(d_point, state.opt_d_point, loss_pt, lr_dis)
        state.step += 1
        return _out(metrics)

    return step


# ---------------------------------------------------------------------------
# BCL
# ---------------------------------------------------------------------------
def make_bcl_step(cfg) -> Callable:
    """Reference Trainer_BCL.py:222-275: ``(ce_s + lambt * ce_t) + lamb *
    (ent_s + lambt * ent_t) + metric`` with ``run.bcl_lambt`` and
    ``run.bcl_lamb``; ``batch['plabel_t']`` holds the round's pseudo-labels
    (255 ignored). The metric loss takes the first image of each domain,
    its labels shrunk to the feature map by nearest resize."""
    n_class = cfg.model.num_classes
    lambt, lamb = cfg.run.bcl_lambt, cfg.run.bcl_lamb

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        img_s, labels_s = batch["img_s"], batch["lab_s"]
        img_t, plabel_t = batch["img_t"], batch["plabel_t"]
        state.seg.train()
        with autocast(cfg.model.dtype, img_s.device):
            pred_s, feat_s = state.seg(img_s, source=True)
            pred_t, feat_t = state.seg(img_t, source=False)
        ce_s = L.cross_entropy_loss(pred_s, labels_s)
        ce_t = L.cross_entropy_ignore(pred_t, plabel_t, 255)
        ent = (dp.gmean(L.bcl_entropy_loss(pred_s))
               + lambt * dp.gmean(L.bcl_entropy_loss(pred_t)))
        rows = sp.image_rows(img_s)
        # the features' global size
        size = (state.seg.feature_rows(rows), feat_s.shape[2])
        lab_small = sp.resize_labels(labels_s[:1], size, rows)[0]
        plab_small = sp.resize_labels(plabel_t[:1], size, rows)[0]
        cs1 = L.bcl_prototype_similarity(feat_s[0], lab_small, feat_t[0], n_class)
        cs2 = L.bcl_prototype_similarity(feat_t[0], plab_small, feat_s[0], n_class)
        tgt1, tgt2 = plab_small[None], lab_small[None]
        m = dp.current()
        if m is not None and m.data_rank > 0:
            # the global batch's first images are data rank 0's
            tgt1, tgt2 = torch.full_like(tgt1, 255), torch.full_like(tgt2, 255)
        metric = (L.cross_entropy_ignore(cs1.permute(1, 2, 0)[None], tgt1, 255)
                  + L.cross_entropy_ignore(cs2.permute(1, 2, 0)[None], tgt2, 255))
        total = ce_s + lambt * ce_t + lamb * ent + metric
        metrics: Metrics = {"seg_s": ce_s, "seg_t_pseudo": ce_t, "loss_ent": ent,
                            "metric_loss": metric}
        _seg_update(state, total, sched["lr"])
        state.step += 1
        return _out(metrics)

    return step
