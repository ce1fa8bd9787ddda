"""The SLCL (MPSCL-path) train step: generator phase, then discriminators.

Counterpart of ``slcl_tpu/train/steps.py`` ``_gan_step`` +
``make_mpscl_step`` + ``build_step`` for ``method`` in ``mpscl``/``slcl``.
``step(state, batch, sched) -> metrics`` updates ``state`` in place and
returns 0-d float32 tensors on the device (no host sync); the trainer
reduces them once per epoch.

Generator phase: source then target forward in train mode (BatchNorm
running statistics carry over from the source pass to the target pass),
CE + Dice on source, EMA class centres from detached source features,
cosine pseudo-labels on target, MPCL on both domains, CNR on the target
soft centroids, and the entropy-map adversarial terms; gradients go to the
segmentor only (``backward(inputs=...)``), which takes one SGD step.
Discriminator phase: each discriminator sees predictions detached from the
generator forward with halved BCE and takes one Adam step.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from ..ops import centroids as cen
from ..ops import losses as L
from .state import TrainState, set_lr

Metrics = Dict[str, torch.Tensor]


def _d_acc(logits: torch.Tensor, is_source: bool) -> torch.Tensor:
    """Discriminator accuracy bookkeeping (Trainer_AdaptSeg.py:196-228)."""
    m = (torch.sigmoid(logits.float()) >= 0.5).float().mean()
    return m if is_source else 1.0 - m


def _entropy_map(logits: torch.Tensor) -> torch.Tensor:
    """Weighted self-information map of the softmax (Trainer_MPSCL.py:171-173)."""
    return L.prob_2_entropy(torch.softmax(logits.float(), dim=-1))


def _autocast(cfg, device: torch.device):
    """bf16 activations with fp32 parameters when ``model.dtype`` is bf16."""
    if cfg.model.dtype == "bfloat16":
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def _d_update(disc, opt, lr: float, pred_s: torch.Tensor, pred_t: torch.Tensor,
              amp) -> Metrics:
    """One Adam step of a discriminator on detached predictions."""
    with amp:
        o_s = disc(_entropy_map(pred_s))
        o_t = disc(_entropy_map(pred_t))
    loss = 0.5 * L.bce_with_logits(o_s, 1.0) + 0.5 * L.bce_with_logits(o_t, 0.0)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    set_lr(opt, lr)
    opt.step()
    return {"loss": loss.detach(), "acc_s": _d_acc(o_s.detach(), True),
            "acc_t": _d_acc(o_t.detach(), False)}


def make_mpscl_step(cfg, centroids_loaded: bool = False) -> Callable:
    c = cfg.contrastive
    n_class = cfg.model.num_classes

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        seg = state.seg
        dev = batch["img_s"].device
        amp = _autocast(cfg, dev)
        seg.train()
        labels_s = batch["lab_s"]

        # ---- generator phase ----
        with amp:
            out_s = seg(batch["img_s"])
            out_t = seg(batch["img_t"])

        # seg loss: CE + dice (Trainer_MPSCL.py:125)
        loss_seg = (L.loss_calc(out_s.pred, labels_s, jaccard=False)
                    + L.dice_loss(out_s.pred, labels_s))
        metrics: Metrics = {"seg_s": loss_seg}

        # EMA class centres from detached source features; zero-init
        # centres adopt the first batch means outright
        new_centroids = cen.update_class_center_iter(
            out_s.dcdr_ft, labels_s, state.centroids, momentum=c.class_center_m,
            num_classes=n_class,
            bootstrap=None if centroids_loaded else (state.step == 0))
        plab_t, pmask_t = cen.generate_pseudo_label(
            out_t.dcdr_ft, new_centroids, pixel_sel_th=c.pixel_sel_th)

        centers = new_centroids.detach()
        mpcl_src = L.mpcl_loss_calc(
            out_s.dcdr_ft, labels_s, centers, temperature=c.src_temp,
            base_temperature=c.src_base_temp, margin=c.src_margin,
            easy_margin=c.easy_margin)
        mpcl_trg = L.mpcl_loss_calc(
            out_t.dcdr_ft, plab_t, centers, temperature=c.trg_temp,
            base_temperature=c.trg_base_temp, margin=c.trg_margin,
            pixel_sel_loc=pmask_t, resize_labels=False, easy_margin=c.easy_margin)
        metrics["loss_mpscl_tr"] = mpcl_src
        metrics["loss_mpscl_tg"] = mpcl_trg

        # CNR: match target centroid norms to source (MCCL formula,
        # Trainer_MCCL.py:303-315), P = 1
        loss_cnr = torch.zeros((), dtype=torch.float32, device=dev)
        if c.CNR and c.CNR_w > 0:
            probs_t = torch.softmax(out_t.pred.float(), dim=-1)
            res = cen.target_soft_centroids(
                out_t.dcdr_ft, probs_t, partition=1, threshold=c.thd,
                weighted_ave=c.wtd_ave, num_classes=n_class)
            loss_cnr = L.cnr_loss(centers, res.centroids[0])
        metrics["loss_cnr"] = loss_cnr

        # adversarial branch on weighted self-information maps
        with amp:
            d_out = state.d_main(_entropy_map(out_t.pred))
        loss_adv = L.bce_with_logits(d_out, 1.0)
        metrics["loss_adv"] = loss_adv
        warm = sched["warm"]
        total = (loss_seg + cfg.adv.w_dis * loss_adv
                 + warm * (c.w_mpcl_s * mpcl_src + c.w_mpcl_t * mpcl_trg
                           + c.CNR_w * loss_cnr))
        multilvl = cfg.model.multilvl and out_t.aux is not None
        if multilvl:
            with amp:
                d_out_aux = state.d_aux(_entropy_map(out_t.aux))
            loss_adv_aux = L.bce_with_logits(d_out_aux, 1.0)
            metrics["loss_adv_aux"] = loss_adv_aux
            total = total + cfg.adv.w_dis_aux * loss_adv_aux

        seg_params = [p for p in seg.parameters() if p.requires_grad]
        state.opt_seg.zero_grad(set_to_none=True)
        total.backward(inputs=seg_params)
        set_lr(state.opt_seg, sched["lr"])
        state.opt_seg.step()

        # ---- discriminator phase (detached preds, halved BCE) ----
        d = _d_update(state.d_main, state.opt_d_main, sched["lr_dis"],
                      out_s.pred.detach(), out_t.pred.detach(), amp)
        metrics.update({"loss_dis": d["loss"], "dis_acc_s": d["acc_s"],
                        "dis_acc_t": d["acc_t"]})
        if multilvl and state.d_aux is not None:
            d = _d_update(state.d_aux, state.opt_d_aux, sched["lr_dis"],
                          out_s.aux.detach(), out_t.aux.detach(), amp)
            metrics.update({"loss_dis_aux": d["loss"], "dis_aux_acc_s": d["acc_s"],
                            "dis_aux_acc_t": d["acc_t"]})

        state.centroids = centers
        state.step += 1
        return {k: v.detach().float() for k, v in metrics.items()}

    return step


def build_step(cfg, centroids_loaded: bool = False) -> Callable:
    if cfg.method in ("mpscl", "slcl"):
        return make_mpscl_step(cfg, centroids_loaded=centroids_loaded)
    raise NotImplementedError(
        f"method {cfg.method!r}: slcl_torch ports the mpscl/slcl step only")
