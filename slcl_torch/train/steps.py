"""Per-method train steps: baseline, AdaptSeg, AdvEnt, SLCL (MPSCL path)
and MCCL (with RAIN); ``rain`` and ``pretrain_rain`` are in
:mod:`.steps_rain`.

Counterpart of ``slcl_tpu/train/steps.py`` ``clip_step_norm``,
``make_baseline_step``, ``_gan_step``, ``make_adaptseg_step``,
``make_advent_step``, ``make_mpscl_step``, ``make_mccl_step`` and
``build_step`` for ``method`` in ``baseline``/``adaptseg``/``advent``/
``mpscl``/``slcl``/``mccl``/``rain``/``pretrain_rain``.
``step(state, batch, sched) -> metrics`` updates ``state`` in place and
returns 0-d float32 tensors on the device (no host sync); the trainer
reduces them once per epoch.

Adversarial methods share :func:`_gan_step`. Generator phase: source then
target forward in train mode (BatchNorm running statistics carry over from
the source pass to the target pass) and the method's generator loss;
gradients go to the segmentor only (``backward(inputs=...)``), which takes
one optimizer step. Discriminator phase: each discriminator sees
predictions detached from the generator forward with halved BCE and takes
one Adam step. The SLCL generator loss adds CE + Dice on source, EMA class
centres from detached source features, MPCL on source, the fused target
branch (pseudo-labels, gap mask and MPCL in one kernel), CNR on the target
soft centroids, and the entropy-map adversarial terms.

MCCL (no discriminators) takes one segmentor step on CE + Jaccard on
source, source centroids, rMC soft target centroids with P partitions on
``img_t`` and one on ``img_t_aug``, and the centroid contrastive, CNR and
stdmin terms; under ``rain.enabled`` also the stylised branch and the
epsilon ascent. Its rMC draw at step n is a function of the state's seed
and n alone, made on the step's device, so a restored checkpoint repeats
the uninterrupted run's draws; RAIN's noise likewise.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops import centroids as cen
from ..ops import losses as L
from .state import TrainState, set_lr

Metrics = Dict[str, torch.Tensor]


def autocast(dtype: str, device: torch.device):
    """bf16 activations with fp32 parameters when ``model.dtype`` is bf16."""
    if dtype == "bfloat16":
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def _d_acc(logits: torch.Tensor, is_source: bool) -> torch.Tensor:
    """Discriminator accuracy bookkeeping (Trainer_AdaptSeg.py:196-228)."""
    m = (torch.sigmoid(logits.float()) >= 0.5).float().mean()
    return m if is_source else 1.0 - m


def _d_input(logits: torch.Tensor, kind: str) -> torch.Tensor:
    """Discriminator input map. 'softmax' = the class probabilities
    (AdaptSeg's output space, Trainer_AdaptSeg.py); 'advent' = raw
    -p*log(p+eps) (Trainer_Advent.py:86-88); 'weighted' = prob_2_entropy
    with log2/log2C (Trainer_MPSCL.py:171-173)."""
    probs = torch.softmax(logits.float(), dim=-1)
    if kind == "softmax":
        return probs
    if kind == "advent":
        return -probs * torch.log(probs + 1e-7)
    return L.prob_2_entropy(probs)


def _seg_update(state: TrainState, total: torch.Tensor, lr: float) -> None:
    """One optimizer step of the segmentor on ``total``'s gradient. A
    parameter the loss does not reach (FrozenBatchNorm's affine, DRUNet's
    dead ``conv1_1``) gets a zero gradient, not none: the optimizer still
    applies its weight decay to it, as optax does to every leaf."""
    params = [p for p in state.seg.parameters() if p.requires_grad]
    state.opt_seg.zero_grad(set_to_none=True)
    total.backward(inputs=params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    set_lr(state.opt_seg, lr)
    state.opt_seg.step()


def _d_update(disc, opt, lr: float, pred_s: torch.Tensor, pred_t: torch.Tensor,
              kind: str, amp) -> Metrics:
    """One Adam step of a discriminator on detached predictions."""
    with amp:
        o_s = disc(_d_input(pred_s, kind))
        o_t = disc(_d_input(pred_t, kind))
    loss = 0.5 * L.bce_with_logits(o_s, 1.0) + 0.5 * L.bce_with_logits(o_t, 0.0)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    set_lr(opt, lr)
    opt.step()
    return {"loss": loss.detach(), "acc_s": _d_acc(o_s.detach(), True),
            "acc_t": _d_acc(o_t.detach(), False)}


def _adv_terms(cfg, state: TrainState, out_t, kind: str, amp, metrics: Metrics):
    """Generator-side adversarial loss, main head plus aux when multilvl,
    already weighted by ``adv.w_dis`` / ``adv.w_dis_aux``."""
    with amp:
        d_out = state.d_main(_d_input(out_t.pred, kind))
    loss_adv = L.bce_with_logits(d_out, 1.0)
    metrics["loss_adv"] = loss_adv
    total = cfg.adv.w_dis * loss_adv
    if cfg.model.multilvl and out_t.aux is not None:
        with amp:
            d_out_aux = state.d_aux(_d_input(out_t.aux, kind))
        loss_adv_aux = L.bce_with_logits(d_out_aux, 1.0)
        metrics["loss_adv_aux"] = loss_adv_aux
        total = total + cfg.adv.w_dis_aux * loss_adv_aux
    return total


GenLoss = Callable[[TrainState, Dict[str, torch.Tensor], Dict[str, float], object],
                   Tuple[torch.Tensor, object, object, Metrics]]


def _gan_step(cfg, gen_loss: GenLoss, kind: str) -> Callable:
    """An adversarial step from a method's generator loss.
    ``gen_loss(state, batch, sched, amp)`` returns ``(total, out_s, out_t,
    metrics)``; ``kind`` names the discriminator input map."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        amp = autocast(cfg.model.dtype, batch["img_s"].device)
        state.seg.train()
        total, out_s, out_t, metrics = gen_loss(state, batch, sched, amp)
        _seg_update(state, total, sched["lr"])

        d = _d_update(state.d_main, state.opt_d_main, sched["lr_dis"],
                      out_s.pred.detach(), out_t.pred.detach(), kind, amp)
        metrics.update({"loss_dis": d["loss"], "dis_acc_s": d["acc_s"],
                        "dis_acc_t": d["acc_t"]})
        if cfg.model.multilvl and out_t.aux is not None and state.d_aux is not None:
            d = _d_update(state.d_aux, state.opt_d_aux, sched["lr_dis"],
                          out_s.aux.detach(), out_t.aux.detach(), kind, amp)
            metrics.update({"loss_dis_aux": d["loss"], "dis_aux_acc_s": d["acc_s"],
                            "dis_aux_acc_t": d["acc_t"]})
        state.step += 1
        return {k: v.detach().float() for k, v in metrics.items()}

    return step


def _seg_loss_jaccard(cfg, out, labels, key: str, metrics: Metrics) -> torch.Tensor:
    """CE + Jaccard on the main head, plus ``adv.w_seg_aux`` times the same
    on the aux head when there is one."""
    loss = L.loss_calc(out.pred, labels, jaccard=True)
    metrics[key] = loss
    if out.aux is not None:
        laux = L.loss_calc(out.aux, labels, jaccard=True)
        metrics[key + "_aux"] = laux
        loss = loss + cfg.adv.w_seg_aux * laux
    return loss


def make_baseline_step(cfg) -> Callable:
    """Supervised segmentation on source labels, or on target labels for the
    ``train_with_t`` oracle (Trainer_baseline.py:221-227)."""
    on_target = cfg.data.train_with_t and not cfg.data.train_with_s
    img_key, lab_key = ("img_t", "lab_t") if on_target else ("img_s", "lab_s")
    loss_key = "seg_t" if on_target else "seg_s"

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        state.seg.train()
        with autocast(cfg.model.dtype, batch[img_key].device):
            out = state.seg(batch[img_key])
        metrics: Metrics = {}
        loss = _seg_loss_jaccard(cfg, out, batch[lab_key], loss_key, metrics)
        _seg_update(state, loss, sched["lr"])
        state.step += 1
        return {k: v.detach().float() for k, v in metrics.items()}

    return step


def make_adaptseg_step(cfg) -> Callable:
    """Output-space adversarial adaptation (``slcl_tpu/train/steps.py:241-
    272``, Trainer_AdaptSeg.py): CE + Jaccard on source plus ``w_seg_aux``
    times the aux head's, and the ``w_dis``/``w_dis_aux`` terms of the
    discriminators on the target softmax."""

    def gen_loss(state, batch, sched, amp):
        with amp:
            out_s = state.seg(batch["img_s"])
            out_t = state.seg(batch["img_t"])
        metrics: Metrics = {}
        total = _seg_loss_jaccard(cfg, out_s, batch["lab_s"], "seg_s", metrics)
        total = total + _adv_terms(cfg, state, out_t, "softmax", amp, metrics)
        return total, out_s, out_t, metrics

    return _gan_step(cfg, gen_loss, "softmax")


def make_advent_step(cfg) -> Callable:
    """Entropy-map adversarial adaptation, with the optional direct entropy
    and class-prior terms (Trainer_Advent.py:55-180)."""

    def gen_loss(state, batch, sched, amp):
        with amp:
            out_s = state.seg(batch["img_s"])
            out_t = state.seg(batch["img_t"])
        metrics: Metrics = {}
        total = _seg_loss_jaccard(cfg, out_s, batch["lab_s"], "seg_s", metrics)
        total = total + _adv_terms(cfg, state, out_t, "advent", amp, metrics)
        if cfg.adv.w_ent or cfg.adv.w_prior:
            probs_t = torch.softmax(out_t.pred.float(), dim=-1)
        if cfg.adv.w_ent:
            # entropy of the main target prediction
            loss_ent = L.loss_entropy(probs_t, 1e-7)
            metrics["loss_ent"] = loss_ent
            total = total + cfg.adv.w_ent * loss_ent
        if cfg.adv.w_prior:
            loss_prior = L.loss_class_prior(probs_t, cfg.adv.class_prior,
                                            cfg.adv.prior_slack)
            metrics["loss_prior"] = loss_prior
            total = total + loss_prior
        return total, out_s, out_t, metrics

    return _gan_step(cfg, gen_loss, "advent")


def make_mpscl_step(cfg, centroids_loaded: bool = False) -> Callable:
    c = cfg.contrastive
    n_class = cfg.model.num_classes

    def gen_loss(state, batch, sched, amp):
        with amp:
            out_s = state.seg(batch["img_s"])
            out_t = state.seg(batch["img_t"])
        labels_s = batch["lab_s"]

        # seg loss: CE + dice (Trainer_MPSCL.py:125)
        loss_seg = (L.loss_calc(out_s.pred, labels_s, jaccard=False)
                    + L.dice_loss(out_s.pred, labels_s))
        metrics: Metrics = {"seg_s": loss_seg}

        # EMA class centres from detached source features; zero-init
        # centres adopt the first batch means outright
        centers = cen.update_class_center_iter(
            out_s.dcdr_ft, labels_s, state.centroids, momentum=c.class_center_m,
            num_classes=n_class,
            bootstrap=None if centroids_loaded else (state.step == 0)).detach()
        mpcl_src = L.mpcl_loss_calc(
            out_s.dcdr_ft, labels_s, centers, temperature=c.src_temp,
            base_temperature=c.src_base_temp, margin=c.src_margin,
            easy_margin=c.easy_margin)
        # target: pseudo-labels, gap mask and MPCL in one pass
        mpcl_trg = L.mpcl_pseudo_loss(
            out_t.dcdr_ft, centers, temperature=c.trg_temp,
            base_temperature=c.trg_base_temp, margin=c.trg_margin,
            easy_margin=c.easy_margin, pixel_sel_th=c.pixel_sel_th)
        metrics["loss_mpscl_tr"] = mpcl_src
        metrics["loss_mpscl_tg"] = mpcl_trg

        # CNR: match target centroid norms to source (MCCL formula,
        # Trainer_MCCL.py:303-315), P = 1
        loss_cnr = torch.zeros((), dtype=torch.float32, device=centers.device)
        if c.CNR and c.CNR_w > 0:
            probs_t = torch.softmax(out_t.pred.float(), dim=-1)
            res = cen.target_soft_centroids(
                out_t.dcdr_ft, probs_t, partition=1, threshold=c.thd,
                weighted_ave=c.wtd_ave, num_classes=n_class)
            loss_cnr = L.cnr_loss(centers, res.centroids[0])
        metrics["loss_cnr"] = loss_cnr

        warm = sched["warm"]
        total = (loss_seg + _adv_terms(cfg, state, out_t, "weighted", amp, metrics)
                 + warm * (c.w_mpcl_s * mpcl_src + c.w_mpcl_t * mpcl_trg
                           + c.CNR_w * loss_cnr))
        state.centroids = centers
        return total, out_s, out_t, metrics

    return _gan_step(cfg, gen_loss, "weighted")


DrawAssign = Callable[[int, int, torch.device], torch.Tensor]


def splitmix64(x: int) -> int:
    """splitmix64's output function of a 64-bit ``x``: a bijection that mixes
    every input bit into the low 32 bits, which are all that the CPU's
    generator keeps of a seed."""
    mask = (1 << 64) - 1
    z = (x + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def rmc_seed(seed: int, step: int) -> int:
    """The rMC draw's generator seed at ``step`` of a run seeded ``seed``:
    splitmix64 of (seed, step), so every pair seeds its own stream."""
    return splitmix64(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def clip_step_norm(step_vec: torch.Tensor, clip: float) -> torch.Tensor:
    """Cap ``step_vec``'s L2 (Frobenius) norm at ``clip``; non-finite entries
    are zeroed first, so an overflowed ascent step (1 / loss -> inf) is
    clipped rather than turned into NaN (``slcl_tpu/train/steps.py:39-49``)."""
    step_vec = torch.where(torch.isfinite(step_vec), step_vec,
                           torch.zeros_like(step_vec))
    sn = torch.linalg.vector_norm(step_vec)
    return step_vec * torch.clamp(clip / (sn + 1e-12), max=1.0)


def rain_pair(rain_cfg, img_s: torch.Tensor, img_t: torch.Tensor):
    """(content, style) of the stylisation (Trainer_MCCL.py:196-202): one
    image of each by default; ``mulstyle`` the whole batches; ``mulstyle2``
    the whole content batch and one style image. ``mulstyle2`` wins, as the
    reference's if/elif order has it."""
    if rain_cfg.mulstyle2:
        return img_s, img_t[0:1]
    if rain_cfg.mulstyle:
        return img_s, img_t
    return img_s[0:1], img_t[0:1]


def make_mccl_step(cfg, centroids_loaded: bool = False,
                   draw_assign: Optional[DrawAssign] = None,
                   draw_noise=None) -> Callable:
    """MCCL, "SLCL proper" (``slcl_tpu/train/steps.py:414-673``), with RAIN
    under ``rain.enabled``. ``draw_assign(m, P, device)`` replaces the rMC
    draw (int32 partition ids of the ``img_t`` pixels): by default
    ``torch.randint`` from a generator on the step's device seeded with
    :func:`rmc_seed` of (``state.seed``, ``state.step``). ``draw_noise``
    replaces RAIN's noise (``steps_rain.RainNoise``).

    With RAIN the frozen ``state.rain`` stylises :func:`rain_pair`'s
    content (blended with it by ``rain.style_alpha`` < 1), the stylised
    images join the source forward, ``seg_style`` (CE + Jaccard on them
    against the content's labels) and ``rain.consist_w`` times the
    bottleneck consistency join the loss, and the sampling takes the
    epsilon ascent on ``seg_style`` alone."""
    c = cfg.contrastive
    P = max(int(c.part), 1)
    n_class = cfg.model.num_classes
    gens: Dict[torch.device, torch.Generator] = {}
    use_rain = cfg.rain.enabled
    if use_rain:
        from . import steps_rain as R
        noise = R.RainNoise(draw_noise)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        img_s, labels_s = batch["img_s"], batch["lab_s"]
        img_t, img_t_aug = batch["img_t"], batch["img_t_aug"]
        dev = img_s.device
        s_size, t_size = img_s.shape[0], img_t.shape[0]
        state.seg.train()
        style_size = 0
        x_src = img_s
        if use_rain:
            # the style net in float32, before the segmentor's autocast
            img_style, sampling = R.stylize(state, *rain_pair(cfg.rain, img_s, img_t),
                                            sched, noise)
            style_size = img_style.shape[0]
            if cfg.rain.style_alpha < 1.0:
                a = cfg.rain.style_alpha
                img_style = a * img_style + (1.0 - a) * img_s[:style_size]
            x_src = torch.cat([img_style, img_s])
        seg_sz = style_size + s_size
        btl_src = None
        with autocast(cfg.model.dtype, dev):
            if c.concat_forward:
                # one forward over all (Trainer_MCCL.py:217/:246): BatchNorm
                # statistics mix the domains
                out = state.seg(torch.cat([x_src, img_t, img_t_aug]))
                pred_src_all, pred_t_all = out.pred[:seg_sz], out.pred[seg_sz:]
                dcdr_s = out.dcdr_ft[style_size:seg_sz]
                dcdr_t = out.dcdr_ft[seg_sz:seg_sz + t_size]
                dcdr_t_aug = out.dcdr_ft[seg_sz + t_size:]
                if use_rain:
                    btl_src = out.bottleneck[:seg_sz]
            else:
                # two domain-pure forwards; running statistics carry over
                out_s = state.seg(x_src)
                out_t = state.seg(torch.cat([img_t, img_t_aug]))
                pred_src_all, pred_t_all = out_s.pred, out_t.pred
                dcdr_s = out_s.dcdr_ft[style_size:]
                dcdr_t, dcdr_t_aug = out_t.dcdr_ft[:t_size], out_t.dcdr_ft[t_size:]
                btl_src = out_s.bottleneck
        pred_s = pred_src_all[style_size:seg_sz]

        loss_seg = L.loss_calc(pred_s, labels_s, jaccard=True)
        metrics: Metrics = {"seg_s": loss_seg}
        total = loss_seg
        if use_rain:
            # the stylised branch's seg loss and the bottleneck consistency
            # (Trainer_MCCL.py:221-244)
            loss_style = L.loss_calc(pred_src_all[:style_size], labels_s[:style_size],
                                     jaccard=True)
            loss_consist = R.consistency(btl_src[style_size:2 * style_size],
                                         btl_src[:style_size])
            metrics["seg_style"] = loss_style
            metrics["loss_consist"] = loss_consist
            total = total + loss_style + cfg.rain.consist_w * loss_consist
            metrics.update(R.style_diagnostics(img_style, img_s[:style_size],
                                               pred_src_all[:style_size], pred_s,
                                               labels_s, n_class))
        probs_t_all = torch.softmax(pred_t_all.float(), dim=-1)
        probs_t, probs_t_aug = probs_t_all[:t_size], probs_t_all[t_size:]
        if c.seg_pseudo:
            lp = L.seg_pseudo_loss(probs_t, c.thd, n_class)
            metrics["loss_pseudo"] = lp
            total = total + 0.5 * lp

        # source centroids, EMA across steps; zero-init centres adopt the
        # first batch means outright
        centroid_s = cen.source_centroids(
            dcdr_s, labels_s, num_classes=n_class, previous=state.centroids,
            momentum=c.ctd_mmt,
            bootstrap=None if centroids_loaded else state.step == 0).detach()

        assign = None
        if P > 1:
            m = dcdr_t.shape[0] * dcdr_t.shape[1] * dcdr_t.shape[2]
            if draw_assign is not None:
                assign = draw_assign(m, P, dev)
            else:
                g = gens.get(dev)
                if g is None:
                    g = gens[dev] = torch.Generator(device=dev)
                g.manual_seed(rmc_seed(state.seed, state.step))
                assign = torch.randint(0, P, (m,), generator=g, device=dev,
                                       dtype=torch.int32)
        res_t = cen.target_soft_centroids(
            dcdr_t, probs_t, partition=P, assign=assign, threshold=c.thd,
            weighted_ave=c.wtd_ave, num_classes=n_class, with_std=c.stdmin)
        res_ta = cen.target_soft_centroids(
            dcdr_t_aug, probs_t_aug, partition=1, threshold=c.thd,
            weighted_ave=c.wtd_ave, num_classes=n_class)
        centroid_t_aug = res_ta.centroids[0]
        metrics["ratio_t"] = res_t.ratio
        metrics["ratio_t_aug"] = res_ta.ratio

        # diagnostics: pseudo-label maturity, source-target alignment and
        # the spread of the target centroids (foreground classes)
        metrics["conf_t"] = probs_t.max(dim=-1).values.mean()
        t0 = res_t.centroids[0].detach()
        t0 = t0 / (torch.linalg.vector_norm(t0, dim=-1, keepdim=True) + 1e-12)
        s0 = centroid_s / (torch.linalg.vector_norm(centroid_s, dim=-1, keepdim=True)
                           + 1e-12)
        fg = (torch.arange(n_class, device=dev) >= 1).float()
        metrics["align_st"] = (torch.diagonal(t0 @ s0.T) * fg).sum() / fg.sum()
        off = (1.0 - torch.eye(n_class, device=dev)) * torch.outer(fg, fg)
        metrics["spread_tt"] = ((t0 @ t0.T) * off).sum() / off.sum()

        # CNR and the inter/intra contrastive terms, averaged over the P
        # partitions
        cnr = inter = intra = torch.zeros((), dtype=torch.float32, device=dev)
        for p in range(P):
            cent_p = res_t.centroids[p]
            cnr = cnr + L.cnr_loss(centroid_s, cent_p) / P
            inter = inter + L.centroid_contrastive_loss(
                centroid_s, cent_p, bg=c.bg, split=c.contrast_split) / P
            intra = intra + L.centroid_contrastive_loss(
                cent_p, centroid_t_aug, bg=c.bg, split=c.contrast_split) / P
        metrics["CNR"] = cnr
        metrics["inter_c_loss"] = inter
        metrics["intra_c_loss"] = intra

        contrast = c.inter_w * inter + (c.intra_w * intra if c.intra else 0.0)
        warm = sched["warm"]
        if c.clda:
            total = total + warm * contrast
        if c.CNR:
            total = total + warm * c.CNR_w * cnr
        if c.stdmin:
            total = total + warm * c.w_stdmin * res_t.stddevs.sum()
        if use_rain:
            # the ascent differentiates the stylised seg loss alone (the
            # reference's samp_loss, Trainer_MCCL.py:229-241)
            state.sampling, step_vec = R.epsilon_ascent(cfg, sampling, loss_style, sched)
            metrics["eps_step_norm"] = (sched.get("eps_on", 0.0)
                                        * torch.linalg.vector_norm(step_vec))
            metrics["sampling_norm"] = torch.linalg.vector_norm(state.sampling)
            metrics["seg_style_val"] = loss_style
        _seg_update(state, total, sched["lr"])
        state.centroids = centroid_s
        state.step += 1
        return {k: v.detach().float() for k, v in metrics.items()}

    return step


def build_step(cfg, centroids_loaded: bool = False,
               draw_assign: Optional[DrawAssign] = None, draw_noise=None) -> Callable:
    """The step of ``cfg.method``; ``draw_assign`` and ``draw_noise`` replace
    the rMC draw and RAIN's noise (tests share the JAX package's)."""
    m = cfg.method
    if m == "baseline":
        return make_baseline_step(cfg)
    if m == "adaptseg":
        return make_adaptseg_step(cfg)
    if m == "advent":
        return make_advent_step(cfg)
    if m in ("mpscl", "slcl"):
        return make_mpscl_step(cfg, centroids_loaded=centroids_loaded)
    if m == "mccl":
        return make_mccl_step(cfg, centroids_loaded=centroids_loaded,
                              draw_assign=draw_assign, draw_noise=draw_noise)
    if m == "rain":
        from .steps_rain import make_rain_seg_step
        return make_rain_seg_step(cfg, draw_noise=draw_noise)
    if m == "pretrain_rain":
        from .steps_rain import make_pretrain_rain_step
        return make_pretrain_rain_step(cfg, draw_noise=draw_noise)
    raise NotImplementedError(
        f"method {m!r}: slcl_torch ports baseline, adaptseg, advent, mpscl, slcl, "
        "mccl, rain and pretrain_rain only")
