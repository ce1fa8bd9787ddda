"""RAIN train steps: the style net's pretraining and RAIN-augmented
segmentation (counterpart of ``slcl_tpu/train/steps_rain.py``), and the
pieces ``make_mccl_step`` shares with them under ``rain.enabled``.

``pretrain_rain`` (reference Pretrainer_RAIN.train_epoch): one forward of
:meth:`RAIN.losses` and one Adam step on ``content_weight * loss_c +
style_weight * loss_s + latent_weight * loss_l + recon_weight * loss_r``;
the staged backward of the reference is the detach inside ``losses``.

``rain`` (reference Trainer_RAIN.train_epoch): stylise ``img_s[0:1]`` in
the style of ``img_t[0:1]``, CE + Jaccard on ``[stylised, source]``, the
bottleneck consistency MSE between stylised and source, and the epsilon
ascent ``sampling += lr_eps / loss_seg * d loss_seg / d sampling``.

One forward, two gradients: ``sampling`` is a leaf that requires grad.
``torch.autograd.grad`` takes d(seg loss)/d(sampling) with the graph kept,
then the segmentor's update takes the full loss's gradient for its
parameters alone (``backward(inputs=params)``). The style net runs in
float32 outside the segmentor's autocast region; only the stylised image
enters the segmentor. Each call is one epsilon iteration: the trainer calls
it ``rain.eps_iters`` times a batch after warmup, ``sched["fresh"]`` set on
the first (a fresh sampling) and ``sched["eps_on"]`` once warm.

The noise of a step is standard normal from a generator on the step's
device seeded with :func:`noise_seed` of (``state.seed``, ``state.step``),
so a restored checkpoint repeats every later draw; ``draw_noise(shape,
device)`` replaces it (tests share the JAX package's noise through it).

Under data parallelism the stylised pair is the global batch's first rows
(``steps.rain_pair``), stylised alike on every rank and fed to the
segmentor on data rank 0 (under ``rain.mulstyle`` each data rank stylises
its own images with its rows of the sampling); the ascent's gradient is
the sum of the ranks' gradients of their shares, and the consistency and
diagnostics are the global batch's. Under spatial partitioning the style
net runs on the row bands too (``models/rain.py``: reflect halos, AdaIN
statistics summed over the model ranks).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.rain import LATENT
from ..ops import losses as L
from ..parallel import mesh as dp
from .state import TrainState
from .steps import (Generators, Metrics, _seg_update, ascent_backward, autocast,
                    clip_step_norm, rain_rows, select, splitmix64)

DrawNoise = Callable[[Tuple[int, ...], torch.device], torch.Tensor]

# salt of the noise stream: (seed, step) seeds another stream than rmc_seed's
_NOISE_SALT = 0x5241494E5F4E4F49


def noise_seed(seed: int, step: int) -> int:
    """The RAIN noise generator's seed at ``step`` of a run seeded ``seed``:
    splitmix64 of the salted (seed, step) pair."""
    pair = ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)
    return splitmix64(pair ^ _NOISE_SALT)


def noise_draw(gens: Generators, seed: int, step: int, shape,
               dev: torch.device) -> torch.Tensor:
    """The standard normal noise of ``shape`` of step ``step`` of a run
    seeded ``seed``."""
    return torch.randn(tuple(shape), generator=gens.seeded(dev, noise_seed(seed, step)),
                       device=dev)


class RainNoise:
    """A step's standard normal noise of ``shape``: ``draw_noise`` when
    given, else :func:`noise_draw` for the state's seed and step."""

    def __init__(self, draw_noise: Optional[DrawNoise] = None):
        self.draw_noise = draw_noise
        self.gens = Generators()

    def __call__(self, state: TrainState, shape, dev: torch.device) -> torch.Tensor:
        if self.draw_noise is not None:
            return self.draw_noise(tuple(shape), dev)
        return noise_draw(self.gens, state.seed, state.step, shape, dev)


def stylized_to_gray3(img_style: torch.Tensor) -> torch.Tensor:
    """Channel mean, stacked three times (Trainer_RAIN.py:103-113); NHWC."""
    g = img_style.mean(dim=-1, keepdim=True)
    return torch.cat([g, g, g], dim=-1)


def stylize(state: TrainState, content: torch.Tensor, style: torch.Tensor,
            sched: Dict[str, float], noise: RainNoise, per_image: bool = False):
    """``(gray 3-channel stylised content, sampling)``: a fresh sampling of
    ``style`` when ``sched["fresh"]`` is set, else the carried one, as a
    leaf that requires grad (a device flag draws and selects). Call it
    outside any autocast region: the style net runs in float32.

    ``per_image`` (``rain.mulstyle``): ``style`` is this data rank's rows of
    the global batch and the sampling has a row per image of the global
    batch. A fresh one takes this rank's rows of the global noise draw and
    is gathered whole; each rank stylises with its rows of it, so the
    sampling stays replicated."""
    fresh = sched.get("fresh", 1.0)
    sampling = state.sampling
    if isinstance(fresh, torch.Tensor) or fresh > 0:
        rows = style.shape[0] * (dp.data_size() if per_image else 1)
        z = noise(state, (rows, LATENT), style.device)
        drawn = state.rain.sample(style, dp.local_rows(z) if per_image else z)
        sampling = select(fresh, dp.gather_rows(drawn) if per_image else drawn, sampling)
    sampling = sampling.detach().requires_grad_(True)
    img, _ = state.rain.style_transfer(content, style,
                                       dp.local_rows(sampling) if per_image else sampling)
    return stylized_to_gray3(img), sampling


def epsilon_ascent(cfg, sampling: torch.Tensor, seg_loss: torch.Tensor,
                   sched: Dict[str, float]):
    """``(new sampling, step)``: ``step = lr_eps / seg_loss * d seg_loss /
    d sampling`` (Trainer_RAIN.py:133-147), its norm capped at
    ``rain.eps_clip`` when that is positive, added when ``sched["eps_on"]``
    is set. Keeps the graph for the parameters' backward that follows."""
    # the sampling is replicated: each rank backpropagates its share of the
    # global loss, whose all-reduces' backwards hand every rank the global
    # loss's cotangent, so a rank's gradient is its own pixels' part and
    # the sum over the pixel group counts each pixel once (under spatial
    # partitioning the model ranks' parts flow through the halo exchanges)
    with ascent_backward():
        (g,) = torch.autograd.grad(seg_loss / dp.pixel_size(), sampling, retain_graph=True)
    g = dp.sum_over(dp.current(), g.contiguous())
    step_vec = (cfg.optim.lr_eps / seg_loss.detach()) * g
    if cfg.rain.eps_clip > 0:
        step_vec = clip_step_norm(step_vec, cfg.rain.eps_clip)
    base = sampling.detach()
    return select(sched.get("eps_on", 0.0), base + step_vec, base), step_vec


def consistency(b_src: torch.Tensor, b_style: torch.Tensor) -> torch.Tensor:
    """Bottleneck consistency MSE in float32."""
    return dp.gmean((b_src.float() - b_style.float()) ** 2)


def _counts32(x: torch.Tensor) -> torch.Tensor:
    """32-bin histogram counts of intensities in [0, 1), the ends clamped. A
    scatter of ones, not ``bincount``, which reads its input's maximum back
    to the host; the sums are whole numbers, exact in any order."""
    idx = (x.float() * 32.0).to(torch.int32).clamp(0, 31).reshape(-1).long()
    return torch.zeros(32, device=x.device, dtype=torch.float32).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.float32))


def _hist32(x: torch.Tensor) -> torch.Tensor:
    """:func:`_counts32` as shares."""
    h = _counts32(x)
    return h / torch.clamp(h.sum(), min=1.0)


def style_diagnostics(img_style: torch.Tensor, src_ref: torch.Tensor,
                      pred_style: torch.Tensor, pred_s: torch.Tensor,
                      labels_s: torch.Tensor, n_class: int) -> Metrics:
    """The stylised branch's diagnostics (``slcl_tpu/train/steps.py``'s
    MCCL + RAIN step), all without gradient: ``style_hist_d``, the total
    variation distance of the 32-bin intensity histograms of the stylised
    batch and its source content; ``style_mean``, ``style_std``,
    ``src_mean``; and the hard per-class Dice of each branch against the
    source labels, ``dice_style_c{k}`` / ``dice_src_c{k}``."""
    sty = img_style.detach().float()
    if dp.data_parallel():
        return _style_diagnostics_global(sty, src_ref.float(), pred_style, pred_s,
                                         labels_s, n_class)
    m: Metrics = {
        "style_hist_d": 0.5 * (_hist32(sty) - _hist32(src_ref)).abs().sum(),
        "style_mean": sty.mean(), "style_std": sty.std(correction=0),
        "src_mean": src_ref.float().mean()}
    lab_sty = labels_s[:img_style.shape[0]]
    cls_sty = pred_style.detach().argmax(-1)
    cls_src = pred_s.detach().argmax(-1)
    for k in range(1, n_class):
        for tag, cls_map, lab_map in (("style", cls_sty, lab_sty),
                                      ("src", cls_src, labels_s)):
            pk = (cls_map == k).float()
            lk = (lab_map == k).float()
            m[f"dice_{tag}_c{k}"] = (2.0 * (pk * lk).sum()
                                     / torch.clamp(pk.sum() + lk.sum(), min=1.0))
    return m


def _style_diagnostics_global(sty, src_ref, pred_style, pred_s, labels_s,
                              n_class: int) -> Metrics:
    """:func:`style_diagnostics` over the global batch: every count and sum
    all-summed over the data ranks in one call, then the same formulas
    (the stds from E[x^2] - E[x]^2)."""
    lab_sty = labels_s[:sty.shape[0]]
    cls_sty = pred_style.detach().argmax(-1)
    cls_src = pred_s.detach().argmax(-1)
    dice = []
    for k in range(1, n_class):
        for cls_map, lab_map in ((cls_sty, lab_sty), (cls_src, labels_s)):
            pk, lk = (cls_map == k).float(), (lab_map == k).float()
            dice += [(pk * lk).sum(), pk.sum() + lk.sum()]
    moments = [sty.sum(), (sty * sty).sum(), sty.new_tensor(float(sty.numel())),
               src_ref.sum(), src_ref.new_tensor(float(src_ref.numel()))]
    tot = dp.all_sum(torch.cat([_counts32(sty), _counts32(src_ref),
                                torch.stack(moments + dice)]))
    h_sty, h_src, rest = tot[:32], tot[32:64], tot[64:]
    mean = rest[0] / rest[2]
    m: Metrics = {
        "style_hist_d": 0.5 * (h_sty / torch.clamp(h_sty.sum(), min=1.0)
                               - h_src / torch.clamp(h_src.sum(), min=1.0)).abs().sum(),
        "style_mean": mean,
        "style_std": torch.sqrt(torch.clamp(rest[1] / rest[2] - mean * mean, min=0.0)),
        "src_mean": rest[3] / rest[4]}
    i = 5
    for k in range(1, n_class):
        for tag in ("style", "src"):
            m[f"dice_{tag}_c{k}"] = 2.0 * rest[i] / torch.clamp(rest[i + 1], min=1.0)
            i += 2
    return m


def make_pretrain_rain_step(cfg, draw_noise: Optional[DrawNoise] = None) -> Callable:
    """One Adam step of the RAIN net (``state.seg``) on the weighted sum of
    its four losses; content ``img_s``, style ``img_t``."""
    r = cfg.rain
    noise = RainNoise(draw_noise)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        img_s, img_t = batch["img_s"], batch["img_t"]
        z = noise(state, (img_t.shape[0], LATENT), img_t.device)
        loss_c, loss_s, loss_l, loss_r = state.seg.losses(img_s, img_t, z)
        total = (r.content_weight * loss_c + r.style_weight * loss_s
                 + r.latent_weight * loss_l + r.recon_weight * loss_r)
        _seg_update(state, total, sched["lr"])
        state.step += 1
        return {k: v.detach().float() for k, v in
                (("loss_c", loss_c), ("loss_s", loss_s), ("loss_l", loss_l),
                 ("loss_r", loss_r))}

    return step


def make_rain_seg_step(cfg, draw_noise: Optional[DrawNoise] = None) -> Callable:
    """One epsilon iteration of RAIN-augmented supervised segmentation: the
    frozen ``state.rain`` stylises, the segmentor takes one step on CE +
    Jaccard over ``[stylised, source]`` plus ``rain.consist_w`` times the
    bottleneck consistency, and ``state.sampling`` takes the ascent."""
    consist_w = cfg.rain.consist_w
    noise = RainNoise(draw_noise)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             sched: Dict[str, float]) -> Metrics:
        img_s, labels_s, img_t = batch["img_s"], batch["lab_s"], batch["img_t"]
        state.seg.train()
        img_style, sampling = stylize(state, dp.first_rows(img_s[0:1]),
                                      dp.first_rows(img_t[0:1]), sched, noise)
        img_style = rain_rows(img_style, False)
        n = img_style.shape[0]
        with autocast(cfg.model.dtype, img_s.device):
            out = state.seg(torch.cat([img_style, img_s]))
        loss_consist = consistency(out.bottleneck[n:2 * n], out.bottleneck[:n])
        loss_seg = L.loss_calc(out.pred, torch.cat([labels_s[:n], labels_s]),
                               jaccard=True)
        new_sampling, _ = epsilon_ascent(cfg, sampling, loss_seg, sched)
        _seg_update(state, loss_seg + consist_w * loss_consist, sched["lr"])
        # in place, after the update, whose backward reads the carried one
        state.sampling.copy_(new_sampling)
        state.step += 1
        return {"seg": loss_seg.detach().float(),
                "loss_consist": loss_consist.detach().float()}

    return step
