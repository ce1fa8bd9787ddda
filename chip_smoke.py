#!/usr/bin/env python3
"""On-card smoke test of the ``slcl_torch`` port (one CUDA card).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. build: compile the four kernel libraries from ``slcl_torch/csrc`` with
     nvcc for sm_90a, one nvcc per source, all started together; no
     instantiation of a kernel that holds rows or sums in registers (the
     read-only forwards, every soft-centroid kernel, the std kernels at
     every F, type and P among them) may spill;
  2. kernels: hold each kernel against its plain PyTorch version on the
     card at the main path's shapes (M = 16*224*224 rows, F = 32, C = 4;
     bf16 and f32 features): values and gradients within the stated
     tolerances, pseudo-labels and the fused target loss exact apart from
     counted near-tie rows, two launches bit-identical; then time kernel,
     plain version and, where one PyTorch call computes the same function,
     that call; and the fused target branch against the two-op route
     (pseudo-label kernel, then the MPCL kernels) on the same features.
     The two backward kernels also run where the main shape cannot take
     them: a ragged M (a partial last tile, labels and sel read from
     memory past the last whole group of four), F = 16 and F = 64, and out-
     of-range labels; the fused backward must equal the two-op backward
     bit for bit, and zero exactly the rows that pseudo_label masks. The
     kernels that only read their rows (soft centroids, fused target loss,
     MPCL forward, pseudo-labels) run at the same shapes and at M = 100 and
     M = 1, the centroids with one and two partitions and partition ids out
     of range, the MPCL forward with sel and without and with labels out of
     range in the last rows; the fused forward's count of selected rows
     must equal the two-op route's and the number of non-zero rows of the
     fused backward. Each forward's streaming pass and final pass are timed
     apart, the MPCL forward for the step's call (no sel) and the two-op
     route's (with sel), and one torch.sum over the features is the
     yardstick of a kernel that only reads. The soft centroids' std variant
     (MCCL's stdmin) is held against the plain version at the main shape,
     the ragged ones and with out-of-range ids, both kernels launched twice
     for bit-identity; the MCCL step's four centroid launches (soft weights,
     P = 2 and P = 1, forward and backward) and their std variants are
     timed; the std kernels (their own rows: the stdmin step's P = 2 call and
     P = 1, each forward's launches apart) beside their plain versions, and
     each soft centroid row beside the one ``torch.mm`` that gives its sums
     (forward) or its dfeats (backward), a backward also beside the pair of
     mm's that gives both its outputs and a ``copy_`` of its bytes; the
     std-free backward also runs at the odd shapes above against autograd
     (dprobs at M <= 1000 against float64 within the rounding of its
     terms); and the std-free kernels' outputs
     on fixed inputs must hash to what the kernels gave before the std
     variant existed (``STD_FREE_DIGEST``);
  3. small steps: two ``slcl`` multilvl+CNR steps, two ``advent`` multilvl
     steps, two ``baseline`` steps and two ``mccl`` steps in each forward
     mode (stdmin and seg_pseudo on; one shared rMC draw) on DRUNet; two
     ``slcl`` multilvl and two ``mccl`` steps on a shallow ResNet-50 U-Net
     (one block a stage, base 8) at 64x64, two ``advent`` and two
     ``adaptseg`` multilvl steps on a shallow DeepLabV2 (the heads' 10x
     group included), one ``baseline`` step on UNet at base 8 and two
     ``slcl`` steps on the full UNet with ``model.filters=64`` (the F = 64
     kernels on a step): on the card (kernels) against the same steps on
     the CPU (plain versions), from the same weights and batches, in f32,
     with each run's launch counts; then RAIN at 64x64, the same way and
     with one shared noise: two ``pretrain_rain`` steps, a ``rain`` step
     fresh then carried with the epsilon ascent, and two MCCL + RAIN
     iterations of one batch with ``rain.eps_clip=3`` through the centroid
     kernels, the carried sampling held beside the metrics;
  4. train: the full-width ``method=slcl model.multilvl=true
     data.dataset=synthetic`` recipe at bs16 224x224 through the port's
     ``Trainer`` for one epoch (launch counts set to 0 just before and read
     just after: each kernel must have run its per-step count every step,
     and every loss must be finite), then twenty timed steps, then three
     steps traced with torch.profiler for the device's busy time and the
     kernels that take most of it; then the same for the ``mccl`` preset
     (phead, P = 2, soft weights; 16 source + 16 + 16 target images); then
     a short cell of the preset with ``contrastive.stdmin=true
     contrastive.w_stdmin=0.1`` (this slice's path: img_t's centroids take
     the std kernels), one epoch and ten timed steps, with the std kernels'
     launches per step and their share of the device time; then the
     backbones at full width, each one epoch with its launch counts and
     parameter count, timed steps and three profiled: ``slcl`` multilvl on
     the ResNet-50 U-Net (the paper's train_SLCL.py cell; 20 timed steps),
     the ``mccl`` preset on it, ``advent`` and ``adaptseg`` multilvl on the
     full DeepLabV2 (no kernel; 5 timed steps) and ``baseline`` on UNet;
     then RAIN (``train_rain``): the ``mccl`` preset with ``rain.enabled
     rain.update_eps rain.eps_iters=2 rain.eps_clip=3`` (``bench.py:148-160``'s
     JAX cell, random RAIN weights from seed 1234: one epoch, 10 batches = 20
     timed steps, a step being one epsilon iteration) and ``pretrain_rain``
     (bs16 content + 16 style, 10 timed steps);
  5. protocol: the SLCL protocol at the same width through the port's entry
     points (``data.gap=0.5 optim.optimizer=adam``): ``advent`` for two
     epochs, ``gen_class_centers`` from its best checkpoint, ``slcl``
     warm-started from both for two epochs (launch counts set to 0 just
     before and read just after), its final test with HD95/ASSD and KLC;
     the warm start's epoch -1 validation must equal AdvEnt's best, and a
     saved and restored state must continue as the uninterrupted one. Then
     ``mccl`` from the same AdvEnt checkpoint (which must keep the fresh
     projection head) with a centre file of its own, two epochs, test and
     the same restore check (the rMC draw follows the seed and the step);
     then RAIN: ``pretrain_rain`` one epoch (the four component ``.npz``
     files exported), ``mccl`` with ``rain.enabled=true`` loading them, a
     warmup epoch and one with the ascent (``rain.eps_iters=2``), launch
     counts and the test; a configured component file that is missing
     must raise;
  6. real-format data: an MMWHS raw NIfTI tree and an MS-CMRSeg PNG tree
     written with the port's own writers (256x256 int16 slices and
     224x224 PNGs, 128 training and 64 test slices a domain), then
     ``slcl`` (multilvl, CT -> MR, simple aug) and the ``mccl`` preset
     (bSSFP -> LGE, counter pairs) one epoch each through the training
     CLI's ``main`` with validation and the final test, at full width: each
     kernel's launches per step the synthetic cell's, finite test Dice /
     HD95 / ASSD on both domains, two passes of one Loader identical; it
     times the Loader per batch per domain (its threads alone, and in one
     thread), both Loaders zipped as an epoch runs them, an epoch with the
     loader in the loop, 20 steps back to back and 3 profiled, and the
     same for the synthetic ``slcl`` cell beside them; and heavy2's host
     path: the C++ SLIC built with g++, superpixels held to their
     contract, a heavy2 Loader epoch timed.

Prints the kernel table (with registers, spills, blocks per SM and shared
memory per block of each kernel; the centroids' per instantiation; each
kernel's launches from its own path: the ``slcl`` cell, or the stdmin cell
for the std kernels) as one JSON line, the three step cells' timing, the
protocol, the RAIN cells (``train_rain``: phase 4's two and phase 3's RAIN
runs), the real-format phase and the backbones (``train_backbones``:
phase 4's backbone cells and phase 3's runs) as one JSON line each, the
card's name
and power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and cuDNN. Run
directories go to ``runs/`` in the checkout and are removed.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

M, F, C = 16 * 224 * 224, 32, 4
# launches per slcl step; the fused target kernel takes pseudo_label's work
PER_STEP = {"mpcl_fwd": 1, "mpcl_bwd": 1, "mpcl_pseudo_fwd": 1, "mpcl_pseudo_bwd": 1,
            "pseudo_label": 0, "soft_centroids_fwd": 1, "soft_centroids_bwd": 1,
            "soft_centroids_fwd_std": 0, "soft_centroids_bwd_std": 0}
# launches per mccl step: the rMC centroids at P = 2 on img_t and P = 1 on
# img_t_aug, each 16 images (M rows)
PER_STEP_MCCL = {**dict.fromkeys(PER_STEP, 0), "soft_centroids_fwd": 2,
                 "soft_centroids_bwd": 2}
# ... with contrastive.stdmin: img_t's centroids (P = 2) take the std kernels
PER_STEP_MCCL_STD = {**PER_STEP_MCCL, "soft_centroids_fwd": 1, "soft_centroids_bwd": 1,
                     "soft_centroids_fwd_std": 1, "soft_centroids_bwd_std": 1}
# (MCCL + RAIN: per epsilon iteration, the mccl step's; the RAIN net's own
# steps launch no port kernel)
PER_METHOD = {"slcl": PER_STEP, "mccl": PER_STEP_MCCL, "mccl_stdmin": PER_STEP_MCCL_STD,
              "advent": dict.fromkeys(PER_STEP, 0), "baseline": dict.fromkeys(PER_STEP, 0),
              "adaptseg": dict.fromkeys(PER_STEP, 0), "mccl_rain": PER_STEP_MCCL,
              "rain": dict.fromkeys(PER_STEP, 0), "pretrain_rain": dict.fromkeys(PER_STEP, 0)}
# the full-width MCCL + RAIN cell's overrides (bench.py:148-160's JAX cell)
MCCL_RAIN = {"enabled": True, "update_eps": True, "eps_iters": 2, "eps_clip": 3.0}
# the step cell whose launch counts each kernel's row reports (its path)
PATH_OF = {"soft_centroids_fwd_std": "train_mccl_stdmin",
           "soft_centroids_bwd_std": "train_mccl_stdmin"}
# sha256 of the std-free centroid kernels' outputs on centroid_digest's
# inputs, as the kernels of commit 98d6b0e (before the std variant) gave
# them on an NVIDIA H100 80GB HBM3: the std variant must leave them bit for
# bit as they were
STD_FREE_DIGEST = "bc25075579b4582c5d1d2615392eed6e1f97663f5167cd45b3632fe4761d5a04"
# published peaks: (HBM bytes/s, f32 non-tensor FLOP/s)
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100": (3.35e12, 67e12),
         "H200": (4.8e12, 67e12)}
# (source, symbol part) of each kernel's main-path instantiation: bf16, F=32
# (and P=1 for the std-free centroids, P=2 for the std kernels: the stdmin
# cell's img_t call)
SYMBOLS = {"mpcl_fwd": ("mpcl", "mpcl_fwd_partialI13__nv_bfloat16Li32E"),
           "mpcl_bwd": ("mpcl", "mpcl_bwdI13__nv_bfloat16Li32E"),
           "mpcl_pseudo_fwd": ("mpcl_pseudo",
                               "mpcl_pseudo_fwd_partialI13__nv_bfloat16Li32E"),
           "mpcl_pseudo_bwd": ("mpcl_pseudo", "mpcl_pseudo_bwdI13__nv_bfloat16Li32E"),
           "pseudo_label": ("pseudo_label", "pseudo_label_kernelI13__nv_bfloat16Li32E"),
           "soft_centroids_fwd": ("soft_centroids",
                                  "centroids_fwd_partialI13__nv_bfloat16Li32ELi1ELi4EE"),
           "soft_centroids_bwd": ("soft_centroids",
                                  "centroids_bwdI13__nv_bfloat16Li32ELi1ELi4EE"),
           "soft_centroids_fwd_std": (
               "soft_centroids", "centroids_fwd_std_partialI13__nv_bfloat16Li32ELi2ELi4EE"),
           "soft_centroids_bwd_std": ("soft_centroids",
                                      "centroids_bwd_stdI13__nv_bfloat16Li32ELi2ELi4EE")}
# (C query, its arguments) for each kernel's blocks per SM and shared memory
# at the main path's instantiation; the query lives in SYMBOLS' source
OCCUPANCY = {"mpcl_fwd": ("mpcl_occupancy", (0, 1, F)),
             "mpcl_bwd": ("mpcl_occupancy", (1, 1, F)),
             "mpcl_pseudo_fwd": ("mpcl_pseudo_occupancy", (0, 1, F)),
             "mpcl_pseudo_bwd": ("mpcl_pseudo_occupancy", (1, 1, F)),
             "pseudo_label": ("pseudo_label_occupancy", (1, F)),
             "soft_centroids_fwd": ("soft_centroids_occupancy", (0, 1, F, 1, 0)),
             "soft_centroids_bwd": ("soft_centroids_occupancy", (1, 1, F, 1, 0)),
             "soft_centroids_fwd_std": ("soft_centroids_occupancy", (0, 1, F, 2, 1)),
             "soft_centroids_bwd_std": ("soft_centroids_occupancy", (1, 1, F, 2, 1))}
# parts of a CUDA kernel's name by which the profiler counts it as the
# port's, per source ("name<" for one kernel, a prefix for a family)
PORT_KERNELS = {"mpcl": ("mpcl_fwd_", "mpcl_bwd<"), "mpcl_pseudo": ("mpcl_pseudo_",),
                "pseudo_label": ("pseudo_label_kernel",),
                "soft_centroids": ("centroids_fwd_partial<", "centroids_fwd_std_partial<",
                                   "centroids_fwd_final<", "centroids_bwd<",
                                   "centroids_bwd_std<")}
# the std kernels of one stdmin step, as the profiler names them (every part
# of one entry): both streaming kernels and the std instantiation's final pass
STD_KERNELS = (("centroids_fwd_std_partial<",), ("centroids_bwd_std<",),
               ("centroids_fwd_final<", ", true>"))


def centroid_symbol(bwd: int, std: int, P: int, f: int = F,
                    ty: str = "13__nv_bfloat16") -> str:
    """The mangled-name part of a soft-centroid streaming kernel's
    instantiation (C = 4)."""
    stem = (("centroids_fwd_partial", "centroids_fwd_std_partial"),
            ("centroids_bwd", "centroids_bwd_std"))[bwd][std]
    return f"{stem}I{ty}Li{f}ELi{P}ELi4EE"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if all(part in name for part in key.split()):
            return val
    raise RuntimeError(f"no published peak for card {name!r}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # keep the card busy (~30 ms) while the host queues every launch, so the
    # events time the device's work and not the host's dispatch
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_split(fn, parts=None, iters: int = 20) -> dict:
    """Device ms per call of each of ``fn``'s kernels, apart: torch.profiler's
    CUDA events over ``iters`` calls, summed by the part of the kernel's name
    that ``parts`` gives per key (default: a forward's streaming kernel,
    *_fwd_partial*, and its final kernel, *_fwd_final)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    parts = parts or {"partial_ms": "_fwd_partial", "final_ms": "_fwd_final"}
    # the profiler now and then keeps no device event of a whole window:
    # profile again, at most three windows
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(parts, 0.0)
        seen = dict.fromkeys(parts, 0)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for key, part in parts.items():
                    if part in e.name:
                        us[key] += e.time_range.elapsed_us()
                        seen[key] += 1
        if all(seen.values()):
            break
    else:
        raise AssertionError(f"launch_split: the profiler saw {seen}")
    # a call launches each of its kernels once; the profiler may drop events,
    # so the mean is over the launches it kept
    return {k: us[k] / seen[k] / 1e3 for k in parts}


def copy_ms(nbytes: int) -> float:
    """ms of one copy_ that moves ``nbytes`` (half read, half written): what
    the card's memory gives a kernel that reads and writes as many bytes."""
    import torch
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src))


def bound(nbytes: float, flops: float, peaks) -> tuple:
    t_b, t_o = nbytes / peaks[0], flops / peaks[1]
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def close(got, want, rtol: float, atol: float, what: str) -> float:
    """Assert |got - want| <= atol + rtol*|want| elementwise; return max abs err."""
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    if bool((err > lim).any()):
        i = int(torch.argmax(err - lim))
        raise AssertionError(f"{what}: max excess at {i}: got {got.flatten()[i].item()} "
                             f"want {want.flatten()[i].item()} (rtol {rtol}, atol {atol})")
    return float(err.max())


def near_tie_rows(feats, centers, th: float):
    """Rows whose cosine top1 - top2 gap (in f64) lies within 1e-6 of 0 or
    of th: there the kernel's f32 cosines may take another label or mask."""
    import torch
    from slcl_torch.ops.cuda.pseudo_label import normalize_rows
    cos64 = (normalize_rows(feats.double()).double()
             @ (centers.double() / centers.double().norm(dim=1, keepdim=True)).T)
    top2 = torch.topk(cos64, 2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    return (gap.abs() < 1e-6) | ((gap - th).abs() < 1e-6)


def check_bwd_ring(g) -> None:
    """Phase 2, the two backward kernels where the main shape cannot reach
    them, then the fused backward against the two-op backward."""
    import torch
    from slcl_torch.ops.cuda import mpcl as K_mpcl
    from slcl_torch.ops.cuda import mpcl_pseudo as K_mp

    dev = torch.device("cuda")
    T, base_T, scale, tm, th = 0.1, 1.0, 0.1, 0.2, 0.25
    grad = torch.ones(1, device=dev)
    # a ragged M leaves a partial last tile whose last 1-3 labels and sel
    # are read from memory; F = 16 and 64 take other vector widths
    for m, f, dtype in ((M - 37, F, torch.bfloat16), (M - 37, F, torch.float32),
                        (65_536 - 5, 16, torch.bfloat16), (65_536 - 5, 64, torch.float32)):
        what = f"ring M={m} F={f} {str(dtype)[6:]}"
        g_rtol = 1.6e-2 if dtype == torch.bfloat16 else 2e-3
        feats = torch.randn(m, f, generator=g, device=dev).to(dtype)
        labels = torch.randint(0, C, (m,), generator=g, device=dev, dtype=torch.int32)
        labels[::1009] = C          # out of range: zero gradient, as one_hot gives
        labels[m - 1] = -1          # ... in the tail read from memory
        sel = torch.randint(0, 2, (m,), generator=g, device=dev).float()
        centers = torch.randn(C, f, generator=g, device=dev)
        centers = centers / centers.norm(dim=1, keepdim=True)
        x = feats.detach().requires_grad_(True)
        for s in (sel, None):
            stats = K_mpcl.mpcl_fwd_cuda(feats, labels, centers, s, T, 0.4, False, scale)
            want = K_mpcl.mpcl_plain(x, labels, centers, s, temperature=T,
                                     base_temperature=base_T, margin=0.4)
            (g_want,) = torch.autograd.grad(want, x)
            d1 = K_mpcl.mpcl_bwd_cuda(feats, labels, centers, s, T, 0.4, False, scale,
                                      grad, stats)
            if not torch.equal(d1, K_mpcl.mpcl_bwd_cuda(feats, labels, centers, s, T, 0.4,
                                                         False, scale, grad, stats)):
                raise AssertionError(f"{what}: mpcl_bwd's two launches differ")
            close(d1, g_want, g_rtol, 1e-3 * float(g_want.abs().max()),
                  f"{what} mpcl_bwd sel={s is not None}")
        near = near_tie_rows(feats, centers, th)
        stats = K_mp.mpcl_pseudo_fwd_cuda(feats, centers, T, tm, False, scale, th)
        want = K_mp.mpcl_pseudo_plain(x, centers, temperature=T, base_temperature=base_T,
                                      margin=tm, pixel_sel_th=th)
        (g_want,) = torch.autograd.grad(want, x)
        d1 = K_mp.mpcl_pseudo_bwd_cuda(feats, centers, T, tm, False, scale, th, grad, stats)
        if not torch.equal(d1, K_mp.mpcl_pseudo_bwd_cuda(feats, centers, T, tm, False, scale,
                                                         th, grad, stats)):
            raise AssertionError(f"{what}: mpcl_pseudo_bwd's two launches differ")
        close(d1[~near], g_want[~near], g_rtol, 1e-3 * float(g_want.abs().max()),
              f"{what} mpcl_pseudo_bwd")
        log(f"{what}: ok")

    for dtype in (torch.bfloat16, torch.float32):
        feats = torch.randn(M, F, generator=g, device=dev).to(dtype)
        cross_route(feats, torch.randn(C, F, generator=g, device=dev), th,
                    f"cross-route M={M} F={F} {str(dtype)[6:]}")


def cross_route(feats, centers, th: float, what: str) -> None:
    """The fused target branch against the two-op route on the same f32
    prototypes: the forwards' den equal, the backwards equal bit for bit,
    the fused backward's zero rows pseudo_label's masked rows, and its
    non-zero rows as many as the fused forward counted. pseudo_label_cuda
    normalises the centres it is given, so it gets the raw ones and the MPCL
    kernels the normalised ones it computes."""
    import torch
    from slcl_torch.ops.cuda import mpcl as K_mpcl
    from slcl_torch.ops.cuda import mpcl_pseudo as K_mp
    from slcl_torch.ops.cuda import pseudo_label as K_pl

    T, scale, tm = 0.1, 0.1, 0.2
    grad = torch.ones(1, device=feats.device)
    cen = K_pl.normalize_rows(centers).contiguous()
    lab, msk = K_pl.pseudo_label_cuda(feats, centers, th)
    st_two = K_mpcl.mpcl_fwd_cuda(feats, lab, cen, msk, T, tm, False, scale)
    st_fused = K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale, th)
    # den is an exact integer sum (+ 1e-4) in both
    if float(st_two[2]) != float(st_fused[2]):
        raise AssertionError(f"{what}: den {float(st_two[2])} vs {float(st_fused[2])}")
    d_two = K_mpcl.mpcl_bwd_cuda(feats, lab, cen, msk, T, tm, False, scale, grad, st_two)
    d_fused = K_mp.mpcl_pseudo_bwd_cuda(feats, cen, T, tm, False, scale, th, grad, st_fused)
    if not torch.equal(d_two, d_fused):
        n = int((d_two != d_fused).any(dim=1).sum())
        raise AssertionError(f"{what}: {n} rows of dfeats differ")
    zero = (d_fused == 0).all(dim=1)
    if not torch.equal(zero, msk == 0):
        n = int((zero != (msk == 0)).sum())
        raise AssertionError(f"{what}: {n} rows where the fused backward's zero rows and "
                             "pseudo_label's mask disagree")
    # forward and backward chose the same rows: den = count + 1e-4
    n_sel = int((~zero).sum())
    if n_sel != round(float(st_fused[2])):
        raise AssertionError(f"{what}: the fused backward has {n_sel} non-zero rows, the "
                             f"forward counted {float(st_fused[2])}")
    log(f"{what}: fused den == two-op den, fused backward == two-op backward bit for "
        f"bit, {n_sel} non-zero rows == rows the forward counted")


def check_fwd_shapes(g) -> None:
    """Phase 2, the kernels that only read their rows where the main shape
    cannot reach them: a ragged last tile (threads without a row, the
    centroids' rows past M), F = 16 and F = 64, fewer rows than a tile, one
    row. The soft centroids, the fused target loss, the MPCL
    forward (with sel and without, labels out of range in the last three
    rows) and the pseudo-labels, each against its plain version at the main
    shape's tolerances and launched twice for bit-identity; the soft
    centroids' std-free backward (dfeats and dprobs against autograd's, the
    rows past a whole group of four taking their ids from memory) and their
    std variant too."""
    import torch
    from slcl_torch.ops.cuda import mpcl as K_mpcl
    from slcl_torch.ops.cuda import mpcl_pseudo as K_mp
    from slcl_torch.ops.cuda import pseudo_label as K_pl
    from slcl_torch.ops.cuda import soft_centroids as K_sc

    dev = torch.device("cuda")
    g_std = torch.Generator(device=dev).manual_seed(7)
    # the std-free backward's dcents: a stream of their own, so the other
    # checks see the inputs they always had
    g_bwd = torch.Generator(device=dev).manual_seed(8)
    T, base_T, scale, tm, th = 0.1, 1.0, 0.1, 0.2, 0.25
    for m, f, dtype in ((M - 37, F, torch.bfloat16), (M - 37, F, torch.float32),
                        (65_536 - 5, 16, torch.bfloat16), (65_536 - 5, 64, torch.float32),
                        (100, F, torch.bfloat16), (1, F, torch.bfloat16)):
        what = f"fwd M={m} F={f} {str(dtype)[6:]}"
        g_rtol = 1.6e-2 if dtype == torch.bfloat16 else 2e-3
        feats = torch.randn(m, f, generator=g, device=dev).to(dtype)
        centers = torch.randn(C, f, generator=g, device=dev)
        probs = torch.softmax(torch.randn(m, C, generator=g, device=dev), dim=-1)
        assign = torch.randint(0, 2, (m,), generator=g, device=dev, dtype=torch.int32)
        # ids outside [0, P) get no weight and count in the ratio: in the
        # last three rows and elsewhere
        assign[::1013] = 2
        assign[5::2027] = -1
        assign[-3:] = torch.tensor([-1, 2, -1], dtype=torch.int32, device=dev)[-min(3, m):]
        for P in (1, 2):
            for weighted in (False, True):
                for thd in (0.0, 0.4):
                    a = assign if P > 1 else None
                    one = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, thd, weighted)
                    two = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, thd, weighted)
                    if not all(torch.equal(x, y) for x, y in zip(one, two)):
                        raise AssertionError(f"{what}: soft_centroids_fwd's two launches "
                                             "differ")
                    x = feats.detach().requires_grad_(True)
                    pr = probs.detach().requires_grad_(True)
                    want, want_ratio = K_sc.soft_centroids_plain(
                        x, pr, a, partition=P, threshold=thd, weighted=weighted)
                    tag = f"{what} soft_centroids P={P} soft={weighted} thd={thd}"
                    close(one[0], want.detach(), 1e-4, 1e-5, tag)
                    close(one[2], want_ratio, 1e-5, 0.0, tag + " ratio")
                    # the backward: a ragged last tile, ids read past the last
                    # whole group of four, rows out of range, at the main
                    # shape's tolerances
                    dc = torch.randn(P, C, f, generator=g_bwd, device=dev)
                    grads = torch.autograd.grad(want, [x, pr] if weighted else [x], dc)
                    d1 = K_sc.soft_centroids_bwd_cuda(feats, probs, a, P, thd, weighted, dc,
                                                      one[0], one[1], weighted)
                    d2 = K_sc.soft_centroids_bwd_cuda(feats, probs, a, P, thd, weighted, dc,
                                                      one[0], one[1], weighted)
                    if not (torch.equal(d1[0], d2[0])
                            and (not weighted or torch.equal(d1[1], d2[1]))):
                        raise AssertionError(f"{tag}: soft_centroids_bwd's two launches differ")
                    close(d1[0], grads[0], g_rtol, 1e-3 * float(grads[0].abs().max()),
                          tag + " dfeats")
                    if weighted and m > 1000:
                        close(d1[1], grads[1], 2e-3, 1e-3 * float(grads[1].abs().max()),
                              tag + " dprobs")
                    elif weighted:
                        # a few rows: a row's dprobs is the difference of two
                        # nearly equal sums (the row is most of its own
                        # centroid), which f32 rounds apart in each version:
                        # held to float64 within the rounding of its terms
                        ref, mag = centroid_dprobs_f64(feats, probs, a, P, thd, dc, one[0],
                                                       one[1])
                        err = (d1[1].double() - ref).abs()
                        if (not bool(torch.isfinite(d1[1]).all())
                                or bool((err > 1e-5 * mag).any())):
                            raise AssertionError(f"{tag} dprobs: max error {float(err.max())} "
                                                 f"beyond 1e-5 of its terms")
        check_std_variant(feats, probs, assign, g_std, what, grads=m > 1000)

        cen = K_pl.normalize_rows(centers).contiguous()
        stats = K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale, th)
        if not torch.equal(stats, K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale,
                                                            th)):
            raise AssertionError(f"{what}: mpcl_pseudo_fwd's two launches differ")
        want = K_mp.mpcl_pseudo_plain(feats, cen, temperature=T, base_temperature=base_T,
                                      margin=tm, pixel_sel_th=th)
        # the near-tie slack of the main shape's check
        n_near = int(near_tie_rows(feats, cen, th).sum())
        num, den = float(stats[1]), float(stats[2])
        slack = scale * n_near * (2 * (3.0 / T + 10.0) / den + abs(num) / den ** 2)
        close(stats[0], want, 1e-4, slack, what + " mpcl_pseudo_fwd loss")
        # no row passes the gap test: loss 0, den = 1e-4 alone
        zero = K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale, 2.0)
        if float(zero[0]) != 0.0 or float(zero[2]) != float(torch.tensor(1e-4)):
            raise AssertionError(f"{what}: an all-masked input gives loss {float(zero[0])}, "
                                 f"den {float(zero[2])}")
        cross_route(feats, centers, th, what)

        # MPCL forward with given labels: out of range in the last three rows
        # (mlpp = 0, still counted in den), fractional weights among sel
        bad = torch.tensor([C, -1, C + 3], dtype=torch.int32, device=dev)[-min(3, m):]
        labels = torch.randint(0, C, (m,), generator=g, device=dev, dtype=torch.int32)
        sel = torch.randint(0, 2, (m,), generator=g, device=dev).float()
        sel[::7] = 0.5
        label_sets = [torch.cat([labels[:-3], bad])]
        if m <= 3:   # else no row of this shape would have a label column
            label_sets.append(labels)
        for lab in label_sets:
            for s in (sel, None):
                tag = f"{what} mpcl_fwd sel={s is not None}"
                stats = K_mpcl.mpcl_fwd_cuda(feats, lab, cen, s, T, 0.4, False, scale)
                if not torch.equal(stats, K_mpcl.mpcl_fwd_cuda(feats, lab, cen, s, T, 0.4,
                                                               False, scale)):
                    raise AssertionError(f"{tag}: two launches differ")
                want = K_mpcl.mpcl_plain(feats, lab, cen, s, temperature=T,
                                         base_temperature=base_T, margin=0.4)
                close(stats[0], want, 1e-4, 0.0, tag + " loss")
                if s is None and float(stats[2]) != float(m):
                    raise AssertionError(f"{tag}: den {float(stats[2])}, expected M")
                if s is not None:   # halves and ones: the sum is exact below 2^24
                    close(stats[2], s.double().sum() + 1e-4, 1e-6, 0.0, tag + " den")

        # pseudo-labels: exact away from near-tie rows (raw centres in)
        lab_k, mask_k = K_pl.pseudo_label_cuda(feats, centers, th)
        lab_k2, mask_k2 = K_pl.pseudo_label_cuda(feats, centers, th)
        if not (torch.equal(lab_k, lab_k2) and torch.equal(mask_k, mask_k2)):
            raise AssertionError(f"{what}: pseudo_label's two launches differ")
        lab_p, mask_p = K_pl.pseudo_label_plain(feats, centers, th)
        differ = ((lab_k != lab_p) | (mask_k != mask_p)) & ~near_tie_rows(feats, centers, th)
        if bool(differ.any()):
            raise AssertionError(f"{what}: pseudo_label differs from its plain version in "
                                 f"{int(differ.sum())} rows away from a tie")
        log(f"{what}: ok")


def centroid_dprobs_f64(feats, probs, assign, P: int, thd: float, dc, cents, counts):
    """The std-free backward's dprobs (soft weights) in float64 from the
    forward's centroids and counts, and the size of the terms it sums:
    sum_f |dsums x| + sum_f |dcents cents| / (counts + 1e-7) a row and
    class, the scale of an f32 version's rounding."""
    import torch
    from slcl_torch.ops.cuda import soft_centroids as K_sc
    x = feats.double()
    m = x.shape[0]
    on = K_sc.certain_mask(probs, thd).double()
    part = torch.zeros(m, dtype=torch.long, device=x.device)
    if P > 1:
        a = assign.long()
        ok = (a >= 0) & (a < P)
        part = torch.where(ok, a, 0)
        on = on * ok.double()
    n = counts.double().reshape(P, C) + 1e-7
    ds = dc.double() / n[..., None]
    dcw = dc.double() * cents.double() / n[..., None]
    terms = ds[part] * x[:, None, :]
    ref = (terms.sum(-1) - dcw.sum(-1)[part]) * on[:, None]
    mag = (terms.abs().sum(-1) + dcw.abs().sum(-1)[part]) * on[:, None]
    return ref, mag


def check_std_variant(feats, probs, assign, g, what: str, grads: bool = True) -> dict:
    """The soft centroids' std variant (kStd) against the plain version with
    with_std, at P = 1 and 2, hard and soft, thd 0 and 0.4: two launches of
    each kernel bit-identical; centroids, ratio and stddevs at the centroids'
    tolerances; and, where ``grads``, dfeats and dprobs of sum(cents * dc) +
    sum(std * ds) against autograd's at the std-free backward's. Without
    ``grads`` (a few rows, where a class's variance is a difference of two
    nearly equal sums) the values must be finite and the centroids and ratio
    are held as above. Returns the max abs errors by (P, soft, thd): the
    forward's stddevs and the backward's dfeats."""
    import torch
    from slcl_torch.ops.cuda import soft_centroids as K_sc

    dev = feats.device
    m, f = feats.shape
    g_rtol = 1.6e-2 if feats.dtype == torch.bfloat16 else 2e-3
    dstd = torch.randn(C, generator=g, device=dev)
    errs = {}
    for P in (1, 2):
        dc = torch.randn(P, C, f, generator=g, device=dev)
        a = assign if P > 1 else None
        for weighted in (False, True):
            for thd in (0.0, 0.4):
                tag = f"{what} std P={P} soft={weighted} thd={thd}"
                one = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, thd, weighted,
                                                   with_std=True)
                two = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, thd, weighted,
                                                   with_std=True)
                if not all(torch.equal(x, y) for x, y in zip(one, two)):
                    raise AssertionError(f"{tag}: two forward launches differ")
                cents, counts, ratio, std, s2 = one
                x = feats.detach().requires_grad_(True)
                pr = probs.detach().requires_grad_(True)
                w_c, w_r, w_s = K_sc.soft_centroids_plain(x, pr, a, partition=P, threshold=thd,
                                                          weighted=weighted, with_std=True)
                close(cents, w_c.detach(), 1e-4, 1e-5, tag + " cents")
                close(ratio, w_r, 1e-5, 0.0, tag + " ratio")
                if not bool(torch.isfinite(std).all() & torch.isfinite(s2).all()):
                    raise AssertionError(f"{tag}: non-finite std")
                if not grads:
                    continue
                err_s = close(std, w_s.detach(), 1e-4, 1e-5, tag + " std")
                want = torch.autograd.grad((w_c * dc).sum() + (w_s * dstd).sum(),
                                           [x, pr] if weighted else [x])
                d1 = K_sc.soft_centroids_bwd_cuda(feats, probs, a, P, thd, weighted, dc, cents,
                                                  counts, weighted, dstd=dstd, std=std, s2=s2)
                d2 = K_sc.soft_centroids_bwd_cuda(feats, probs, a, P, thd, weighted, dc, cents,
                                                  counts, weighted, dstd=dstd, std=std, s2=s2)
                if not (torch.equal(d1[0], d2[0])
                        and (not weighted or torch.equal(d1[1], d2[1]))):
                    raise AssertionError(f"{tag}: two backward launches differ")
                err_d = close(d1[0], want[0], g_rtol, 1e-3 * float(want[0].abs().max()),
                              tag + " dfeats")
                if weighted:
                    close(d1[1], want[1], 2e-3, 1e-3 * float(want[1].abs().max()),
                          tag + " dprobs")
                errs[(P, weighted, thd)] = (err_s, err_d)
    return errs


def centroid_digest() -> str:
    """sha256 over the std-free soft-centroid kernels' outputs, forward
    (centroids, counts, ratio) and backward (dfeats, dprobs), at P = 1 and 2,
    hard and soft, thd 0 and 0.4, bf16 and f32 features, M - 37 rows, on
    inputs made with numpy from a fixed seed (uniform bits only, so the
    inputs are the same on any host). Calls only the wrappers' std-free
    signatures, which the kernels had before the std variant."""
    import hashlib

    import numpy as np
    import torch
    from slcl_torch.ops.cuda import soft_centroids as K_sc

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    m = M - 37
    f32 = (rng.random((m, F), dtype=np.float32) - np.float32(0.5)) * np.float32(4.0)
    u = rng.random((m, C), dtype=np.float32) + np.float32(0.05)
    probs = torch.from_numpy(u / u.sum(axis=1, keepdims=True)).to(dev)
    assign = torch.from_numpy(rng.integers(0, 2, m).astype(np.int32)).to(dev)
    dcents = {P: torch.from_numpy(rng.random((P, C, F), dtype=np.float32) - np.float32(0.5)
                                  ).to(dev) for P in (1, 2)}
    h = hashlib.sha256()
    for dtype in (torch.bfloat16, torch.float32):
        feats = torch.from_numpy(f32).to(dev).to(dtype)
        for P in (1, 2):
            a = assign if P > 1 else None
            for weighted in (False, True):
                for thd in (0.0, 0.4):
                    cents, counts, ratio = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P,
                                                                        thd, weighted)
                    dfeats, dprobs = K_sc.soft_centroids_bwd_cuda(
                        feats, probs, a, P, thd, weighted, dcents[P], cents, counts, weighted)
                    for t in (cents, counts, ratio, dfeats, dprobs):
                        if t is not None:
                            h.update(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    torch.cuda.synchronize()
    return h.hexdigest()


def check_kernels(peaks) -> list:
    """Phase 2: every kernel against its plain version; returns the table."""
    import torch
    from slcl_torch.ops.cuda import mpcl as K_mpcl
    from slcl_torch.ops.cuda import mpcl_pseudo as K_mp
    from slcl_torch.ops.cuda import pseudo_label as K_pl
    from slcl_torch.ops.cuda import soft_centroids as K_sc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # the std variant's and the MCCL rows' inputs: their own stream, so the
    # other checks see the inputs they always had
    g_std = torch.Generator(device=dev).manual_seed(6)
    rows = {}
    T, base_T, margin = 0.1, 1.0, 0.4
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        # bf16 rounds dfeats to 8 mantissa bits in both versions: allow two ulps
        g_rtol = 1.6e-2 if dtype == torch.bfloat16 else 2e-3
        feats = torch.randn(M, F, generator=g, device=dev).to(dtype)
        labels = torch.randint(0, C, (M,), generator=g, device=dev, dtype=torch.int32)
        sel = torch.randint(0, 2, (M,), generator=g, device=dev).float()
        centers = torch.randn(C, F, generator=g, device=dev)
        centers = centers / centers.norm(dim=1, keepdim=True)
        logits = torch.randn(M, C, generator=g, device=dev)
        probs = torch.softmax(logits, dim=-1)
        assign = torch.randint(0, 2, (M,), generator=g, device=dev, dtype=torch.int32)
        dcents = {P: torch.randn(P, C, F, generator=g, device=dev) for P in (1, 2)}

        # ---- MPCL: value (rel 1e-4) and feats-grad (rtol 2e-3 f32) ----
        for use_sel, easy in ((True, False), (False, False), (True, True)):
            s = sel if use_sel else None
            scale = T / base_T
            stats = K_mpcl.mpcl_fwd_cuda(feats, labels, centers, s, T, margin, easy, scale)
            stats2 = K_mpcl.mpcl_fwd_cuda(feats, labels, centers, s, T, margin, easy, scale)
            if not torch.equal(stats, stats2):
                raise AssertionError("mpcl_fwd: two launches differ")
            x = feats.detach().requires_grad_(True)
            want = K_mpcl.mpcl_plain(x, labels, centers, s, temperature=T,
                                     base_temperature=base_T, margin=margin,
                                     easy_margin=easy)
            (g_want,) = torch.autograd.grad(want, x)
            err_f = close(stats[0], want.detach(), 1e-4, 0.0,
                          f"mpcl fwd {tag} sel={use_sel} easy={easy}")
            grad = torch.ones(1, device=dev)
            d1 = K_mpcl.mpcl_bwd_cuda(feats, labels, centers, s, T, margin, easy, scale,
                                      grad, stats)
            d2 = K_mpcl.mpcl_bwd_cuda(feats, labels, centers, s, T, margin, easy, scale,
                                      grad, stats)
            if not torch.equal(d1, d2):
                raise AssertionError("mpcl_bwd: two launches differ")
            err_b = close(d1, g_want, g_rtol, 1e-3 * float(g_want.abs().max()),
                          f"mpcl bwd {tag} sel={use_sel} easy={easy}")
            if tag == "bf16" and not easy:
                def fwd():
                    return K_mpcl.mpcl_fwd_cuda(feats, labels, centers, s, T, margin, easy,
                                                scale)

                def plain():
                    return K_mpcl.mpcl_plain(feats, labels, centers, s, temperature=T,
                                             base_temperature=base_T, margin=margin,
                                             easy_margin=easy)
                es = feats.element_size()
                fl_row = 2 * F + 2 * C * F + 12 * C
            if tag == "bf16" and not easy and use_sel:
                # the two-op route's call (labels and sel read), and the backward
                rows["mpcl_fwd"] = {
                    "sel_max_abs_err": err_f, "sel_ms": time_ms(fwd),
                    "sel_plain_ms": time_ms(plain),
                    "sel_bound_ms": bound(M * (F * es + 4 + 4), M * fl_row, peaks)[0],
                    **{"sel_" + k: v for k, v in launch_split(fwd).items()}}
                y = K_mpcl.mpcl_plain(x, labels, centers, s, temperature=T,
                                      base_temperature=base_T, margin=margin,
                                      easy_margin=easy)
                rows["mpcl_bwd"] = {
                    "max_abs_err": err_b,
                    "ms": time_ms(lambda: K_mpcl.mpcl_bwd_cuda(
                        feats, labels, centers, s, T, margin, easy, scale, grad, stats)),
                    "plain_ms": time_ms(lambda: torch.autograd.grad(y, x, retain_graph=True)),
                    "library_ms": None,
                    "bound": bound(M * (2 * F * es + 4 + 4),
                                   M * (fl_row + 2 * C * F + 4 * F), peaks)}
                del y
            if tag == "bf16" and not easy and not use_sel:
                # the slcl step's call: the source branch, labels read, mean over M
                rows["mpcl_fwd"].update(
                    max_abs_err=err_f, ms=time_ms(fwd), plain_ms=time_ms(plain),
                    library_ms=None, bound=bound(M * (F * es + 4), M * fl_row, peaks),
                    **launch_split(fwd))
        log(f"mpcl {tag}: ok")

        # ---- pseudo-labels: exact apart from near-tie rows ----
        lab_k, mask_k = K_pl.pseudo_label_cuda(feats, centers, 0.25)
        lab_k2, mask_k2 = K_pl.pseudo_label_cuda(feats, centers, 0.25)
        if not (torch.equal(lab_k, lab_k2) and torch.equal(mask_k, mask_k2)):
            raise AssertionError("pseudo_label: two launches differ")
        lab_p, mask_p = K_pl.pseudo_label_plain(feats, centers, 0.25)
        near = near_tie_rows(feats, centers, 0.25)
        differ = (lab_k != lab_p) | (mask_k != mask_p)
        if bool((differ & ~near).any()):
            raise AssertionError(f"pseudo_label {tag}: {int((differ & ~near).sum())} "
                                 "rows differ away from a tie")
        n_near = int(near.sum())
        log(f"pseudo_label {tag}: ok ({int(differ.sum())} differing rows, "
            f"{n_near} near-tie rows)")
        if tag == "bf16":
            es = feats.element_size()
            rows["pseudo_label"] = {
                "max_abs_err": float((differ & ~near).any()),
                "near_tie_rows": n_near,
                "ms": time_ms(lambda: K_pl.pseudo_label_cuda(feats, centers, 0.25)),
                "plain_ms": time_ms(lambda: K_pl.pseudo_label_plain(feats, centers, 0.25)),
                "library_ms": None,
                "bound": bound(M * (F * es + 4 + 4), M * (2 * F + 2 * C * F), peaks),
                **launch_split(lambda: K_pl.pseudo_label_cuda(feats, centers, 0.25),
                               {"kernel_ms": "pseudo_label_kernel"})}

        # ---- fused target branch: loss rel 1e-4 beyond the near-tie rows,
        # dfeats at mpcl_bwd's tolerance away from them, all-masked = 0 ----
        tm, th, scale = 0.2, 0.25, T / base_T
        grad = torch.ones(1, device=dev)
        for easy in (False, True):
            def fused_fwd(sel_th=th):
                return K_mp.mpcl_pseudo_fwd_cuda(feats, centers, T, tm, easy, scale, sel_th)

            def fused_bwd(stats, sel_th=th):
                return K_mp.mpcl_pseudo_bwd_cuda(feats, centers, T, tm, easy, scale, sel_th,
                                                 grad, stats)
            what = f"mpcl_pseudo {tag} easy={easy}"
            stats = fused_fwd()
            if not torch.equal(stats, fused_fwd()):
                raise AssertionError(f"{what}: two forward launches differ")
            x = feats.detach().requires_grad_(True)
            want = K_mp.mpcl_pseudo_plain(x, centers, temperature=T, base_temperature=base_T,
                                          margin=tm, easy_margin=easy, pixel_sel_th=th)
            (g_want,) = torch.autograd.grad(want, x)
            # a near-tie row may take another label or mask in the kernel: that
            # moves sum(sel*mlpp) by at most 2*max|mlpp| (|mlpp| <= 3/T + 10:
            # margin logits span (2 + mm)/T, and -log z <= -log 1e-4) and den by 1
            num, den = float(stats[1]), float(stats[2])
            slack = scale * n_near * (2 * (3.0 / T + 10.0) / den + abs(num) / den ** 2)
            err_f = close(stats[0], want.detach(), 1e-4, slack, what + " loss")
            d1 = fused_bwd(stats)
            if not torch.equal(d1, fused_bwd(stats)):
                raise AssertionError(f"{what}: two backward launches differ")
            err_b = close(d1[~near], g_want[~near], g_rtol, 1e-3 * float(g_want.abs().max()),
                          what + " dfeats")
            # no row passes the gap test: den = 1e-4 alone, loss and dfeats 0
            zero = fused_fwd(2.0)
            if float(zero[0]) != 0.0 or bool(fused_bwd(zero, 2.0).any()):
                raise AssertionError(f"{what}: an all-masked input gives a non-zero result")
            if tag == "bf16" and not easy:   # the slcl step's call
                es = feats.element_size()
                fl_row = 2 * F + 2 * C * F + 16 * C
                y = K_mp.mpcl_pseudo_plain(x, centers, temperature=T,
                                           base_temperature=base_T, margin=tm,
                                           pixel_sel_th=th)

                def two_op():
                    lab, msk = K_pl.pseudo_label_cuda(feats, centers, th)
                    st = K_mpcl.mpcl_fwd_cuda(feats, lab, centers, msk, T, tm, False, scale)
                    K_mpcl.mpcl_bwd_cuda(feats, lab, centers, msk, T, tm, False, scale,
                                         grad, st)
                rows["mpcl_pseudo_fwd"] = {
                    "max_abs_err": err_f, "near_tie_rows": n_near,
                    "ms": time_ms(fused_fwd),
                    "plain_ms": time_ms(lambda: K_mp.mpcl_pseudo_plain(
                        feats, centers, temperature=T, base_temperature=base_T,
                        margin=tm, pixel_sel_th=th)),
                    "library_ms": None,
                    "bound": bound(M * F * es, M * fl_row, peaks),
                    # the same function (fwd + bwd) by both routes
                    "fused_route_ms": time_ms(lambda: fused_bwd(fused_fwd())),
                    "two_op_route_ms": time_ms(two_op),
                    **launch_split(fused_fwd)}
                rows["mpcl_pseudo_bwd"] = {
                    "max_abs_err": err_b, "near_tie_rows": n_near,
                    "ms": time_ms(lambda: fused_bwd(stats)),
                    "plain_ms": time_ms(lambda: torch.autograd.grad(y, x, retain_graph=True)),
                    "library_ms": None,
                    "bound": bound(2 * M * F * es, M * (fl_row + 2 * C * F + 4 * F), peaks)}
                del y
        log(f"mpcl_pseudo {tag}: ok")

        # ---- soft centroids: rtol 1e-4 atol 1e-5, ratio rel 1e-5, grads ----
        for P in (1, 2):
            for weighted in (False, True):
                for thd in (0.0, 0.4):
                    a = assign if P > 1 else None
                    cents, counts, ratio = K_sc.soft_centroids_fwd_cuda(
                        feats, probs, a, P, thd, weighted)
                    c2, _, r2 = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, thd,
                                                             weighted)
                    if not (torch.equal(cents, c2) and torch.equal(ratio, r2)):
                        raise AssertionError("soft_centroids_fwd: two launches differ")
                    x = feats.detach().requires_grad_(True)
                    pr = probs.detach().requires_grad_(True)
                    want, want_ratio = K_sc.soft_centroids_plain(
                        x, pr, a, partition=P, threshold=thd, weighted=weighted)
                    what = f"soft_centroids {tag} P={P} soft={weighted} thd={thd}"
                    err_f = close(cents, want.detach(), 1e-4, 1e-5, what + " fwd")
                    close(ratio, want_ratio, 1e-5, 0.0, what + " ratio")
                    grads = torch.autograd.grad(want, [x, pr] if weighted else [x],
                                                dcents[P])
                    dfeats, dprobs = K_sc.soft_centroids_bwd_cuda(
                        feats, probs, a, P, thd, weighted, dcents[P], cents, counts,
                        weighted)
                    dfeats2, _ = K_sc.soft_centroids_bwd_cuda(
                        feats, probs, a, P, thd, weighted, dcents[P], cents, counts,
                        weighted)
                    if not torch.equal(dfeats, dfeats2):
                        raise AssertionError("soft_centroids_bwd: two launches differ")
                    err_b = close(dfeats, grads[0], g_rtol,
                                  1e-3 * float(grads[0].abs().max()), what + " dfeats")
                    if weighted:
                        close(dprobs, grads[1], 2e-3, 1e-3 * float(grads[1].abs().max()),
                              what + " dprobs")
                    if tag == "bf16" and P == 1 and not weighted and thd == 0.0:
                        es = feats.element_size()
                        labels_hard = probs.argmax(dim=1)
                        sums = torch.zeros(C, F, device=dev, dtype=feats.dtype)
                        y, _ = K_sc.soft_centroids_plain(x, pr, None, partition=1)
                        rows["soft_centroids_fwd"] = {
                            "max_abs_err": err_f,
                            "ms": time_ms(lambda: K_sc.soft_centroids_fwd_cuda(
                                feats, probs, None, 1, 0.0, False)),
                            "plain_ms": time_ms(lambda: K_sc.soft_centroids_plain(
                                feats, probs, None, partition=1, weighted=False)),
                            # index_add_ takes the same per-class row sums
                            "library_ms": time_ms(lambda: sums.index_add_(
                                0, labels_hard, feats)),
                            "bound": bound(M * (F * es + 4 * C), 2 * M * F, peaks),
                            **launch_split(lambda: K_sc.soft_centroids_fwd_cuda(
                                feats, probs, None, 1, 0.0, False))}
                        # hard weights: dfeats[m] = dsums[argmax probs[m]]
                        dsums = (dcents[1][0] / (counts[:, None] + 1e-7)).to(feats.dtype)
                        rows["soft_centroids_bwd"] = {
                            "max_abs_err": err_b,
                            "ms": time_ms(lambda: K_sc.soft_centroids_bwd_cuda(
                                feats, probs, None, 1, 0.0, False, dcents[1], cents,
                                counts, False)),
                            "plain_ms": time_ms(lambda: torch.autograd.grad(
                                y, x, dcents[1], retain_graph=True)),
                            # the same gather, given the argmax labels
                            "library_ms": time_ms(lambda: dsums.index_select(
                                0, labels_hard)),
                            # probs read, dfeats written (no feats read)
                            "bound": bound(M * (F * es + 4 * C), 2 * M * F, peaks),
                            "copy_ms": copy_ms(M * (F * es + 4 * C))}
                        del y
                    if tag == "bf16" and P == 2 and not weighted and thd == 0.0:
                        # two partitions (rMC): 64 partial sums a thread
                        rows["soft_centroids_fwd"]["p2_ms"] = time_ms(
                            lambda: K_sc.soft_centroids_fwd_cuda(feats, probs, assign, 2,
                                                                 0.0, False))
        std_errs = check_std_variant(feats, probs, assign, g_std, f"soft_centroids {tag}")
        log(f"soft_centroids {tag}: ok, std variant ok")
        if tag == "bf16":
            mccl_rows(rows, feats, probs, assign, g_std, peaks, std_errs)
        torch.cuda.synchronize()
    # what the card's memory gives one PyTorch call that only reads the
    # (bf16) features
    read_only_ms = time_ms(lambda: torch.sum(feats, dtype=torch.float32))
    check_bwd_ring(g)
    check_fwd_shapes(g)
    torch.cuda.synchronize()
    return rows, read_only_ms


def mccl_rows(rows, feats, probs, assign, g, peaks, std_errs) -> None:
    """The MCCL step's four centroid launches (soft weights, f32 probs, P = 2
    on img_t and P = 1 on img_t_aug, forward and backward with dprobs), each
    with its bound, and the std kernels' rows: the stdmin step's call (P = 2)
    and the same at P = 1, each launch of the forward apart; ``std_errs``
    from check_std_variant at this shape. Beside each, the one PyTorch call
    that computes its main output (TF32 off): the (P*C, F) weighted sums as
    ``torch.mm(w_flat.t(), feats)`` and the dfeats as ``torch.mm(w_flat,
    dsums)``, ``w_flat`` (M, P*C) the soft weights split by partition, cast
    to the features' bf16 before the timing (``library_ms``: mm takes one
    dtype), and the same in f32 on an f32 copy of the features
    (``library_f32_ms``). The std rows take the same two calls."""
    import torch
    from slcl_torch.ops.cuda import soft_centroids as K_sc

    es = feats.element_size()
    dstd = torch.randn(C, generator=g, device=feats.device)
    fwd, bwd = {}, {}
    fstd = {"max_abs_err": std_errs[(2, True, 0.0)][0]}
    bstd = {"max_abs_err": std_errs[(2, True, 0.0)][1]}
    feats32 = feats.float()
    for P in (1, 2):
        a = assign if P > 1 else None
        ids = 4 * M if P > 1 else 0       # the int32 partition ids
        dc = torch.randn(P, C, F, generator=g, device=feats.device)
        # the library calls' operands: w_flat[m, p*C + c] = probs[m, c] where
        # m's partition is p
        part = (a.long() if a is not None
                else torch.zeros(M, dtype=torch.long, device=feats.device))
        w32 = torch.zeros(M, P, C, device=feats.device).scatter_(
            1, part[:, None, None].expand(M, 1, C), probs[:, None, :]).reshape(M, P * C)
        w16 = w32.to(feats.dtype)
        ds32 = dc.reshape(P * C, F)
        ds16 = ds32.to(feats.dtype)
        # the call computes the kernel's sums: the plain centroids times
        # their weight totals
        want_c, _ = K_sc.soft_centroids_plain(feats32, probs, a, partition=P, weighted=True)
        close(torch.mm(w32.t(), feats32).reshape(P, C, F)
              / (w32.sum(0).reshape(P, C, 1) + 1e-7), want_c, 1e-4, 1e-5,
              f"library mm P={P}")
        lib = {"fwd": time_ms(lambda: torch.mm(w16.t(), feats)),
               "fwd_f32": time_ms(lambda: torch.mm(w32.t(), feats32)),
               "bwd": time_ms(lambda: torch.mm(w16, ds16)),
               "bwd_f32": time_ms(lambda: torch.mm(w32, ds32))}
        # both of the backward's outputs: dfeats, and the (M, P*C) dot
        # products of the rows with the dsums that dprobs is made from
        bwd[f"p{P}_library_pair_ms"] = time_ms(
            lambda: (torch.mm(w16, ds16), torch.mm(feats, ds16.t())))
        pre = "" if P > 1 else "p1_"
        for row, kind in ((fstd, "fwd"), (bstd, "bwd")):
            row[pre + "library_ms"] = lib[kind]
            row[pre + "library_f32_ms"] = lib[kind + "_f32"]
        for row, kind in ((fwd, "fwd"), (bwd, "bwd")):
            row[f"p{P}_library_ms"] = lib[kind]
            row[f"p{P}_library_f32_ms"] = lib[kind + "_f32"]
        del w32, w16, want_c
        cents, counts, _ = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, True)
        _, _, _, std, s2 = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, True,
                                                        with_std=True)
        # feats and probs read (+ ids); the (P*C, F) outputs are negligible
        fwd_bytes = M * (F * es + 4 * C) + ids
        bwd_bytes = 2 * M * (F * es + 4 * C) + ids     # + dfeats and dprobs written
        fwd[f"p{P}_ms"] = time_ms(lambda: K_sc.soft_centroids_fwd_cuda(
            feats, probs, a, P, 0.0, True))
        fwd[f"p{P}_bound_ms"] = bound(fwd_bytes, 2 * M * F * C, peaks)[0]
        bwd[f"p{P}_ms"] = time_ms(lambda: K_sc.soft_centroids_bwd_cuda(
            feats, probs, a, P, 0.0, True, dc, cents, counts, True))
        bwd[f"p{P}_bound_ms"] = bound(bwd_bytes, 4 * M * F * C, peaks)[0]
        bwd[f"p{P}_copy_ms"] = copy_ms(bwd_bytes)
        # the plain versions: the forward, and autograd's dfeats and dprobs
        fwd[f"p{P}_plain_ms"] = time_ms(lambda: K_sc.soft_centroids_plain(
            feats, probs, a, partition=P, weighted=True))
        xp = feats.detach().requires_grad_(True)
        pp = probs.detach().requires_grad_(True)
        yp = (K_sc.soft_centroids_plain(xp, pp, a, partition=P, weighted=True)[0]
              * dc).sum()
        bwd[f"p{P}_plain_ms"] = time_ms(lambda: torch.autograd.grad(
            yp, [xp, pp], retain_graph=True))
        del yp
        fwd.update({f"p{P}_" + k: v for k, v in launch_split(
            lambda: K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, True)).items()})
        # the std kernels; "p1_" keys at P = 1, unprefixed the stdmin step's P = 2
        pre = "" if P > 1 else "p1_"
        x = feats.detach().requires_grad_(True)
        pr = probs.detach().requires_grad_(True)
        w_c, _, w_s = K_sc.soft_centroids_plain(x, pr, a, partition=P, weighted=True,
                                                with_std=True)
        y = (w_c * dc).sum() + (w_s * dstd).sum()
        fstd[pre + "ms"] = time_ms(lambda: K_sc.soft_centroids_fwd_cuda(
            feats, probs, a, P, 0.0, True, with_std=True))
        fstd[pre + "plain_ms"] = time_ms(lambda: K_sc.soft_centroids_plain(
            feats, probs, a, partition=P, weighted=True, with_std=True))
        fstd[pre + "bound"] = bound(fwd_bytes, 5 * M * F * C, peaks)
        fstd.update({pre + k: v for k, v in launch_split(
            lambda: K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, True,
                                                 with_std=True),
            {"partial_ms": "_fwd_std_partial", "final_ms": "_fwd_final"}).items()})
        bstd[pre + "ms"] = time_ms(lambda: K_sc.soft_centroids_bwd_cuda(
            feats, probs, a, P, 0.0, True, dc, cents, counts, True, dstd=dstd, std=std,
            s2=s2))
        bstd[pre + "plain_ms"] = time_ms(lambda: torch.autograd.grad(
            y, [x, pr], retain_graph=True))
        bstd[pre + "bound"] = bound(bwd_bytes, 8 * M * F * C, peaks)
        del y
    rows["soft_centroids_fwd"]["mccl"] = fwd
    rows["soft_centroids_bwd"]["mccl"] = bwd
    rows["soft_centroids_fwd_std"] = fstd
    rows["soft_centroids_bwd_std"] = bstd


def small_config(method: str = "slcl"):
    from slcl_torch.config import Config, apply_recipe
    cfg = Config()
    cfg.method = method
    cfg = apply_recipe(cfg)
    cfg.model.multilvl = method != "mccl"     # the MCCL preset: phead, no aux head
    cfg.data.dataset = "synthetic"
    cfg.data.bs, cfg.data.crop = 2, 32
    cfg.data.num_workers = 1
    cfg.model.filters, cfg.model.n_block, cfg.model.bottleneck_depth = 8, 2, 2
    cfg.model.dtype = "float32"
    return cfg


def shared_draw(seed: int):
    """An rMC draw for make_mccl_step's ``draw_assign``: ids from a CPU
    generator seeded per call, then moved to the step's device, so that a
    step on the card and one on the CPU take the same partitions."""
    import torch
    calls = [0]

    def draw(m: int, P: int, device):
        g = torch.Generator().manual_seed(seed + calls[0])
        calls[0] += 1
        return torch.randint(0, P, (m,), generator=g, dtype=torch.int32).to(device)
    return draw


def small_segmentor(kind: str, cfg, device):
    """Phase 3's shallow backbones, which the factory does not build (JAX's
    passes ``layers``/``base`` to ResNetUNet only): DeepLabV2 with one block
    a stage, UNet at base 8; seeded from ``run.seed``."""
    import torch
    from slcl_torch.models import DeepLabV2, UNet
    gen = torch.Generator().manual_seed(cfg.run.seed)
    if kind == "deeplabv2":
        seg = DeepLabV2(cfg.model.num_classes, layers=(1, 1, 1, 1),
                        multi_level=cfg.model.multilvl, generator=gen)
    else:
        seg = UNet(cfg.model.num_classes, base=8, generator=gen)
    return seg.to(device, memory_format=torch.channels_last)


def use_segmentor(trainer, seg) -> None:
    """Put ``seg`` in ``trainer``'s state: new optimizers (the DeepLab heads'
    10x group from the config), the same discriminators and centres."""
    from slcl_torch.train.state import create_train_state
    s = trainer.state
    trainer.state = create_train_state(trainer.cfg, seg, disc=s.d_main, disc_aux=s.d_aux,
                                       centroids=s.centroids)


# phase 3: (label, method, model overrides, crop, steps, a shallow backbone
# the factory does not build, the launch counts per step)
SMALL_RUNS = (
    ("slcl", "slcl", {}, 32, 2, None, "slcl"),
    ("advent", "advent", {}, 32, 2, None, "advent"),
    ("baseline", "baseline", {}, 32, 2, None, "baseline"),
    ("mccl", "mccl", {}, 32, 2, None, "mccl_stdmin"),
    ("mccl concat_forward", "mccl", {}, 32, 2, None, "mccl_stdmin"),
    # the backbones: ResNetUNet at 64x64 (at 32 its layer-4 map is 1x1)
    ("resnet50 slcl", "slcl", dict(backbone="resnet50", layers=(1, 1, 1, 1), base=8,
                                   filters=32), 64, 2, None, "slcl"),
    ("resnet50 mccl", "mccl", dict(backbone="resnet50", layers=(1, 1, 1, 1), base=8,
                                   filters=32), 64, 2, None, "mccl"),
    ("deeplabv2 advent", "advent", dict(backbone="deeplabv2"), 32, 2, "deeplabv2",
     "advent"),
    ("deeplabv2 adaptseg", "adaptseg", dict(backbone="deeplabv2"), 32, 2, "deeplabv2",
     "adaptseg"),
    ("unet baseline", "baseline", dict(backbone="unet"), 32, 1, "unet", "baseline"),
    # the F = 64 kernel instantiations on a step: UNet's 64-channel tap
    ("unet slcl F=64", "slcl", dict(backbone="unet", filters=64, multilvl=False), 32, 2,
     None, "slcl"),
)


def check_small_steps() -> dict:
    """Phase 3: for each run of SMALL_RUNS, its steps on the card vs the same
    on the CPU, same start; mccl on DRUNet in both forward modes with stdmin
    and seg_pseudo on, every mccl step pair taking one shared rMC draw.
    Returns each run's launch counts and feature width."""
    import torch
    from slcl_torch.data import to_device
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train.steps import build_step
    from slcl_torch.train.trainer import Trainer

    out = {}
    for label, method, model, crop, steps, shallow, per in SMALL_RUNS:
        cfg = small_config(method)
        cfg.data.crop = crop
        for k, v in model.items():
            setattr(cfg.model, k, v)
        if method == "mccl" and "backbone" not in model:
            cfg.contrastive.concat_forward = "concat" in label
            cfg.contrastive.stdmin, cfg.contrastive.w_stdmin = True, 0.1
            cfg.contrastive.seg_pseudo = True
        cpu = Trainer(cfg, device="cpu")
        gpu = Trainer(cfg, device="cuda")
        for t in (cpu, gpu):
            if shallow:
                use_segmentor(t, small_segmentor(shallow, cfg, t.device))
            if method == "mccl":
                t.step_fn = build_step(cfg, t.centroids_loaded, draw_assign=shared_draw(5))
        batches = [b for _, b in zip(range(steps), cpu._epoch_batches())]
        sched = cpu._sched(0)
        reset_launch_counts()
        for i, b in enumerate(batches):
            m_cpu = cpu.step_fn(cpu.state, to_device(b, torch.device("cpu")), sched)
            m_gpu = gpu.step_fn(gpu.state, to_device(b, torch.device("cuda")), sched)
            if set(m_cpu) != set(m_gpu):
                raise AssertionError(f"small {label} step {i}: metric keys differ")
            for k, v in m_cpu.items():
                # cuDNN vs CPU f32 convolution sums; one pseudo-label flip at a
                # near-tie would move loss_mpscl_tg by O(1/M)
                close(m_gpu[k].cpu(), v, 5e-3, 1e-4, f"small {label} step {i} {k}")
        counts = launch_counts()
        for name, n in PER_METHOD[per].items():
            if counts[name] != steps * n:
                raise AssertionError(f"small {label}: {name} launched {counts[name]} "
                                     f"times, expected {steps * n}")
        torch.cuda.synchronize()
        out[label] = {"steps": steps, "crop": crop, "feat_dim": gpu.state.seg.feat_dim,
                      "params": sum(p.numel() for p in gpu.state.seg.parameters()),
                      "launches": counts}
        log(f"small {label}: card matches CPU over {steps} step(s)")
    return out


def shared_noise(seed: int):
    """RAIN noise for ``build_step``'s ``draw_noise``: from a CPU generator
    seeded per call, then moved to the step's device, so that a step on the
    card and one on the CPU stylise alike."""
    import torch
    calls = [0]

    def draw(shape, device):
        g = torch.Generator().manual_seed(seed + calls[0])
        calls[0] += 1
        return torch.randn(shape, generator=g).to(device)
    return draw


# phase 3's RAIN runs: (label, method, rain overrides, (fresh, eps_on) of each
# step in turn, the launch counts per step)
SMALL_RAIN_RUNS = (
    ("pretrain_rain", "pretrain_rain", {}, ((1.0, 0.0), (1.0, 0.0)), "pretrain_rain"),
    ("rain", "rain", {"update_eps": True}, ((1.0, 0.0), (0.0, 1.0)), "rain"),
    # two epsilon iterations of one batch through the centroid kernels
    ("mccl rain", "mccl", {**MCCL_RAIN, "eps_clip": 3.0}, ((1.0, 1.0), (0.0, 1.0)),
     "mccl_rain"),
)


def check_small_rain_steps() -> dict:
    """Phase 3, RAIN: ``pretrain_rain``'s step twice, ``rain``'s fresh then
    carried with the ascent, and two MCCL + RAIN iterations of one batch with
    ``eps_clip=3``, on the card against the CPU from the same weights (the
    RAIN net and DRUNet from ``run.seed``), batch, rMC draw and noise at
    64x64 in f32; each metric and the carried sampling at phase 3's
    tolerance. Returns each run's launch counts."""
    import torch
    from slcl_torch.data import to_device
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train.steps import build_step
    from slcl_torch.train.trainer import Trainer

    out = {}
    for label, method, rain, scheds, per in SMALL_RAIN_RUNS:
        cfg = small_config(method)
        cfg.data.crop, cfg.model.multilvl = 64, False
        cfg.optim.lr = 1e-4 if method == "pretrain_rain" else cfg.optim.lr
        for k, v in rain.items():
            setattr(cfg.rain, k, v)
        cpu = Trainer(cfg, device="cpu")
        gpu = Trainer(cfg, device="cuda")
        for t in (cpu, gpu):
            t.step_fn = build_step(cfg, t.centroids_loaded, draw_assign=shared_draw(5),
                                   draw_noise=shared_noise(9))
        batch = next(iter(cpu._epoch_batches()))
        base = cpu._sched(0)
        reset_launch_counts()
        for i, (fresh, eps_on) in enumerate(scheds):
            sched = {**base, "fresh": fresh, "eps_on": eps_on}
            m_cpu = cpu.step_fn(cpu.state, to_device(batch, torch.device("cpu")), sched)
            m_gpu = gpu.step_fn(gpu.state, to_device(batch, torch.device("cuda")), sched)
            if set(m_cpu) != set(m_gpu):
                raise AssertionError(f"small {label} step {i}: metric keys differ")
            for k, v in m_cpu.items():
                close(m_gpu[k].cpu(), v, 5e-3, 1e-4, f"small {label} step {i} {k}")
            if cpu.state.sampling is not None:
                close(gpu.state.sampling.cpu(), cpu.state.sampling, 5e-3, 1e-4,
                      f"small {label} step {i} sampling")
        counts = launch_counts()
        for name, n in PER_METHOD[per].items():
            if counts[name] != len(scheds) * n:
                raise AssertionError(f"small {label}: {name} launched {counts[name]} "
                                     f"times, expected {len(scheds) * n}")
        torch.cuda.synchronize()
        out[label] = {"steps": len(scheds), "crop": cfg.data.crop, "launches": counts,
                      "params": sum(p.numel() for p in gpu.state.seg.parameters()),
                      "metrics": {k: float(v) for k, v in m_gpu.items()}}
        log(f"small {label}: card matches CPU over {len(scheds)} step(s)")
    return out


def is_std_kernel(name: str) -> bool:
    """One of the std variant's kernels, by the profiler's name."""
    return any(all(p in name for p in parts) for parts in STD_KERNELS)


def iterations(batches, scheds, n: int):
    """``n`` (batch, sched) pairs as an epoch runs them: each batch once per
    sched of ``scheds`` in turn (RAIN's epsilon iterations), cycling."""
    for i in range(n):
        yield batches[(i // len(scheds)) % len(batches)], scheds[i % len(scheds)]


def profile_steps(trainer, batches, scheds, n: int = 3) -> dict:
    """Device time of ``n`` steps by kernel, from torch.profiler's CUDA
    events: busy share of the wall time, and the kernels that take most.
    ``scheds``: one sched per step of a batch in turn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch, sched in iterations(batches, scheds, n):
            trainer.step_fn(trainer.state, batch, sched)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    n_std = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_std += is_std_kernel(e.name)
    busy_us = sum(by_name.values())
    std_us = sum(v for k, v in by_name.items() if is_std_kernel(k))
    # first matching category wins; the rest is elementwise/copy/reduce
    cats = (("port_kernels", sum(PORT_KERNELS.values(), ())),
            ("convolution", ("xmma", "conv", "implicit_gemm", "cudnn", "gemm")),
            ("batch_norm", ("batch_norm",)),
            ("reduce", ("reduce_kernel",)),
            ("copy_cast", ("copy_kernel", "direct_copy")))
    by_cat: dict = {}
    for k, v in by_name.items():
        cat = next((c for c, keys in cats if any(p in k for p in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "idle_share": 1.0 - busy_us / wall_us,
            "port_kernels_share": (by_cat.get("port_kernels", 0.0) / busy_us
                                   if busy_us else None),
            "std_kernels_ms_per_step": std_us / n / 1e3,
            "std_kernels_share": std_us / busy_us if busy_us else None,
            "std_kernel_launches_per_step": n_std / n,
            "by_category_ms_per_step": {c: v / n / 1e3 for c, v in by_cat.items()},
            "top_kernels_ms_per_step": [[k[:90], v / n / 1e3] for k, v in top]}


# parameters of each step cell's full-width segmentor: DRUNet multilvl
# (slcl), phead without the aux head (mccl's preset); the backbones' equal
# the JAX models' (tests/test_torch_backbones.py computes them with
# jax.eval_shape)
N_PARAMS = {"slcl": 13_484_104, "mccl": 13_488_036, "mccl_rain": 13_488_036,
            "pretrain_rain": 12_784_271,
            "resnet50_slcl": 32_522_216, "resnet50_mccl": 32_526_276,
            "deeplabv2_advent": 42_942_560, "deeplabv2_adaptseg": 42_942_560,
            "unet_baseline": 31_037_828}
# phase 4's backbone cells: (name, method, backbone, timed steps); the paper's
# cell first (train_SLCL.py: resnet50, multilvl)
BACKBONE_CELLS = (("resnet50_slcl", "slcl", "resnet50", 20),
                  ("resnet50_mccl", "mccl", "resnet50", 10),
                  ("deeplabv2_advent", "advent", "deeplabv2", 5),
                  ("deeplabv2_adaptseg", "adaptseg", "deeplabv2", 5),
                  ("unet_baseline", "baseline", "unet", 10))


def train_full_width(work: Path, method: str = "slcl", stdmin: bool = False,
                     n_timed: int = 20, backbone: str = "drunet",
                     name: str = "", rain: dict = None) -> dict:
    """Phase 4: one full-width recipe through the port's Trainer: ``slcl``
    with multilvl (the main path), or the ``mccl`` preset, with ``stdmin``
    its std term (``contrastive.stdmin=true contrastive.w_stdmin=0.1``) or
    ``rain`` its RAIN overrides (``rain.eps_iters`` steps a batch, a fresh
    sampling on the first); on ``backbone``, with ``advent``/``adaptseg``
    (multilvl) and ``baseline`` too; or ``pretrain_rain`` (bs16 content +
    16 style). ``name`` keys N_PARAMS and PER_METHOD (default: the
    method). A step is one call of the step function: an epsilon iteration
    under RAIN."""
    import torch
    from slcl_torch.config import Config, apply_recipe
    from slcl_torch.data import device_prefetch
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train.trainer import Trainer

    cfg = Config()
    cfg.method = method
    cfg = apply_recipe(cfg)
    cfg.model.backbone = backbone
    cfg.model.multilvl = method in ("slcl", "advent", "adaptseg")
    if stdmin:
        cfg.contrastive.stdmin, cfg.contrastive.w_stdmin = True, 0.1
    for k, v in (rain or {}).items():
        setattr(cfg.rain, k, v)
    if method == "pretrain_rain":
        cfg.optim.lr = 1e-4
    cfg.data.dataset = "synthetic"
    cfg.optim.epochs = 1
    cfg.run.out_dir = str(work)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    n_params = sum(p.numel() for p in trainer.state.seg.parameters())
    if n_params != N_PARAMS[name or method]:
        raise AssertionError(f"{name or method}: {backbone} has {n_params} parameters")
    sched = trainer._sched(0)
    eps_iters = max(1, cfg.rain.eps_iters) if sched["eps_on"] else 1
    scheds = [sched] + [{**sched, "fresh": 0.0}] * (eps_iters - 1)
    steps_per_epoch = len(trainer.datasets["train_s"]) // cfg.data.bs * eps_iters

    reset_launch_counts()
    t1 = time.perf_counter()
    means = trainer.train_epoch(0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t1
    counts = launch_counts()
    per_method = name or (method + ("_stdmin" if stdmin else ""))
    for kname, per in PER_METHOD.get(per_method, PER_METHOD[method]).items():
        if counts[kname] != steps_per_epoch * per:
            raise AssertionError(f"train {per_method}: {kname} launched {counts[kname]} "
                                 f"times in {steps_per_epoch} steps, expected "
                                 f"{steps_per_epoch * per}")
    bad = {k: v for k, v in means.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"train {method}: non-finite losses {bad}")
    log(f"train {method} epoch: {steps_per_epoch} steps in {epoch_s:.2f} s, means {means}")

    batches = list(device_prefetch(trainer._epoch_batches(), trainer.device))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for batch, s in iterations(batches, scheds, n_timed):
        metrics = trainer.step_fn(trainer.state, batch, s)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t2) / n_timed * 1e3
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError("timed steps: non-finite losses")
    # each step alone, synchronised: its spread (no overlap with the next)
    each = []
    for batch, s in iterations(batches, scheds, n_timed):
        t3 = time.perf_counter()
        trainer.step_fn(trainer.state, batch, s)
        torch.cuda.synchronize()
        each.append((time.perf_counter() - t3) * 1e3)
    each.sort()
    prof = profile_steps(trainer, batches, scheds, n=max(3, eps_iters))
    return {"method": method, "backbone": backbone, "stdmin": stdmin, "rain": rain,
            "eps_iters": eps_iters, "step_ms": step_ms,
            "timed_steps": n_timed,
            "step_ms_synced_min_median_max": [each[0], each[n_timed // 2], each[-1]],
            "profile": prof,
            "src_img_per_s": cfg.data.bs / step_ms * 1e3,
            "epoch_s": epoch_s, "steps_per_epoch": steps_per_epoch,
            "setup_s": t1 - t0, "bs": cfg.data.bs, "crop": cfg.data.crop,
            "params": n_params, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            # the EMA class centres' norms after all the cell's steps (None
            # without centres): a collapse of the features shows here
            "centre_norms": (None if trainer.state.centroids is None else
                             trainer.state.centroids.norm(dim=1).tolist()),
            "launches": counts,
            "means": means}


def _same_state(a, b) -> None:
    """Raise unless two trainers hold bit-identical networks, centres, step."""
    import torch
    for net in ("seg", "d_main", "d_aux"):
        if getattr(a.state, net) is None:
            continue
        sa, sb = getattr(a.state, net).state_dict(), getattr(b.state, net).state_dict()
        bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
        if bad:
            raise AssertionError(f"restore: {net} differs in {bad[:4]}")
    if not torch.equal(a.state.centroids, b.state.centroids) or a.state.step != b.state.step:
        raise AssertionError("restore: centres or step differ")


def resumed_step_diff(args, method: str) -> float:
    """Save -> restore -> one more step against the uninterrupted step, from
    the run's last checkpoint (``args`` of the CLI run); returns the largest
    parameter difference."""
    import torch
    from slcl_torch.data import device_prefetch
    from slcl_torch.train import __main__ as train_cli
    from slcl_torch.train.trainer import Trainer

    cfg, _, _ = train_cli.parse_args(args, method)
    a = Trainer(cfg)
    a.restore_checkpoint("last")
    batches = [b for _, b in zip(range(2), device_prefetch(a._epoch_batches(), a.device))]
    sched = a._sched(1)
    a.step_fn(a.state, batches[0], sched)
    a.save_checkpoint("resume")
    b = Trainer(cfg)
    b.restore_checkpoint("resume")
    _same_state(a, b)
    ma = a.step_fn(a.state, batches[1], sched)
    mb = b.step_fn(b.state, batches[1], sched)
    for k in ma:
        close(mb[k], ma[k], 1e-5, 0.0, f"resumed {method} step {k}")
    # the backward's atomics (bilinear upsampling, cuDNN) sum in no fixed
    # order, so the two updates may differ in the last bits
    diff = max(float((pa - pb).abs().max()) for pa, pb in
               zip(a.state.seg.state_dict().values(), b.state.seg.state_dict().values()))
    if diff > 1e-6:
        raise AssertionError(f"resumed {method} step: parameters differ by {diff}")
    return diff


def protocol_full_width(work: Path) -> dict:
    """Phase 5: AdvEnt -> class centres -> slcl fine-tune -> final test,
    through the port's entry points at full width."""
    import numpy as np
    import torch
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.scripts import gen_class_centers
    from slcl_torch.train import __main__ as train_cli
    from slcl_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    base = ["data.dataset=synthetic", "data.gap=0.5", "optim.optimizer=adam",
            "model.multilvl=true", "run.eval_frequency=1", "optim.epochs=2",
            f"run.out_dir={work}"]
    adv = train_cli.main(["method=advent", *base, "optim.lr=2e-3", "adv.w_dis=2e-4"])
    best = Path(adv["out_dir"]) / "ckpt_best.pt"
    centres_path = work / "centers.npy"
    centres = gen_class_centers.main(["method=baseline", *base, f"run.restore_from={best}",
                                      f"out={centres_path}"])
    if centres.shape != (C, F) or not np.isfinite(centres).all() or not centres.any():
        raise AssertionError(f"protocol: bad centre file {centres.shape}")
    slcl_args = ["method=slcl", *base, "optim.lr=2e-4", "optim.lr_warmup_epochs=5",
                 "adv.w_dis=2e-4", f"run.init_from={best}",
                 f"contrastive.init_centers={centres_path}"]
    reset_launch_counts()
    fine = train_cli.main(slcl_args)
    counts = launch_counts()
    steps = 2 * 8   # two epochs of the synthetic train_s (8 * bs images)
    for name, per in PER_STEP.items():
        if counts[name] != steps * per:
            raise AssertionError(f"protocol: {name} launched {counts[name]} times in "
                                 f"{steps} steps, expected {steps * per}")
    init = fine["history"][0]
    if init["epoch"] != -1 or abs(init["val_dice"] - adv["best_val_dice"]) > 1e-3:
        raise AssertionError(f"protocol: epoch -1 val dice {init} is not AdvEnt's best "
                             f"{adv['best_val_dice']}")
    for split in ("test", "test_s"):
        vals = [v for k in ("dc", "hd", "asd") for v in fine[split][k]]
        if len(vals) != 18 or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"protocol: {split} metrics {fine[split]}")

    diff = resumed_step_diff(slcl_args, "slcl")

    # MCCL from the same AdvEnt checkpoint: the warm start keeps the fresh
    # phead (AdvEnt has none), its own centre file (features through that
    # phead), two epochs through the CLI
    mccl_base = [a for a in base if a != "model.multilvl=true"] + ["model.multilvl=false"]
    mcfg, _, _ = train_cli.parse_args(["method=mccl", *mccl_base], "mccl")
    fresh = Trainer(mcfg)
    phead0 = {k: v.clone() for k, v in fresh.state.seg.state_dict().items() if "phead" in k}
    fresh.restore_checkpoint(str(best), params_only=True)
    warm = fresh.state.seg.state_dict()
    saved = torch.load(best, map_location="cuda", weights_only=True)["seg"]
    if (len(phead0) != 4 or any(not torch.equal(warm[k], v) for k, v in phead0.items())
            or any(not torch.equal(warm[k], saved[k]) for k in warm if "phead" not in k)):
        raise AssertionError("protocol: the mccl warm start did not keep the fresh phead "
                             "and load the rest")
    del fresh, warm, saved
    mccl_centres_path = work / "centers_mccl.npy"
    mccl_centres = gen_class_centers.main(["method=mccl", *mccl_base,
                                           f"run.restore_from={best}",
                                           f"out={mccl_centres_path}"])
    if not (np.isfinite(mccl_centres).all() and mccl_centres.any()):
        raise AssertionError("protocol: bad mccl centre file")
    mccl_args = ["method=mccl", *mccl_base, "optim.lr=2e-4", f"run.init_from={best}",
                 f"contrastive.init_centers={mccl_centres_path}"]
    reset_launch_counts()
    mccl = train_cli.main(mccl_args)
    mccl_counts = launch_counts()
    for name, per in PER_STEP_MCCL.items():
        if mccl_counts[name] != steps * per:
            raise AssertionError(f"protocol mccl: {name} launched {mccl_counts[name]} times "
                                 f"in {steps} steps, expected {steps * per}")
    if [r["epoch"] for r in mccl["history"]] != [-1, 0, 1]:
        raise AssertionError(f"protocol mccl: epochs {mccl['history']}")
    init = mccl["history"][0]
    for split in ("test", "test_s"):
        vals = [v for k in ("dc", "hd", "asd") for v in mccl[split][k]]
        if len(vals) != 18 or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"protocol mccl: {split} metrics {mccl[split]}")
    mccl_diff = resumed_step_diff(mccl_args, "mccl")
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "mccl_val_dice": {r["epoch"]: r["val_dice"] for r in mccl["history"]},
            "mccl_init_val_dice": init["val_dice"], "mccl_best_epoch": mccl["best_epoch"],
            "mccl_test_dice_hd95_assd": [mccl["test"][k][0::2] for k in ("dc", "hd", "asd")],
            "mccl_centre_norms": np.linalg.norm(mccl_centres, axis=1).tolist(),
            "mccl_resume_max_param_diff": mccl_diff, "mccl_launches": mccl_counts,
            "advent_val_dice": [r["val_dice"] for r in adv["history"]],
            "slcl_val_dice": {r["epoch"]: r["val_dice"] for r in fine["history"]},
            "slcl_best_epoch": fine["best_epoch"],
            "test_dice_hd95_assd": [fine["test"][k][0::2] for k in ("dc", "hd", "asd")],
            "centre_norms": np.linalg.norm(centres, axis=1).tolist(),
            "resume_max_param_diff": diff, "launches": counts}


def protocol_rain(work: Path) -> dict:
    """Phase 5, RAIN: ``pretrain_rain`` one epoch through the CLI at full width
    (its four component files exported), then ``mccl`` with
    ``rain.enabled=true`` loading them: a warmup epoch, then one with the
    ascent (``rain.eps_iters=2``, ``rain.eps_clip=3``), launch counts set to
    0 just before and read just after, and the test; a configured component
    file that is missing must raise."""
    import numpy as np
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train import __main__ as train_cli
    from slcl_torch.train.trainer import RAIN_PARTS, Trainer

    t0 = time.perf_counter()
    base = ["data.dataset=synthetic", "data.gap=0.5", "run.eval_frequency=1",
            f"run.out_dir={work / 'rain'}"]
    pre = train_cli.main(["method=pretrain_rain", *base, "optim.epochs=1", "optim.lr=1e-4"])
    files = pre["component_ckpts"]
    if set(files) != {p for p, _ in RAIN_PARTS} or not all(
            Path(f).is_file() for f in files.values()):
        raise AssertionError(f"protocol rain: component files {files}")
    losses = {k: pre["history"][0][k] for k in ("loss_c", "loss_s", "loss_l", "loss_r")}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"protocol rain: pretraining losses {losses}")
    parts = [f"rain.{key}={files[p]}" for p, key in RAIN_PARTS]
    args = ["method=mccl", *base, "rain.enabled=true", "rain.update_eps=true",
            "rain.eps_iters=2", "rain.eps_clip=3", "contrastive.warmup_epochs=1",
            "optim.epochs=2", *parts]
    cfg, _, _ = train_cli.parse_args(args[:-1] + [f"rain.fc_decoder_ckpt={work}/absent.npz"],
                                     "mccl")
    try:
        Trainer(cfg)
        raise AssertionError("protocol rain: a missing component file did not raise")
    except FileNotFoundError:
        pass
    reset_launch_counts()
    run = train_cli.main(args)
    counts = launch_counts()
    steps = 8 + 8 * 2          # the warmup epoch, then two iterations a batch
    for name, per in PER_STEP_MCCL.items():
        if counts[name] != steps * per:
            raise AssertionError(f"protocol rain: {name} launched {counts[name]} times "
                                 f"in {steps} steps, expected {steps * per}")
    warmup, warm = run["history"]
    if warmup["eps_step_norm"] != 0.0 or not 0.0 < warm["eps_step_norm"] <= 3.0 + 1e-5:
        raise AssertionError(f"protocol rain: ascent norms {warmup['eps_step_norm']}, "
                             f"{warm['eps_step_norm']}")
    for split in ("test", "test_s"):
        vals = [v for k in ("dc", "hd", "asd") for v in run[split][k]]
        if len(vals) != 18 or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"protocol rain: {split} metrics {run[split]}")
    return {"seconds": time.perf_counter() - t0, "pretrain_losses": losses,
            "pretrain_epoch_s": pre["history"][0]["epoch_time_s"],
            "val_dice": [r["val_dice"] for r in run["history"]],
            "eps_step_norm": [r["eps_step_norm"] for r in run["history"]],
            "sampling_norm": [r["sampling_norm"] for r in run["history"]],
            "seg_style": [r["seg_style"] for r in run["history"]],
            "epoch_s": [r["epoch_time_s"] for r in run["history"]],
            "test_dice_hd95_assd": [run["test"][k][0::2] for k in ("dc", "hd", "asd")],
            "launches": counts,
            "component_bytes": {p: Path(f).stat().st_size for p, f in files.items()},
            "exported": {p: str(Path(f).name) for p, f in files.items()},
            "npz_layers": {p: len(np.load(f, allow_pickle=True)["params"].item())
                           for p, f in files.items()}}


# phase 6's trees: patients that the fold-0 / split-0 tables put where each
# split needs them (CT test ids carry the +32 offset), SLICES slices each,
# so each domain has 128 training slices (one 8-step epoch at bs16) and 64
# test slices
SLICES = 32
MMWHS_PATIENTS = {"CT": ([1, 2, 3, 4], [33, 36]), "MR": ([21, 22, 23, 24], [1, 4])}
MSCMRSEG_PATIENTS = {"train": [6, 7, 9, 11], "test": [23, 24]}


def _slices(rng, n: int, size: int, mr: bool):
    """n cardiac-like (size, size) slices and raw label maps {0, 205, 500,
    600}: blood pool, myocardial ring and right ventricle on a noisy
    background; MR inverts the contrast."""
    import numpy as np
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    s = size / 64
    cy = size / 2 + rng.uniform(-4 * s, 4 * s, (n, 1, 1))
    cx = size / 2 + rng.uniform(-4 * s, 4 * s, (n, 1, 1))
    r = np.hypot(yy - cy, xx - cx)
    lv, myo = r < 9 * s, (r >= 9 * s) & (r < 14 * s)
    rv = np.hypot(yy - cy + 3 * s, xx - cx - 17 * s) < 7 * s
    lab = np.zeros((n, size, size), np.int16)
    lab[myo], lab[lv], lab[rv] = 205, 500, 600
    img = rng.normal(200, 30, (n, size, size)) + 300 * myo + 700 * lv + 550 * rv
    if mr:
        img = 1400 - img + rng.normal(0, 40, (n, size, size))
    return img.astype(np.float32), lab


def write_trees(root: Path, seed: int = 0, slices: int = SLICES) -> dict:
    """Phase 6's data, in the real on-disk formats, with the port's own
    writers: an MMWHS raw tree (per-slice 256x256 int16 NIfTI stored
    (H, W, 1), labels beside the images with ground truth, per-patient 1/99
    percentile windows in ``{CT,MR}minmax99.csv``) and an MS-CMRSeg tree of
    224x224 8-bit PNGs (masks {0, 85, 212, 255}); ``slices`` a patient."""
    import csv

    import numpy as np
    from slcl_torch.data.nifti import write_nii
    from slcl_torch.data.png import write_png_gray

    rng = np.random.default_rng(seed)
    mmwhs, msc = root / "mmwhs_raw", root / "mscmrseg"
    for mod, (train, test) in MMWHS_PATIENTS.items():
        for sub in ("_woGT", "_withGT"):
            (mmwhs / f"{mod}{sub}").mkdir(parents=True)
        windows = []
        for p in train + test:
            img, lab = _slices(rng, slices, 256, mod == "MR")
            img = img.astype(np.int16)
            folder = mmwhs / f"{mod}{'_withGT' if p in test else '_woGT'}"
            for i in range(slices):
                write_nii(folder / f"img{p}_slice{i}.nii", img[i, :, :, None])
                write_nii(mmwhs / f"{mod}_withGT" / f"lab{p}_label_slice{i}.nii",
                          lab[i, :, :, None])
            windows.append([f"img{p}", repr(float(np.percentile(img, 1))),
                            repr(float(np.percentile(img, 99)))])
        with open(mmwhs / f"{mod}minmax99.csv", "w", newline="") as f:
            csv.writer(f).writerows([["", "min99", "max99"], *windows])
    for sub, tag, mr in (("A", "bSSFP", False), ("B", "lge", True)):
        for phase, pats in MSCMRSEG_PATIENTS.items():
            (msc / f"{phase}{sub}").mkdir(parents=True)
            (msc / f"{phase}{sub}mask").mkdir(parents=True)
            for p in pats:
                img, lab = _slices(rng, slices, 224, mr)
                img = np.clip(img / img.max() * 255.0, 0, 255).astype(np.uint8)
                mask = np.select([lab == 205, lab == 500, lab == 600], [85, 212, 255],
                                 0).astype(np.uint8)
                for i in range(slices):
                    name = f"pat_{p}_{tag}_{i}.png"
                    write_png_gray(msc / f"{phase}{sub}" / name, img[i])
                    write_png_gray(msc / f"{phase}{sub}mask" / name, mask[i])
    return {"mmwhs": mmwhs, "mscmrseg": msc}


def _loader_passes(loader) -> dict:
    """Two passes of one Loader over the same epoch with its threads, each
    timed alone (no step beside it), which must give identical batches;
    then one pass in the calling thread."""
    import numpy as np
    passes, times = [], []
    for _ in range(2):
        loader.epoch = 0
        t0 = time.perf_counter()
        passes.append(list(loader))
        times.append((time.perf_counter() - t0) * 1e3 / len(passes[-1]))
    for a, b in zip(*passes):
        for x, y in zip(a, b):
            same = np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
            if not same:
                raise AssertionError("two passes of one Loader over one epoch differ")
    threads, loader.num_threads = loader.num_threads, 1
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return {"ms_per_batch": times, "ms_per_batch_1_thread": (time.perf_counter() - t0) * 1e3 / n,
            "batches": len(passes[0]), "threads": threads}


def _host_figures(trainer, steps: int) -> dict:
    """Where a step's time goes with the data path in it, on a trainer
    whose first epoch has run: each domain's Loader alone, both Loaders
    zipped as an epoch runs them (no step), an epoch with the loader in the
    loop, 20 steps back to back on preloaded batches and 3 profiled."""
    import torch
    from slcl_torch.data import Loader, device_prefetch

    cfg, ds = trainer.cfg, trainer.datasets
    out = {"loader": {dom: _loader_passes(Loader(ds[dom], cfg.data.bs, seed=cfg.data.seed,
                                                 num_threads=cfg.data.num_workers))
                      for dom in ("train_s", "train_t")}}
    t0 = time.perf_counter()
    n = sum(1 for _ in trainer._epoch_batches())
    out["both_loaders_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    means = trainer.train_epoch(1)
    torch.cuda.synchronize()
    out["epoch_ms_per_step_with_loader"] = (time.perf_counter() - t1) * 1e3 / steps
    if not all(math.isfinite(v) for v in means.values()):
        raise AssertionError(f"non-finite losses {means}")
    batches = list(device_prefetch(trainer._epoch_batches(), trainer.device))
    sched = trainer._sched(1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for i in range(20):
        trainer.step_fn(trainer.state, batches[i % len(batches)], sched)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t2) / 20 * 1e3
    prof = profile_steps(trainer, batches, [sched])
    out["device_busy_ms_per_step"] = prof["device_busy_ms_per_step"]
    out["idle_share"] = prof["idle_share"]
    return out


def heavy2_on_host(root: Path) -> dict:
    """heavy2's host path on this machine: the C++ SLIC built with g++ from
    the checkout, superpixels on one slice against its contract (every
    segment replaced by its mean: inside the image's range, smoother), and
    an epoch of the MS-CMRSeg source Loader with ``aug_mode=heavy2``."""
    import numpy as np
    from slcl_torch.data import Loader, slic, transforms
    from slcl_torch.data.mscmrseg import MSCMRSegDataset
    from slcl_torch.data.png import read_png_gray

    t0 = time.perf_counter()
    slic.load()
    build_s = time.perf_counter() - t0
    img = read_png_gray(next((root / "trainA").glob("*.png"))).astype(np.float32) / 255.0
    out = transforms.superpixels(img, np.random.default_rng(0), n_segments=64, p_replace=1.0)
    if (out.shape != img.shape or out.min() < img.min() - 1e-6
            or out.max() > img.max() + 1e-6 or not out.std() < img.std()):
        raise AssertionError("superpixels broke its contract on the card's host")
    loader = Loader(MSCMRSegDataset(str(root), "bssfp", "s", augmentation=True,
                                    aug_mode="heavy2"), 16)
    t1 = time.perf_counter()
    n = sum(1 for _ in loader)
    return {"slic_build_s": build_s,
            "heavy2_loader_ms_per_batch": (time.perf_counter() - t1) * 1e3 / n}


def train_real(work: Path) -> dict:
    """Phase 6: the real-format data path at full width. ``slcl`` (multilvl,
    CNR) on the MMWHS raw tree and the ``mccl`` preset on the MS-CMRSeg tree,
    one epoch each through ``python -m slcl_torch.train``'s ``main`` with
    validation and the final test; each kernel's launches per step must be
    the synthetic cell's. Then ``_host_figures`` on a fresh trainer of each
    run after one epoch, and on the synthetic ``slcl`` cell's beside them."""
    import torch
    from slcl_torch.config import Config, apply_recipe
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train import __main__ as train_cli
    from slcl_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    trees = write_trees(work / "data")
    out = {"trees_s": time.perf_counter() - t0, **heavy2_on_host(trees["mscmrseg"])}
    runs = {"slcl_mmwhs_raw": ["method=slcl", "model.multilvl=true", "data.dataset=mmwhs",
                               "data.raw=true", f"data.data_dir={trees['mmwhs']}"],
            "mccl_mscmrseg": ["method=mccl", "data.dataset=mscmrseg",
                              f"data.data_dir={trees['mscmrseg']}"]}
    for name, args in runs.items():
        method = args[0].split("=")[1]
        args = [*args, "optim.epochs=1", "run.eval_frequency=1", f"run.out_dir={work}"]
        t1 = time.perf_counter()
        reset_launch_counts()
        rec = train_cli.main(args)
        counts = launch_counts()
        run_s = time.perf_counter() - t1
        cfg, _, _ = train_cli.parse_args(args, method)
        trainer = Trainer(cfg)
        ds = trainer.datasets
        steps = min(len(ds["train_s"]), len(ds["train_t"])) // cfg.data.bs
        if steps != 8 or {len(ds[k]) for k in ("valid_t", "test_t", "test_s")} != {64}:
            raise AssertionError(f"{name}: {steps} steps, test sets "
                                 f"{[len(ds[k]) for k in ('valid_t', 'test_t', 'test_s')]}")
        for kname, per in PER_METHOD[method].items():
            if counts[kname] != steps * per:
                raise AssertionError(f"{name}: {kname} launched {counts[kname]} times in "
                                     f"{steps} steps, expected {steps * per}")
        for split in ("test", "test_s"):
            vals = [v for k in ("dc", "hd", "asd") for v in rec[split][k]]
            if len(vals) != 18 or not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"{name}: {split} metrics {rec[split]}")
        trainer.train_epoch(0)
        out[name] = {"run_s": run_s, "steps_per_epoch": steps, "launches": counts,
                     "val_dice": rec["history"][0]["val_dice"],
                     "test_dice_hd95_assd": [rec["test"][k][0::2] for k in ("dc", "hd", "asd")],
                     "test_s_dice_hd95_assd": [rec["test_s"][k][0::2]
                                               for k in ("dc", "hd", "asd")],
                     **_host_figures(trainer, steps)}
        del trainer
        log(f"train_real {name}: {out[name]}")
    cfg = apply_recipe(Config(method="slcl"))
    cfg.model.multilvl, cfg.data.dataset = True, "synthetic"
    cfg.run.out_dir = str(work)
    trainer = Trainer(cfg)
    trainer.train_epoch(0)
    out["synthetic_slcl"] = _host_figures(trainer, len(trainer.datasets["train_s"]) // cfg.data.bs)
    del trainer
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: this script runs only on a card")
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from slcl_torch.ops.cuda import KERNELS, build, occupancy
        from slcl_torch.ops.cuda import (mpcl, mpcl_pseudo, pseudo_label,  # noqa: F401
                                         soft_centroids)
    except ImportError as e:
        log(f"slcl_torch not found next to this script ({e}): run from a checkout")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    log(f"{name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"built {len(build.SOURCES)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    # no instantiation (any F, bf16 or f32, P, std or not) of the kernels
    # that hold rows or sums in registers may spill, not only the main path's
    for src in ("mpcl", "mpcl_pseudo", "pseudo_label", "soft_centroids"):
        for fn, regs, spill in build.ptxas_report(src):
            if spill and ("fwd_partial" in fn or "pseudo_label_kernel" in fn
                          or src == "soft_centroids"):
                raise AssertionError(f"{fn} spills {spill} bytes at {regs} registers")
    # ... the std kernels among them, every F, type and P
    built = [fn for fn, _, _ in build.ptxas_report("soft_centroids")]
    for bwd in (0, 1):
        for P in (1, 2):
            for f in (8, 16, 32, 64):
                for ty in ("13__nv_bfloat16", "f"):
                    isym = centroid_symbol(bwd, 1, P, f, ty)
                    if not any(isym in fn for fn in built):
                        raise AssertionError(f"no ptxas report for {isym}")

    # the phases' own prints (the trainer's epoch lines and test tables) go
    # to stderr: stdout carries the result lines only
    with contextlib.redirect_stdout(sys.stderr):
        rows, read_only_ms = check_kernels(peaks)
        digest = centroid_digest()
        if digest != STD_FREE_DIGEST:
            raise AssertionError(f"the std-free centroid kernels' outputs changed: digest "
                                 f"{digest}, before the std variant {STD_FREE_DIGEST}")
        log("std-free centroid kernels: outputs bit-identical to commit 98d6b0e's")
        small = check_small_steps()
        small_rain = check_small_rain_steps()
        (ROOT / "runs").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "runs"))
        try:
            train = train_full_width(work)
            train_mccl = train_full_width(work, "mccl")
            # the std kernels' path, in a short cell
            train_std = train_full_width(work, "mccl", stdmin=True, n_timed=10)
            # RAIN: MCCL + RAIN with the ascent (10 batches = 20 steps), and
            # the style net's pretraining
            rain_cells = {"mccl_rain": train_full_width(work, "mccl", n_timed=20,
                                                        name="mccl_rain", rain=MCCL_RAIN),
                          "pretrain_rain": train_full_width(work, "pretrain_rain",
                                                            n_timed=10)}
            # the backbones, the paper's ResNet-50 U-Net first
            backbones = {name: train_full_width(work, method, n_timed=n, backbone=bb,
                                                name=name)
                         for name, method, bb, n in BACKBONE_CELLS}
            protocol = protocol_full_width(work)
            protocol["rain"] = protocol_rain(work)
            real = train_real(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    cells = {"train": train, "train_mccl": train_mccl, "train_mccl_stdmin": train_std}
    table = []
    for kname, rec in rows.items():
        k = KERNELS[kname]
        bound_ms, bound_by = rec["bound"]
        # (each cell has checked its counts against PER_METHOD)
        path = cells[PATH_OF.get(kname, "train")]
        entry = {"name": kname, "route": "cuda", "source": k.source,
                 "replaces": k.replaces, "launches": path["launches"][kname],
                 "launches_path": PATH_OF.get(kname, "train"),
                 "launches_per_step": train["launches"][kname] / train["steps_per_epoch"],
                 "mccl_launches_per_step": (train_mccl["launches"][kname]
                                            / train_mccl["steps_per_epoch"]),
                 "mccl_stdmin_launches_per_step": (train_std["launches"][kname]
                                                   / train_std["steps_per_epoch"]),
                 # per epsilon iteration (two a batch)
                 "mccl_rain_launches_per_step": (
                     rain_cells["mccl_rain"]["launches"][kname]
                     / rain_cells["mccl_rain"]["steps_per_epoch"]),
                 "launches_protocol_rain": protocol["rain"]["launches"][kname],
                 "launches_small_rain": small_rain["mccl rain"]["launches"][kname],
                 "launches_protocol": protocol["launches"][kname],
                 "launches_protocol_mccl": protocol["mccl_launches"][kname],
                 "launches_real": {run: real[run]["launches"][kname]
                                   for run in ("slcl_mmwhs_raw", "mccl_mscmrseg")},
                 "launches_backbones": {cell: backbones[cell]["launches"][kname]
                                        for cell in backbones},
                 # phase 3's two UNet steps at F = 64 (the 64-wide instantiations)
                 "launches_small_f64": small["unet slcl F=64"]["launches"][kname],
                 "max_abs_err": rec["max_abs_err"],
                 "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": rec["library_ms"]}
        for extra in ("near_tie_rows", "fused_route_ms", "two_op_route_ms", "partial_ms",
                      "final_ms", "p2_ms", "kernel_ms", "sel_ms", "sel_plain_ms",
                      "sel_bound_ms", "sel_partial_ms", "sel_final_ms", "sel_max_abs_err",
                      "mccl", "p1_ms", "p1_plain_ms", "p1_bound", "p1_partial_ms",
                      "p1_final_ms", "library_f32_ms", "p1_library_ms",
                      "p1_library_f32_ms", "copy_ms"):
            if extra in rec:
                entry[extra] = rec[extra]
        src, sym = SYMBOLS[kname]
        ((regs, spill),) = [(r, sp) for fn, r, sp in build.ptxas_report(src) if sym in fn]
        query, args = OCCUPANCY[kname]
        lib = build.load(src, importlib.import_module(f"slcl_torch.ops.cuda.{src}")._SIGS)
        blocks, smem = occupancy(getattr(lib, query), *args)
        entry.update(registers=regs, spill_store_bytes=spill, blocks_per_sm=blocks,
                     smem_bytes=smem)
        if kname in ("soft_centroids_fwd", "soft_centroids_bwd"):
            # P = 1 and 2, with and without the std: registers / spill bytes /
            # blocks per SM / shared memory bytes
            inst = {}
            for P in (1, 2):
                for std in (0, 1):
                    isym = centroid_symbol(kname.endswith("bwd"), std, P)
                    ((r, sp),) = [(r, sp) for fn, r, sp in build.ptxas_report(src)
                                  if isym in fn]
                    bl, sm = occupancy(getattr(lib, query), *args[:3], P, std)
                    inst[f"p{P}" + ("_std" if std else "")] = [r, sp, bl, sm]
            entry["instantiations"] = inst
        if entry["spill_store_bytes"]:
            raise AssertionError(f"{kname} spills registers: {entry}")
        table.append(entry)
    if {e["name"] for e in table} != set(PER_STEP):
        raise AssertionError("kernel table incomplete")
    print(json.dumps({"kernels": table, "read_only_ms": read_only_ms,
                      "std_free_digest": digest}))
    print(json.dumps({"train": train}))
    print(json.dumps({"train_mccl": train_mccl}))
    print(json.dumps({"train_mccl_stdmin": train_std}))
    print(json.dumps({"train_rain": {"cells": rain_cells, "small_steps": small_rain}}))
    print(json.dumps({"protocol": protocol}))
    print(json.dumps({"train_real": real}))
    print(json.dumps({"train_backbones": {"cells": backbones, "small_steps": small}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
