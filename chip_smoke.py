#!/usr/bin/env python3
"""On-card smoke test of the ``slcl_torch`` port (one CUDA card).

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --spatial-cell NAME`` builds the kernels and runs
phase 9(c)'s cell NAME alone.)

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
     variant existed (``STD_FREE_DIGEST``). Then the general family (any
     C, P, F: ``csrc/general.cuh``, ``csrc/centroids_gen.cuh``): each of
     its nine kernels against its plain version at every ``GEN_SHAPES``
     (C in {2, 5, 8}, P in {1, 3, 4}, F in {20, 24, 48, 128}; hard and soft,
     std and not), bf16 and f32, a ragged M, launched twice for
     bit-identity, through the wrappers' choice of family by shape (no
     templated kernel may launch there); forced at the main shape against
     the templated family (labels and masks equal, values within the
     tolerances); two halves' partials summed through ``reduce`` against
     the whole batch's; and each timed at its phase 4 cell's shape and
     forced at the main shape beside the templated kernel;
  3. small steps: two ``slcl`` multilvl+CNR steps, two ``advent`` multilvl
     steps, two ``baseline`` steps and two ``mccl`` steps in each forward
     mode (stdmin and seg_pseudo on; one shared rMC draw) on DRUNet; two
     ``slcl`` multilvl and two ``mccl`` steps on a shallow ResNet-50 U-Net
     (one block a stage, base 8) at 64x64, two ``advent`` and two
     ``adaptseg`` multilvl steps on a shallow DeepLabV2 (the heads' 10x
     group included), one ``baseline`` step on UNet at base 8 and two
     ``slcl`` steps on the full UNet with ``model.filters=64`` (the F = 64
     kernels on a step), and the two ``GEN_CELLS`` configs (the general
     kernels on a step): on the card (kernels) against the same steps on
     the CPU (plain versions), from the same weights and batches, in f32,
     with each run's launch counts; then RAIN at 64x64, the same way and
     with one shared noise: two ``pretrain_rain`` steps, a ``rain`` step
     fresh then carried with the epsilon ascent, and two MCCL + RAIN
     iterations of one batch with ``rain.eps_clip=3`` through the centroid
     kernels, the carried sampling held beside the metrics; then two steps
     each of ``ddfseg`` (a slim DDFNet, ``ddfseg.filters=4 style_filters=4
     ngf=8``), ``adaptevery`` (ResNetUNetPoint with one block a stage at
     base 8, a base-8 PointNet) and ``bcl`` (BCLDeepLab likewise, the CPU's
     pseudo-label round given to both) at 64x64 with one shared dropout
     draw (``shared_dropout``), no port kernel launched;
  4. train: the full-width ``method=slcl model.multilvl=true
     data.dataset=synthetic`` recipe at bs16 224x224 through the port's
     ``Trainer`` for one epoch (launch counts set to 0 just before and read
     just after: each kernel must have run its per-step count every step,
     and every loss must be finite), then twenty timed steps (and half as
     many each synchronised alone, for their spread), then three
     steps traced with torch.profiler for the device's busy time and the
     kernels that take most of it; then the same for the ``mccl`` preset
     (phead, P = 2, soft weights; 16 source + 16 + 16 target images); then
     a short cell of the preset with ``contrastive.stdmin=true
     contrastive.w_stdmin=0.1`` (this slice's path: img_t's centroids take
     the std kernels), one epoch and ten timed steps, with the std kernels'
     launches per step and their share of the device time; then
     ``GEN_CELLS``, the general kernels' paths: ``slcl_c5_f24``
     (``model.num_classes=5 model.filters=24``, multilvl) and
     ``mccl_p4_c5_f48_std`` (the preset with ``contrastive.part=4
     model.num_classes=5 model.filters=48 contrastive.stdmin=true
     contrastive.w_stdmin=0.1``), each an epoch, ten timed and three
     profiled steps like the cells above, then an epoch through ``python -m
     slcl_torch.train``'s ``main`` with validation and the test; then the
     backbones at full width, each one epoch with its launch counts and
     parameter count, timed steps and three profiled: ``slcl`` multilvl on
     the ResNet-50 U-Net (the paper's train_SLCL.py cell; 20 timed steps),
     the ``mccl`` preset on it, ``advent`` and ``adaptseg`` multilvl on the
     full DeepLabV2 (no kernel; 5 timed steps) and ``baseline`` on UNet;
     then RAIN (``train_rain``): the ``mccl`` preset with ``rain.enabled
     rain.update_eps rain.eps_iters=2 rain.eps_clip=3`` (``bench.py:148-160``'s
     JAX cell, random RAIN weights from seed 1234: one epoch, 10 batches = 20
     timed steps, a step being one epsilon iteration) and ``pretrain_rain``
     (bs16 content + 16 style, 10 timed steps); then DDFSeg, AdaptEvery
     and BCL at full width on their recipes' networks (``train_extra``):
     ``ddfseg`` (DDFNet 16/8/32 + SegDecoder, three PatchGANs, Adam 2e-4),
     ``adaptevery`` (the ResNet-50 U-Net multilvl with the 300-vertex head,
     three entropy-map discriminators, a PointNet at base 64) and ``bcl``
     (BCLDeepLab on ResNet-101, its epoch after a pseudo-label round), one
     epoch each with the parameter count (``N_PARAMS``) and no port kernel
     launched, 10 timed steps and 3 profiled;
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
     must raise; then through the CLI ``bcl`` for two epochs with
     ``run.bcl_round_epochs=1`` (two pseudo-label rounds), ``ddfseg`` and
     ``adaptevery`` one epoch each, each with its final test, and DDFSeg's
     last checkpoint restored and continued as the uninterrupted run
     (every network and optimizer bit for bit, the next step's metrics);
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
     contract, a heavy2 Loader epoch timed;
  7. serve: phase 5's best ``slcl`` checkpoint exported through ``python
     -m slcl_torch.scripts.export ... smoke=1`` (bf16, on the card; started
     as soon as phase 5 has trained it, beside the rest of phase 5) and
     again with probabilities, and a full-width ResNet-50 U-Net from random
     init with probabilities; a process without slcl_torch on its path
     loads each artifact with ``torch.export.load`` and runs batch sizes
     1, 5 and 16 of the synthetic test images: labels equal the live
     evaluator's at >= 99.9% of pixels, probabilities within 2e-3; the
     batch server (``python -m slcl_torch.serve``) on 57 of phase 6's
     MS-CMRSeg PNGs at bs=16 (a ragged last batch); ``python -m
     slcl_torch.scripts.predict`` on the same checkpoint, its Dice / HD95 /
     ASSD within 1e-6 of ``Trainer.eval("test_t")`` (the consumer, the
     server and predict run at once); images per second at
     bs 1 and 16 through the artifact and the live model in turns, the
     export times and the artifacts' sizes;
  8. run utilities: ``model.remat`` off, ``full`` and ``dots`` on the
     full-width ``slcl`` multilvl cell, on ``resnet50_slcl`` and on
     ``mccl_rain`` (the MCCL preset with RAIN's epsilon ascent, whose
     backward through the checkpointed forward precedes the update's: two
     iterations, a fresh sampling then the carried one), two steps each
     from the same init and batches under deterministic algorithms (with
     cuDNN's default choice ``mccl_rain``'s ``full`` and ``dots`` part from
     the run without remat at the sampling by 60-70 times that tolerance,
     ``tools/rain_card_spread.py remat``): parameters, BatchNorm buffers,
     centres, the sampling and metrics against the run without remat (rtol
     1e-3 / atol 1e-5 on DRUNet, rtol 1e-2 on the ResNet, whose centre
     norms run away), the kernel launches of each step unchanged; then ten
     timed steps with the default algorithms and their peak memory, each
     mode; a two-epoch ``slcl`` run with
     ``run.profile_dir`` whose Chrome trace must parse and name the kernels
     of mpcl.cu, mpcl_pseudo.cu and soft_centroids.cu among its device
     events; the offline tools' CLI (``python -m slcl_torch.data.preprocess
     minmax-csv`` / ``nii-to-png-mmwhs``) on ``tests/fixtures/mini_mmwhs``
     and one augmented batch each of the legacy bSSFP / LGE datasets on
     ``tests/fixtures/mini_mscmrseg``, with no cv2, pandas or PIL imported.
  9. parallel (``slcl_torch/parallel``): the forwards' two-call entries
     (streaming pass, a caller's reduction of the partials, final pass),
     which the wrappers take, of the soft centroids (P = 1, P = 2, the std
     variant), the MPCL forward (sel and none) and the fused target loss at
     the main shape: equal to the one-call entry bit for bit, and with the
     rows in two halves, the first half's partials added to the second's,
     equal to the one-call entry on all rows (phase 2's tolerances); (a) NCCL at
     one rank, through the Trainer under a ``(1, 1)`` mesh: two steps of
     the full-width ``slcl`` multilvl cell and of the ``mccl`` preset (and
     ``slcl`` with ``mesh.fsdp=true``, which at one model rank shards
     nothing, as in JAX) against the plain Trainer's two steps from the
     same init and batches, bit for bit (metrics, every network's state,
     centres), the kernels' launches per step unchanged, then ten steps
     of each timed, plain, mesh, mesh, plain; (b) (its ranks run beside
     phase 5, which times nothing but its own wall time) two gloo ranks
     sharing the card, in two processes:
     ``slcl`` and ``mccl`` at full width in f32, global bs16 (8 rows a
     rank), two steps against one process's two steps on the same 16 rows
     (segmentor parameters, BatchNorm buffers and centres rtol 1e-4 /
     atol 1e-6, metrics rel 1e-5; the discriminators' parameters, Adam's,
     within 2 * lr_dis a step and each network's change from the init
     within a cosine of 0.9 of one process's), each rank's launches per step the
     one-process step's; and the first ``d_main`` update (the BCE's global
     means, ``net_update``'s share, ``reduce_grads`` over gloo) redone in
     float64 on the card from the one process's recorded inputs, each
     rank on its rows: the summed gradients elementwise rtol 1e-4 with an
     atol of 1e-5 of the tensor's largest entry and within 1e-4 in norm
     (in float32 the source and target terms' gradients nearly cancel, so
     the main path's float32 gradients are reported, not held, beside the
     cancellation factor); (c) spatial partitioning (``mesh.spatial``,
     ``slcl_torch/parallel/spatial.py``): two gloo ranks sharing the card as
     a ``(1, 2)`` mesh, each image's 224 rows split into two bands of 112
     (halo-exchanging convolutions, the discriminators' uneven stages
     resharded, the losses, BatchNorm and the kernels' partials reduced
     over both ranks): the same two steps of the same two cells against
     the same one-process steps at (b)'s tolerances, the float64
     ``d_main`` update redone on each rank's band, each rank's launches
     per step the one-process step's, and the second step timed on each
     rank (ms, printed, not held) beside the one process's. (b) also
     runs ``mccl_rain_mulstyle`` at phase 3's sizes (MCCL + RAIN with a
     sampling row per image: each data rank stylises its images with its
     rows of it; two epsilon iterations, a fresh sampling then the carried
     one). (c) runs ``slcl`` at full width, then on the same (1, 2) mesh
     the published backbones, RAIN and ``model.remat``
     (``SMOKE_SPATIAL``): ``resnet50_slcl`` at full width (the paper's
     ResNet-50 U-Net, multilvl + CNR, bs16 + 16 at 224², f32; stages of
     112, 56, 28, 14 and 7 rows split over the ranks, the 7-row bottleneck
     4 + 3), ``mccl_rain`` at full width (DRUNet, the MCCL preset with the
     ascent, bs16 + 16 + 16 at 224², f32; the style net's reflect-padded
     convolutions on the bands, its AdaIN moments summed over the ranks;
     two epsilon iterations), then at phase 3's sizes DRUNet's plain
     ``mccl`` (``drunet_mccl``), ``unet_baseline`` and ``deeplabv2_advent``
     (the shallow nets), DRUNet ``slcl`` with ``model.remat=full`` and
     ``rain_seg`` (``method=rain``), then ``ddfseg`` at full width (DDFNet
     16/8/32, SegDecoder and three PatchGANs, bs 4 + 4 at 224², f32; its
     transposed convolutions, instance norms and attention on the bands,
     dropout masks cut from the global ones) and, at phase 3's 64x64,
     ``adaptevery_small`` (ResNetUNetPoint and its vertex branch) and
     ``bcl_small`` (BCLDeepLab on four images, after a pseudo-label round
     run on whole images on every rank, which must equal one process's):
     each
     against one process, the state
     (the sampling among it) after the first step and after the second,
     the metrics of both, each rank's launches a step the one process's,
     the second step of each rank timed; for ``resnet50_slcl`` and
     ``mccl_rain`` also the one process on the same images in reverse
     order (with RAIN image 0 kept first, the stylised pair; MCCL's rMC
     draw moved with the images) against the one process
     (``floor_tol_ratio``: how far another order of the same sums takes
     the second step), and for ``mccl_rain`` on its images one float32
     ulp up (``ulp_floor_tol_ratio``); ``mccl_rain``, ``ddfseg`` and the
     small AdaptEvery and BCL cells are held at each step to the larger of
     the two (``FLOOR_HELD``; ``ddfseg``'s second step to twice that,
     ``FLOOR_FACTOR``), and so is each network's first-step gradient (its
     error norm over 1e-4 of its norm); DDFSeg's generator, whose first
     Adam step moves every entry whose gradient is rounding noise by a full
     lr, is held by that gradient and its move, not entry by entry
     (``ADAM_SEG``); each network's move must be as close to one process's
     as each sound run's less ``NET_MOVE_MARGIN``. For those, the
     reversed-images run keeps each image's dropout masks with it, and
     BCL's keeps image 0 first (its metric loss reads it). RAIN's second iteration
     starts on every side from the one process's sampling after the
     first, and the new sampling, the ascent's step norm and the
     pixel-count diagnostics are held at phase 3's RAIN tolerance
     (``RAIN_TOL``). The cells of (b), and those of (c), run in turn in
     one pair of ranks.
 10. scan_steps (``run.scan_steps``, ``slcl_torch/train/multistep.py``): the
     full-width ``slcl`` multilvl + CNR cell and the ``mccl`` preset, 2K + 1
     steps each at K = 4 (steps 0-2 eager, step 3 captured as a CUDA graph
     and replayed, 4-7 replayed, step 8 the plain tail) through the
     Trainer's captured runner, against the same runner uncaptured on the
     card (parameters, BatchNorm buffers, optimizer state, centres and
     every metric bit for bit) and against the Trainer at
     ``scan_steps=1`` (JAX's scan test's tolerances: the state rtol 2e-5 /
     atol 1e-6, the metrics rel 1e-4, since the capturable optimizers
     round differently); these comparisons run with cuDNN's deterministic
     algorithms (with its default choice two uncaptured runs already
     differ); each kernel's counted launches (the eager steps, the capture,
     the tail) and its device events a replayed step equal to an eager
     step's. Then, with the default algorithms and a graph captured anew:
     20 steps back to back of the plain and the replayed step, eager /
     graph / graph / eager, four of each under torch.profiler (device busy
     ms, idle share), the capture's time and memory. Then every method at
     phase 3's sizes (``SCAN_SMALL``: ``baseline``, ``adaptseg`` on the
     shallow DeepLabV2, ``advent``, ``mpscl``, ``slcl``, ``mccl`` with
     stdmin and on the shallow ResNet-50 U-Net, MCCL + RAIN before warm-up
     and with the ascent, ``rain``, ``pretrain_rain``, ``ddfseg``,
     ``adaptevery``, ``bcl``, and GEN_CELLS' ``mccl`` at P = 4, C = 5, F =
     48 on the general kernels): 2K steps captured against uncaptured, bit
     for bit; the general-kernel run also against ``scan_steps=1`` at the
     tolerances above (``SCAN_VS_PLAIN``).

Prints the kernel table (with registers, spills, blocks per SM and shared
memory per block of each kernel; the centroids' per instantiation; each
kernel's launches from its own path: the ``slcl`` cell, or the stdmin cell
for the std kernels) as one JSON line, the three step cells' timing, the
protocol, the RAIN cells (``train_rain``: phase 4's two and phase 3's RAIN
runs), the real-format phase, the backbones (``train_backbones``:
phase 4's backbone cells and phase 3's runs) and DDFSeg / AdaptEvery / BCL
(``train_extra``: phase 4's cells, phase 3's steps, phase 5's runs),
``serve`` (phase 7), ``run_utils`` (phase 8), ``parallel`` (phase 9) and
``scan_steps`` (phase 10) as one JSON line each, the
card's name and power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and cuDNN. Run
directories go to ``runs/`` in the checkout and are removed.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import gc
import importlib
import json
import math
import os
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
# the general family (any C, P, F) runs no launch at the published shapes
GENERAL = tuple(k + "_general" for k in PER_STEP)
PER_STEP.update(dict.fromkeys(GENERAL, 0))
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
# DDFSeg, AdaptEvery and BCL: no port kernel on their paths
EXTRA_METHODS = ("ddfseg", "adaptevery", "bcl")
PER_METHOD.update({m: dict.fromkeys(PER_STEP, 0) for m in EXTRA_METHODS})
# the cells on the general kernels (GEN_CELLS): slcl at C = 5, F = 24 takes
# the general family where slcl takes the templated one; mccl at P = 4, C =
# 5, F = 48 with stdmin its std pair on img_t and std-free pair on img_t_aug
PER_METHOD["slcl_c5_f24"] = {**dict.fromkeys(PER_STEP, 0),
                             **{k + "_general": v for k, v in PER_STEP.items()
                                if not k.endswith("_general")}}
PER_METHOD["mccl_p4_c5_f48_std"] = {**dict.fromkeys(PER_STEP, 0),
                                    **{k + "_general": v
                                       for k, v in PER_STEP_MCCL_STD.items()
                                       if not k.endswith("_general")}}
# the full-width MCCL + RAIN cell's overrides (bench.py:148-160's JAX cell)
MCCL_RAIN = {"enabled": True, "update_eps": True, "eps_iters": 2, "eps_clip": 3.0}
# the step cell whose launch counts each kernel's row reports (its path)
PATH_OF = {"soft_centroids_fwd_std": "train_mccl_stdmin",
           "soft_centroids_bwd_std": "train_mccl_stdmin",
           **{k: "train_slcl_c5_f24" for k in GENERAL},
           "soft_centroids_fwd_std_general": "train_mccl_p4_c5_f48_std",
           "soft_centroids_bwd_std_general": "train_mccl_p4_c5_f48_std"}
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
                                      "centroids_bwd_stdI13__nv_bfloat16Li32ELi2ELi4EE"),
           # the general family: one instantiation a type (and std or not)
           "mpcl_fwd_general": ("mpcl", "mpcl_gen_fwd_partialI13__nv_bfloat16E"),
           "mpcl_bwd_general": ("mpcl", "mpcl_gen_bwdI13__nv_bfloat16E"),
           "mpcl_pseudo_fwd_general": ("mpcl_pseudo",
                                       "mpcl_pseudo_gen_fwd_partialI13__nv_bfloat16E"),
           "mpcl_pseudo_bwd_general": ("mpcl_pseudo", "mpcl_pseudo_gen_bwdI13__nv_bfloat16E"),
           "pseudo_label_general": ("pseudo_label", "pseudo_label_genI13__nv_bfloat16E"),
           # (the forwards at the cells' shapes: the narrow form, kForm = 2,
           # std-free; the ring form, kForm = 0, with the std)
           "soft_centroids_fwd_general": ("soft_centroids",
                                          "centroids_gen_fwd_partialI13__nv_bfloat16Lb0ELi2EE"),
           # (the backward: its form at the cell's shape, V = 8 features a
           # chunk with the chunk's coefficients in registers)
           "soft_centroids_bwd_general": ("soft_centroids",
                                          "centroids_gen_bwdI13__nv_bfloat16Lb0ELi8ELi1EE"),
           "soft_centroids_fwd_std_general": (
               "soft_centroids", "centroids_gen_fwd_partialI13__nv_bfloat16Lb1ELi0EE"),
           "soft_centroids_bwd_std_general": ("soft_centroids",
                                              "centroids_gen_bwdI13__nv_bfloat16Lb1ELi8ELi1EE")}
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
             "soft_centroids_bwd_std": ("soft_centroids_occupancy", (1, 1, F, 2, 1)),
             # the general family at its cells' shapes (GEN_CELLS): bf16, C = 5,
             # F = 24 (slcl), F = 48 and P = 4 (mccl's std pair)
             "mpcl_fwd_general": ("mpcl_gen_occupancy", (0, 1, 24, 5)),
             "mpcl_bwd_general": ("mpcl_gen_occupancy", (1, 1, 24, 5)),
             "mpcl_pseudo_fwd_general": ("mpcl_pseudo_gen_occupancy", (0, 1, 24, 5)),
             "mpcl_pseudo_bwd_general": ("mpcl_pseudo_gen_occupancy", (1, 1, 24, 5)),
             "pseudo_label_general": ("pseudo_label_gen_occupancy", (1, 24, 5)),
             # (the centroid queries' last argument: with dprobs, which sets
             # the backward's form; the slcl cell's hard call takes none)
             "soft_centroids_fwd_general": ("soft_centroids_gen_occupancy",
                                            (0, 1, 24, 5, 1, 0, 0)),
             "soft_centroids_bwd_general": ("soft_centroids_gen_occupancy",
                                            (1, 1, 24, 5, 1, 0, 0)),
             "soft_centroids_fwd_std_general": ("soft_centroids_gen_occupancy",
                                                (0, 1, 48, 5, 4, 1, 0)),
             "soft_centroids_bwd_std_general": ("soft_centroids_gen_occupancy",
                                                (1, 1, 48, 5, 4, 1, 1))}
# parts of a CUDA kernel's name by which the profiler counts it as the
# port's, per source ("name<" for one kernel, a prefix for a family)
PORT_KERNELS = {"mpcl": ("mpcl_fwd_", "mpcl_bwd<", "mpcl_gen_"), "mpcl_pseudo": ("mpcl_pseudo_",),
                "pseudo_label": ("pseudo_label_kernel", "pseudo_label_gen"),
                "soft_centroids": ("centroids_fwd_partial<", "centroids_fwd_std_partial<",
                                   "centroids_fwd_final<", "centroids_bwd<",
                                   "centroids_bwd_std<", "centroids_gen_")}
# the std kernels of one stdmin step, as the profiler names them (every part
# of one entry): both streaming kernels and the std instantiation's final pass
STD_KERNELS = (("centroids_fwd_std_partial<",), ("centroids_bwd_std<",),
               ("centroids_fwd_final<", ", true>"),
               # the general family's: its streaming kernels and final pass
               ("centroids_gen_", ", true"), ("centroids_gen_fwd_final<true>",))


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


def centroids_f64(feats, probs, assign, P: int, thd: float, weighted: bool, std: bool) -> dict:
    """The centroids (P, C, F) and, with ``std``, the stddevs (C,) of
    ``soft_centroids_plain``'s function in float64 on the same inputs: the
    sums the kernels' errors are taken against (``err_f64``)."""
    import torch
    import torch.nn.functional as Fn
    x, pr = feats.double(), probs.double()
    m, c = pr.shape
    cert = ((pr.max(1).values >= thd).double() if 0.0 < thd < 1.0
            else torch.ones(m, dtype=torch.float64, device=pr.device))
    w = (pr if weighted else Fn.one_hot(pr.argmax(1), c).double()) * cert[:, None]
    a = (assign.long() if P > 1 and assign is not None
         else torch.zeros(m, dtype=torch.long, device=pr.device))
    ok = (a >= 0) & (a < P)
    part = Fn.one_hot(torch.where(ok, a, 0), P).double() * ok[:, None].double()
    wpc = (w[:, None, :] * part[:, :, None]).reshape(m, P * c)
    cents = (wpc.T @ x).reshape(P, c, -1) / (wpc.sum(0).reshape(P, c, 1) + 1e-7)
    out = {"cents": cents}
    if std:
        wt = w * ok[:, None].double()
        var = torch.clamp((wt.T @ (x * x)) / (wt.sum(0)[:, None] + 1e-7) - cents[0] ** 2, min=0)
        out["std"] = torch.sqrt(var.mean(-1) + 1e-7)
    return out


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


def check_kernels(peaks) -> tuple:
    """Phase 2: every kernel against its plain version; returns the table's
    rows, a torch.sum's ms over the features and the general family's
    comparisons with the templated one."""
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
    # the general family: its own stream of inputs, so that the checks above
    # see the inputs they always had
    t0 = time.perf_counter()
    g_gen = torch.Generator(device=dev).manual_seed(11)
    errs = check_general_shapes(g_gen)
    forced = check_general_forced(g_gen)
    rows.update(general_rows(errs, forced, peaks, g_gen))
    general = {"forced": forced, "seconds": time.perf_counter() - t0}
    torch.cuda.synchronize()
    return rows, read_only_ms, general


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


# ---------------------------------------------------------------------------
# phase 2, the general family (any C, P, F: csrc/general.cuh,
# csrc/centroids_gen.cuh)
# ---------------------------------------------------------------------------
# the shapes (C, P, F) each general kernel is held to its plain version at,
# in bf16 and f32 at a ragged M: every C in {2, 5, 8}, P in {1, 3, 4} and F
# in {20, 24, 48, 128} (rows of 40, 48, 96 and 256 bf16 bytes); an odd F
# (13: bf16 rows of 26 bytes, one feature a thread-chunk in the centroid
# backward); and a shape whose centroid backward with the std and dprobs
# takes the direct form (P*C = 64 at F = 656: no two ring stages fit beside
# its coefficients; gen_bwd_plan)
GEN_SHAPES = ((2, 1, 20), (5, 3, 24), (8, 4, 48), (5, 4, 128), (3, 2, 13), (8, 8, 656))
GEN_M = 65_536 - 5
# phase 4's cells on the general kernels: name -> (method, overrides by
# section, timed steps); phase 3 runs each at its sizes
GEN_CELLS = {
    "slcl_c5_f24": ("slcl", {"model": dict(multilvl=True, num_classes=5, filters=24)}, 10),
    "mccl_p4_c5_f48_std": ("mccl", {"model": dict(num_classes=5, filters=48),
                                    "contrastive": dict(part=4, stdmin=True, w_stdmin=0.1)},
                           10)}


def general_counts_moved(before: dict, what: str) -> None:
    """Raise if a templated kernel launched since ``before`` (launch_counts)
    or no general one did: the shape's calls took the general family."""
    from slcl_torch.ops.cuda import launch_counts
    now = launch_counts()
    moved = {k for k in now if now[k] != before[k]}
    if not moved or any(not k.endswith("_general") for k in moved):
        raise AssertionError(f"{what}: launches moved on {sorted(moved)}")


def check_general_shapes(g) -> dict:
    """Phase 2: every general kernel against its plain version at each of
    GEN_SHAPES in bf16 and f32 at a ragged M, through the wrappers' choice
    of family by shape (no templated kernel may launch), each launched twice
    for bit-identity, at the main shape's tolerances: MPCL forward (sel and
    none, labels out of range) and backward, the fused target branch
    (near-tie slack, the backward away from near-tie rows), the pseudo-labels
    (exact away from near ties), the soft centroids at P = 1 and the shape's
    P, hard and soft, thd 0 and 0.4, ids out of range, and their std variant
    at the shape's P; the centroid backward in both its forms (the ring and,
    at one shape, the direct form; gen_bwd_plan). Returns the max abs errors
    by kernel and shape."""
    import torch
    from slcl_torch.ops.cuda import gen_bwd_plan, launch_counts
    from slcl_torch.ops.cuda import mpcl as K_mpcl
    from slcl_torch.ops.cuda import mpcl_pseudo as K_mp
    from slcl_torch.ops.cuda import pseudo_label as K_pl
    from slcl_torch.ops.cuda import soft_centroids as K_sc

    dev = torch.device("cuda")
    T, base_T, scale, tm, th = 0.1, 1.0, 0.1, 0.2, 0.25
    grad = torch.ones(1, device=dev)
    errs: dict = {}

    def keep(kname, tag, err):
        errs.setdefault(kname, {})[tag] = max(err, errs.get(kname, {}).get(tag, 0.0))

    def twice(fn, what):
        a, b = fn(), fn()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        if not all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: two launches differ")
        return a if len(a) > 1 else a[0]

    m = GEN_M
    forms = set()        # the centroid backward's forms these calls took
    fwd_forms = set()    # the forward's: form, a warp split, how A is read
    for C_, P_, f in GEN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"C={C_} P={P_} F={f} {str(dtype)[6:]}"
            g_rtol = 1.6e-2 if dtype == torch.bfloat16 else 2e-3
            before = launch_counts()
            feats = torch.randn(m, f, generator=g, device=dev).to(dtype)
            centers = torch.randn(C_, f, generator=g, device=dev)
            cen = K_pl.normalize_rows(centers).contiguous()
            labels = torch.randint(0, C_, (m,), generator=g, device=dev, dtype=torch.int32)
            labels[::1009] = C_          # out of range: mlpp 0, zero gradient
            labels[m - 3:] = torch.tensor([-1, C_, C_ + 3], dtype=torch.int32, device=dev)
            sel = torch.randint(0, 2, (m,), generator=g, device=dev).float()
            sel[::7] = 0.5
            x = feats.detach().requires_grad_(True)

            # ---- MPCL ----
            for s in (sel, None):
                what = f"general {tag} mpcl sel={s is not None}"
                stats = twice(lambda: K_mpcl.mpcl_fwd_cuda(feats, labels, cen, s, T, 0.4,
                                                           False, scale), what + " fwd")
                want = K_mpcl.mpcl_plain(x, labels, cen, s, temperature=T,
                                         base_temperature=base_T, margin=0.4)
                keep("mpcl_fwd_general", tag, close(stats[0], want.detach(), 1e-4, 0.0,
                                                    what + " loss"))
                (g_want,) = torch.autograd.grad(want, x)
                d1 = twice(lambda: K_mpcl.mpcl_bwd_cuda(feats, labels, cen, s, T, 0.4, False,
                                                        scale, grad, stats), what + " bwd")
                keep("mpcl_bwd_general", tag, close(d1, g_want, g_rtol,
                                                    1e-3 * float(g_want.abs().max()),
                                                    what + " dfeats"))

            # ---- fused target branch and pseudo-labels ----
            what = f"general {tag} mpcl_pseudo"
            near = near_tie_rows(feats, cen, th)
            n_near = int(near.sum())
            stats = twice(lambda: K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale,
                                                            th), what + " fwd")
            want = K_mp.mpcl_pseudo_plain(x, cen, temperature=T, base_temperature=base_T,
                                          margin=tm, pixel_sel_th=th)
            num, den = float(stats[1]), float(stats[2])
            slack = scale * n_near * (2 * (3.0 / T + 10.0) / den + abs(num) / den ** 2)
            keep("mpcl_pseudo_fwd_general", tag,
                 close(stats[0], want.detach(), 1e-4, slack, what + " loss"))
            (g_want,) = torch.autograd.grad(want, x)
            d1 = twice(lambda: K_mp.mpcl_pseudo_bwd_cuda(feats, cen, T, tm, False, scale, th,
                                                         grad, stats), what + " bwd")
            keep("mpcl_pseudo_bwd_general", tag,
                 close(d1[~near], g_want[~near], g_rtol, 1e-3 * float(g_want.abs().max()),
                       what + " dfeats"))
            lab_k, mask_k = twice(lambda: K_pl.pseudo_label_cuda(feats, centers, th),
                                  f"general {tag} pseudo_label")
            lab_p, mask_p = K_pl.pseudo_label_plain(feats, centers, th)
            differ = ((lab_k != lab_p) | (mask_k != mask_p)) & ~near_tie_rows(feats, centers,
                                                                              th)
            if bool(differ.any()):
                raise AssertionError(f"general {tag} pseudo_label: {int(differ.sum())} rows "
                                     "differ away from a tie")
            keep("pseudo_label_general", tag, float(differ.any()))
            # the fused backward zeroes exactly the rows pseudo_label masks,
            # and its forward counted them: one cosine routine, one rule
            # (pseudo_label_cuda normalises the raw centres to cen itself)
            zero = (d1 == 0).all(dim=1)
            if not torch.equal(zero, mask_k == 0) or round(den) != int((mask_k != 0).sum()):
                raise AssertionError(f"{what}: the fused route's rows and pseudo_label's "
                                     "mask disagree")

            # ---- soft centroids, std-free and std ----
            probs = torch.softmax(2.0 * torch.randn(m, C_, generator=g, device=dev), dim=-1)
            assign = torch.randint(0, P_, (m,), generator=g, device=dev, dtype=torch.int32)
            assign[::1013] = P_
            assign[5::2027] = -1
            for P in sorted({1, P_}):
                a = assign if P > 1 else None
                for weighted in (False, True):
                    for thd in (0.0, 0.4):
                        what = f"general {tag} soft_centroids P={P} soft={weighted} thd={thd}"
                        cents, counts, ratio = twice(lambda: K_sc.soft_centroids_fwd_cuda(
                            feats, probs, a, P, thd, weighted), what + " fwd")
                        fwd_forms.add(fwd_form(C_, P, f, False, feats.element_size()))
                        xc = feats.detach().requires_grad_(True)
                        pr = probs.detach().requires_grad_(True)
                        w_c, w_r = K_sc.soft_centroids_plain(xc, pr, a, partition=P,
                                                             threshold=thd, weighted=weighted)
                        keep("soft_centroids_fwd_general", tag,
                             close(cents, w_c.detach(), 1e-4, 1e-5, what + " cents"))
                        close(ratio, w_r, 1e-5, 0.0, what + " ratio")
                        dc = torch.randn(P, C_, f, generator=g, device=dev)
                        want_g = torch.autograd.grad(w_c, [xc, pr] if weighted else [xc], dc)
                        d = twice(lambda: K_sc.soft_centroids_bwd_cuda(
                            feats, probs, a, P, thd, weighted, dc, cents, counts, weighted),
                            what + " bwd")
                        forms.add(gen_bwd_plan(C_, P, f, False, feats.element_size(),
                                               weighted)["form"])
                        keep("soft_centroids_bwd_general", tag,
                             close(d[0], want_g[0], g_rtol,
                                   1e-3 * float(want_g[0].abs().max()), what + " dfeats"))
                        if weighted:
                            close(d[1], want_g[1], 2e-3, 1e-3 * float(want_g[1].abs().max()),
                                  what + " dprobs")
                        if P != P_:
                            continue
                        # the std variant at the shape's P
                        what = what.replace("soft_centroids", "std")
                        out = twice(lambda: K_sc.soft_centroids_fwd_cuda(
                            feats, probs, a, P, thd, weighted, with_std=True), what + " fwd")
                        fwd_forms.add(fwd_form(C_, P, f, True, feats.element_size()))
                        cents, counts, ratio, std, s2 = out
                        w_c, w_r, w_s = K_sc.soft_centroids_plain(
                            xc, pr, a, partition=P, threshold=thd, weighted=weighted,
                            with_std=True)
                        close(cents, w_c.detach(), 1e-4, 1e-5, what + " cents")
                        close(ratio, w_r, 1e-5, 0.0, what + " ratio")
                        keep("soft_centroids_fwd_std_general", tag,
                             close(std, w_s.detach(), 1e-4, 1e-5, what + " std"))
                        dstd = torch.randn(C_, generator=g, device=dev)
                        want_g = torch.autograd.grad((w_c * dc).sum() + (w_s * dstd).sum(),
                                                     [xc, pr] if weighted else [xc])
                        d = twice(lambda: K_sc.soft_centroids_bwd_cuda(
                            feats, probs, a, P, thd, weighted, dc, cents, counts, weighted,
                            dstd=dstd, std=std, s2=s2), what + " bwd")
                        forms.add(gen_bwd_plan(C_, P, f, True, feats.element_size(),
                                               weighted)["form"])
                        keep("soft_centroids_bwd_std_general", tag,
                             close(d[0], want_g[0], g_rtol,
                                   1e-3 * float(want_g[0].abs().max()), what + " dfeats"))
                        if weighted:
                            close(d[1], want_g[1], 2e-3, 1e-3 * float(want_g[1].abs().max()),
                                  what + " dprobs")
            general_counts_moved(before, f"general {tag}")
            log(f"general {tag}: ok")
    if forms != {"ring", "direct"}:
        raise AssertionError(f"the general centroid backward took the forms {forms} only")
    want = {"grouped", "ring", "ring, narrow", "ring, warps split over m",
            "ring, warps split over n", "ring, A by ldmatrix", "ring, A by element",
            "ring, f32 features", "ring, the std"}
    if not want <= set().union(*fwd_forms):
        raise AssertionError(f"the general centroid forward took the forms {fwd_forms} only")
    return errs


def fwd_form(C: int, P: int, F: int, std: bool, itemsize: int) -> frozenset:
    """What a general centroid forward call at this shape runs
    (gen_fwd_plan): its form and, on the ring, whether its warps split the
    m- or n-tiles, whether it is the narrow form (one n-tile), how it reads
    A, its feature type and the std."""
    from slcl_torch.ops.cuda import gen_fwd_plan
    plan = gen_fwd_plan(C, P, F, std, itemsize)
    if plan["form"] == "grouped":
        return frozenset({"grouped"})
    out = {"ring", "ring, A by " + ("ldmatrix" if itemsize == 2 and F % 8 == 0 else "element")}
    if plan["form"] == "narrow":
        out.add("ring, narrow")
    if plan["wm"] > 1:
        out.add("ring, warps split over m")
    if plan["wn"] > 1:
        out.add("ring, warps split over n")
    if itemsize == 4:
        out.add("ring, f32 features")
    if std:
        out.add("ring, the std")
    return frozenset(out)


def check_general_forced(g) -> dict:
    """Phase 2: the general family forced (``route="general"``) at the main
    shape (M rows, F = 32, C = 4, P = 1 and 2) against the templated one on
    the same inputs, bf16 and f32: pseudo-labels and masks equal, the fused
    forward's den equal and its backward's zero rows the same, every value
    within the main shape's tolerances of the templated kernel's; then each
    general forward's streaming pass over two halves of the rows, their
    partials summed through ``reduce`` (as under data parallelism), against
    the whole batch's. Returns the max abs differences."""
    import torch
    from slcl_torch.ops.cuda import mpcl as K_mpcl
    from slcl_torch.ops.cuda import mpcl_pseudo as K_mp
    from slcl_torch.ops.cuda import pseudo_label as K_pl
    from slcl_torch.ops.cuda import soft_centroids as K_sc

    dev = torch.device("cuda")
    T, scale, tm, th = 0.1, 0.1, 0.2, 0.25
    grad = torch.ones(1, device=dev)
    out: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        g_rtol = 1.6e-2 if dtype == torch.bfloat16 else 2e-3
        feats = torch.randn(M, F, generator=g, device=dev).to(dtype)
        centers = torch.randn(C, F, generator=g, device=dev)
        cen = K_pl.normalize_rows(centers).contiguous()
        labels = torch.randint(0, C, (M,), generator=g, device=dev, dtype=torch.int32)
        sel = torch.randint(0, 2, (M,), generator=g, device=dev).float()
        probs = torch.softmax(torch.randn(M, C, generator=g, device=dev), dim=-1)
        assign = torch.randint(0, 2, (M,), generator=g, device=dev, dtype=torch.int32)
        what = f"forced M={M} F={F} {dt}"
        # labels and masks: one cosine routine, one rule
        lt, mt = K_pl.pseudo_label_cuda(feats, centers, th, route="templated")
        lg, mg = K_pl.pseudo_label_cuda(feats, centers, th, route="general")
        if not (torch.equal(lt, lg) and torch.equal(mt, mg)):
            raise AssertionError(f"{what}: pseudo-labels or masks differ between the "
                                 f"families in {int(((lt != lg) | (mt != mg)).sum())} rows")
        st = K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale, th, route="templated")
        sg = K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale, th, route="general")
        if float(st[2]) != float(sg[2]):
            raise AssertionError(f"{what}: fused den {float(st[2])} vs {float(sg[2])}")
        err = {"mpcl_pseudo_fwd": close(sg[0], st[0], 1e-4, 0.0, what + " fused loss")}
        dt_ = K_mp.mpcl_pseudo_bwd_cuda(feats, cen, T, tm, False, scale, th, grad, st,
                                        route="templated")
        dg = K_mp.mpcl_pseudo_bwd_cuda(feats, cen, T, tm, False, scale, th, grad, sg,
                                       route="general")
        if not torch.equal((dt_ == 0).all(dim=1), (dg == 0).all(dim=1)):
            raise AssertionError(f"{what}: the fused backwards zero different rows")
        err["mpcl_pseudo_bwd"] = close(dg, dt_, g_rtol, 1e-3 * float(dt_.abs().max()),
                                       what + " fused dfeats")
        for s in (sel, None):
            st = K_mpcl.mpcl_fwd_cuda(feats, labels, cen, s, T, 0.4, False, scale,
                                      route="templated")
            sg = K_mpcl.mpcl_fwd_cuda(feats, labels, cen, s, T, 0.4, False, scale,
                                      route="general")
            err["mpcl_fwd"] = close(sg[0], st[0], 1e-4, 0.0, what + " mpcl loss")
            dt_ = K_mpcl.mpcl_bwd_cuda(feats, labels, cen, s, T, 0.4, False, scale, grad, st,
                                       route="templated")
            dg = K_mpcl.mpcl_bwd_cuda(feats, labels, cen, s, T, 0.4, False, scale, grad, sg,
                                      route="general")
            err["mpcl_bwd"] = close(dg, dt_, g_rtol, 1e-3 * float(dt_.abs().max()),
                                    what + " mpcl dfeats")
        for P, weighted, std in ((1, False, False), (1, True, False), (2, True, False),
                                 (2, True, True)):
            a = assign if P > 1 else None
            tag = f"{what} centroids P={P} soft={weighted} std={std}"
            ot = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, weighted, std,
                                              route="templated")
            og = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, weighted, std,
                                              route="general")
            key = "soft_centroids_" + ("fwd_std" if std else "fwd")
            err[key] = max(err.get(key, 0.0), close(og[0], ot[0], 1e-4, 1e-5, tag))
            close(og[2], ot[2], 1e-5, 0.0, tag + " ratio")
            if std:
                close(og[3], ot[3], 1e-4, 1e-5, tag + " std")
            dc = torch.randn(P, C, F, generator=g, device=dev)
            kw = {}
            if std:
                kw = dict(dstd=torch.randn(C, generator=g, device=dev))
            bt = K_sc.soft_centroids_bwd_cuda(
                feats, probs, a, P, 0.0, weighted, dc, ot[0], ot[1], weighted,
                **({**kw, "std": ot[3], "s2": ot[4]} if std else {}), route="templated")
            bg = K_sc.soft_centroids_bwd_cuda(
                feats, probs, a, P, 0.0, weighted, dc, og[0], og[1], weighted,
                **({**kw, "std": og[3], "s2": og[4]} if std else {}), route="general")
            key = "soft_centroids_" + ("bwd_std" if std else "bwd")
            err[key] = max(err.get(key, 0.0), close(bg[0], bt[0], g_rtol,
                                                    1e-3 * float(bt[0].abs().max()),
                                                    tag + " dfeats"))
            if weighted:
                close(bg[1], bt[1], 2e-3, 1e-3 * float(bt[1].abs().max()), tag + " dprobs")
        out[dt] = err
        log(f"{what}: general == templated labels and masks, values within tolerance")

    # two halves' partials summed through reduce, as two data ranks' are
    feats = torch.randn(M, F, generator=g, device=dev).to(torch.bfloat16)
    cen = K_pl.normalize_rows(torch.randn(C, F, generator=g, device=dev)).contiguous()
    labels = torch.randint(0, C, (M,), generator=g, device=dev, dtype=torch.int32)
    probs = torch.softmax(torch.randn(M, C, generator=g, device=dev), dim=-1)
    assign = torch.randint(0, 2, (M,), generator=g, device=dev, dtype=torch.int32)
    h = M // 2
    halves = (slice(0, h), slice(h, M))
    saved = {}

    def keep_parts(parts):
        saved["a"] = parts.clone()

    def add_parts(parts):
        if parts.shape != saved["a"].shape:
            raise AssertionError("the halves' partial buffers differ in size")
        parts += saved["a"]

    def split(fn):
        fn(halves[0], keep_parts)
        return fn(halves[1], add_parts)

    red = {}
    whole = K_mpcl.mpcl_fwd_cuda(feats, labels, cen, None, T, 0.4, False, scale,
                                 route="general")
    got = split(lambda r, hook: K_mpcl.mpcl_fwd_cuda(
        feats[r], labels[r], cen, None, T, 0.4, False, scale, reduce=hook, m_total=M,
        route="general"))
    red["mpcl_fwd"] = close(got[0], whole[0], 1e-5, 0.0, "halves mpcl loss")
    whole = K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale, th, route="general")
    got = split(lambda r, hook: K_mp.mpcl_pseudo_fwd_cuda(
        feats[r], cen, T, tm, False, scale, th, reduce=hook, route="general"))
    if float(got[2]) != float(whole[2]):
        raise AssertionError(f"halves fused den {float(got[2])} vs {float(whole[2])}")
    red["mpcl_pseudo_fwd"] = close(got[0], whole[0], 1e-5, 0.0, "halves fused loss")
    for std in (False, True):
        whole = K_sc.soft_centroids_fwd_cuda(feats, probs, assign, 2, 0.4, True, std,
                                             route="general")
        got = split(lambda r, hook: K_sc.soft_centroids_fwd_cuda(
            feats[r], probs[r], assign[r], 2, 0.4, True, std, reduce=hook, m_total=M,
            route="general"))
        key = "soft_centroids_fwd" + ("_std" if std else "")
        red[key] = close(got[0], whole[0], 1e-5, 1e-6, f"halves {key}")
        close(got[2], whole[2], 1e-6, 0.0, f"halves {key} ratio")
        if std:
            red[key] = max(red[key], close(got[3], whole[3], 1e-5, 1e-6, f"halves {key} std"))
    out["halves_reduced"] = red
    log("general forwards: two halves' partials summed through reduce == the whole batch's")
    return out


def general_rows(errs: dict, forced: dict, peaks, g) -> dict:
    """Phase 2: each general kernel's row of the kernel table, timed at its
    phase 4 cell's shape (bf16, M rows; GEN_CELLS): the ``slcl_c5_f24``
    step's calls at C = 5, F = 24 (MPCL without sel, the fused target
    branch, the pseudo-labels, hard centroids at P = 1), and the
    ``mccl_p4_c5_f48_std`` step's at C = 5, F = 48 (the std pair, soft, P =
    4; the std-free pair's img_t_aug call, soft, P = 1, under ``mccl``).
    Beside each its plain version and, where one PyTorch call computes the
    same function, that call (``library_ms``, as the templated rows take
    it); its bound from the shape; its max abs error against the plain
    version at the cell's shape and at each of GEN_SHAPES
    (``max_abs_err_by_shape``); and ``forced_ms``, the general kernel forced
    at the main shape (F = 32, C = 4; P = 1 hard, the std pair P = 2 soft)
    beside ``templated_ms``, the templated kernel on the same inputs in the
    same call, each with ``forced_vs_templated_max_abs_diff``. The backward
    rows also take the pair of mm's that gives both their outputs
    (``p{P}_library_pair_ms``, as the templated rows do) and their launch
    plan at the cell's shape (``bwd_plan``: form, features a chunk, rows a
    tile, stages, shared memory)."""
    import torch
    from slcl_torch.ops.cuda import gen_bwd_plan, gen_fwd_plan
    from slcl_torch.ops.cuda import mpcl as K_mpcl
    from slcl_torch.ops.cuda import mpcl_pseudo as K_mp
    from slcl_torch.ops.cuda import pseudo_label as K_pl
    from slcl_torch.ops.cuda import soft_centroids as K_sc

    dev = torch.device("cuda")
    T, base_T, scale, tm, th = 0.1, 1.0, 0.1, 0.2, 0.25
    grad = torch.ones(1, device=dev)
    rows: dict = {}

    def row(kname, **kw):
        r = rows.setdefault(kname, {"library_ms": None})
        r.update(kw)
        return r

    # ---- the slcl_c5_f24 step's calls: C = 5, F = 24 ----
    c, f = 5, 24
    feats = torch.randn(M, f, generator=g, device=dev).to(torch.bfloat16)
    es = feats.element_size()
    centers = torch.randn(c, f, generator=g, device=dev)
    cen = K_pl.normalize_rows(centers).contiguous()
    labels = torch.randint(0, c, (M,), generator=g, device=dev, dtype=torch.int32)
    x = feats.detach().requires_grad_(True)

    def fwd():
        return K_mpcl.mpcl_fwd_cuda(feats, labels, cen, None, T, 0.4, False, scale)

    def plain():
        return K_mpcl.mpcl_plain(feats, labels, cen, None, temperature=T,
                                 base_temperature=base_T, margin=0.4)
    stats = fwd()
    y = K_mpcl.mpcl_plain(x, labels, cen, None, temperature=T, base_temperature=base_T,
                          margin=0.4)
    (gw,) = torch.autograd.grad(y, x, retain_graph=True)
    fl_row = 2 * f + 2 * c * f + 12 * c
    row("mpcl_fwd_general", cell_err=close(stats[0], y.detach(), 1e-4, 0.0, "cell mpcl loss"),
        ms=time_ms(fwd), plain_ms=time_ms(plain),
        bound=bound(M * (f * es + 4), M * fl_row, peaks),
        **launch_split(fwd, {"partial_ms": "mpcl_gen_fwd_partial",
                             "final_ms": "mpcl_fwd_final"}))

    def bwd():
        return K_mpcl.mpcl_bwd_cuda(feats, labels, cen, None, T, 0.4, False, scale, grad,
                                    stats)
    row("mpcl_bwd_general", cell_err=close(bwd(), gw, 1.6e-2, 1e-3 * float(gw.abs().max()),
                                           "cell mpcl dfeats"),
        ms=time_ms(bwd), plain_ms=time_ms(lambda: torch.autograd.grad(y, x, retain_graph=True)),
        bound=bound(M * (2 * f * es + 4), M * (fl_row + 2 * c * f + 4 * f), peaks))
    del y

    def ffwd():
        return K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale, th)
    stats = ffwd()
    near = near_tie_rows(feats, cen, th)
    y = K_mp.mpcl_pseudo_plain(x, cen, temperature=T, base_temperature=base_T, margin=tm,
                               pixel_sel_th=th)
    (gw,) = torch.autograd.grad(y, x, retain_graph=True)
    num, den = float(stats[1]), float(stats[2])
    slack = scale * int(near.sum()) * (2 * (3.0 / T + 10.0) / den + abs(num) / den ** 2)
    fl_row = 2 * f + 2 * c * f + 16 * c
    row("mpcl_pseudo_fwd_general",
        cell_err=close(stats[0], y.detach(), 1e-4, slack, "cell fused loss"),
        near_tie_rows=int(near.sum()), ms=time_ms(ffwd),
        plain_ms=time_ms(lambda: K_mp.mpcl_pseudo_plain(
            feats, cen, temperature=T, base_temperature=base_T, margin=tm, pixel_sel_th=th)),
        bound=bound(M * f * es, M * fl_row, peaks),
        **launch_split(ffwd, {"partial_ms": "mpcl_pseudo_gen_fwd_partial",
                              "final_ms": "mpcl_fwd_final"}))

    def fbwd():
        return K_mp.mpcl_pseudo_bwd_cuda(feats, cen, T, tm, False, scale, th, grad, stats)
    row("mpcl_pseudo_bwd_general",
        cell_err=close(fbwd()[~near], gw[~near], 1.6e-2, 1e-3 * float(gw.abs().max()),
                       "cell fused dfeats"),
        ms=time_ms(fbwd), plain_ms=time_ms(lambda: torch.autograd.grad(y, x, retain_graph=True)),
        bound=bound(2 * M * f * es, M * (fl_row + 2 * c * f + 4 * f), peaks))
    del y
    lab_k, mask_k = K_pl.pseudo_label_cuda(feats, centers, th)
    lab_p, mask_p = K_pl.pseudo_label_plain(feats, centers, th)
    differ = ((lab_k != lab_p) | (mask_k != mask_p)) & ~near_tie_rows(feats, centers, th)
    if bool(differ.any()):
        raise AssertionError(f"cell pseudo_label: {int(differ.sum())} rows differ away from "
                             "a tie")
    row("pseudo_label_general", cell_err=float(differ.any()),
        ms=time_ms(lambda: K_pl.pseudo_label_cuda(feats, centers, th)),
        plain_ms=time_ms(lambda: K_pl.pseudo_label_plain(feats, centers, th)),
        bound=bound(M * (f * es + 4 + 4), M * (2 * f + 2 * c * f), peaks),
        **launch_split(lambda: K_pl.pseudo_label_cuda(feats, centers, th),
                       {"kernel_ms": "pseudo_label_gen"}))

    # the CNR centroids: hard, P = 1
    probs = torch.softmax(torch.randn(M, c, generator=g, device=dev), dim=-1)
    labels_hard = probs.argmax(dim=1)
    cents, counts, ratio = K_sc.soft_centroids_fwd_cuda(feats, probs, None, 1, 0.0, False)
    xc = feats.detach().requires_grad_(True)
    yc, _ = K_sc.soft_centroids_plain(xc, probs, None, partition=1, weighted=False)
    dc = torch.randn(1, c, f, generator=g, device=dev)
    (gw,) = torch.autograd.grad(yc, xc, dc, retain_graph=True)
    sums = torch.zeros(c, f, device=dev, dtype=feats.dtype)
    row("soft_centroids_fwd_general", cell_err=close(cents, yc.detach(), 1e-4, 1e-5,
                                                     "cell centroids"),
        err_f64=float((cents.double() - centroids_f64(feats, probs, None, 1, 0.0, False,
                                                      False)["cents"]).abs().max()),
        ms=time_ms(lambda: K_sc.soft_centroids_fwd_cuda(feats, probs, None, 1, 0.0, False)),
        plain_ms=time_ms(lambda: K_sc.soft_centroids_plain(feats, probs, None, partition=1,
                                                           weighted=False)),
        library_ms=time_ms(lambda: sums.index_add_(0, labels_hard, feats)),
        bound=bound(M * (f * es + 4 * c), 2 * M * f, peaks),
        fwd_plan=gen_fwd_plan(c, 1, f, False, es),
        **launch_split(lambda: K_sc.soft_centroids_fwd_cuda(feats, probs, None, 1, 0.0, False),
                       {"partial_ms": "centroids_gen_fwd_partial",
                        "final_ms": "centroids_gen_fwd_final"}))
    dsums = (dc[0] / (counts[:, None] + 1e-7)).to(feats.dtype)

    def cbwd():
        return K_sc.soft_centroids_bwd_cuda(feats, probs, None, 1, 0.0, False, dc, cents,
                                            counts, False)
    row("soft_centroids_bwd_general",
        cell_err=close(cbwd()[0], gw, 1.6e-2, 1e-3 * float(gw.abs().max()), "cell dfeats"),
        ms=time_ms(cbwd),
        plain_ms=time_ms(lambda: torch.autograd.grad(yc, xc, dc, retain_graph=True)),
        library_ms=time_ms(lambda: dsums.index_select(0, labels_hard)),
        bound=bound(M * (f * es + 4 * c), 2 * M * f, peaks),
        bwd_plan=gen_bwd_plan(c, 1, f, False, es, False))
    del yc

    # ---- the mccl_p4_c5_f48_std step's calls: C = 5, F = 48, soft ----
    f = 48
    feats = torch.randn(M, f, generator=g, device=dev).to(torch.bfloat16)
    feats32 = feats.float()
    probs = torch.softmax(torch.randn(M, c, generator=g, device=dev), dim=-1)
    for P in (4, 1):
        a = (torch.randint(0, P, (M,), generator=g, device=dev, dtype=torch.int32)
             if P > 1 else None)
        ids = 4 * M if P > 1 else 0
        std = P > 1          # the std pair on img_t; the std-free pair on img_t_aug
        dc = torch.randn(P, c, f, generator=g, device=dev)
        dstd = torch.randn(c, generator=g, device=dev)
        part = a.long() if a is not None else torch.zeros(M, dtype=torch.long, device=dev)
        w32 = torch.zeros(M, P, c, device=dev).scatter_(
            1, part[:, None, None].expand(M, 1, c), probs[:, None, :]).reshape(M, P * c)
        w16, ds16 = w32.to(feats.dtype), dc.reshape(P * c, f).to(feats.dtype)
        # the std's S2 operands: the weights summed over the partitions and
        # the squared features, bf16
        wc16, sq16 = w32.reshape(M, P, c).sum(1).to(feats.dtype), feats * feats
        out = K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, True, std)
        xc = feats.detach().requires_grad_(True)
        pr = probs.detach().requires_grad_(True)
        want = K_sc.soft_centroids_plain(xc, pr, a, partition=P, weighted=True, with_std=std)
        yc = (want[0] * dc).sum() + ((want[2] * dstd).sum() if std else 0.0)
        gx, gp = torch.autograd.grad(yc, [xc, pr], retain_graph=True)
        kw = dict(dstd=dstd, std=out[3], s2=out[4]) if std else {}

        def cf():
            return K_sc.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, True, std)

        def cb():
            return K_sc.soft_centroids_bwd_cuda(feats, probs, a, P, 0.0, True, dc, out[0],
                                                out[1], True, **kw)
        d = cb()
        fwd_bytes = M * (f * es + 4 * c) + ids
        bwd_bytes = 2 * M * (f * es + 4 * c) + ids
        ref64 = centroids_f64(feats, probs, a, P, 0.0, True, std)
        rec_f = dict(cell_err=close(out[0], want[0].detach(), 1e-4, 1e-5, f"cell P={P} cents"),
                     err_f64=float((out[0].double() - ref64["cents"]).abs().max()),
                     **({"err_f64_std": float((out[3].double() - ref64["std"]).abs().max()),
                         # both products of the std forward: the sums and S2
                         "library_pair_ms": time_ms(lambda: (torch.mm(w16.t(), feats),
                                                             torch.mm(wc16.t(), sq16)))}
                        if std else {}),
                     ms=time_ms(cf),
                     plain_ms=time_ms(lambda: K_sc.soft_centroids_plain(
                         feats, probs, a, partition=P, weighted=True, with_std=std)),
                     library_ms=time_ms(lambda: torch.mm(w16.t(), feats)),
                     library_f32_ms=time_ms(lambda: torch.mm(w32.t(), feats32)),
                     bound=bound(fwd_bytes, (5 if std else 2) * M * f * c, peaks),
                     fwd_plan=gen_fwd_plan(c, P, f, std, es),
                     **launch_split(cf, {"partial_ms": "centroids_gen_fwd_partial",
                                         "final_ms": "centroids_gen_fwd_final"}))
        rec_b = dict(cell_err=close(d[0], gx, 1.6e-2, 1e-3 * float(gx.abs().max()),
                                    f"cell P={P} dfeats"),
                     ms=time_ms(cb),
                     plain_ms=time_ms(lambda: torch.autograd.grad(yc, [xc, pr],
                                                                  retain_graph=True)),
                     library_ms=time_ms(lambda: torch.mm(w16, ds16)),
                     # both outputs: dfeats, and the (M, P*C) dot products
                     # of the rows with the dsums that dprobs is made from
                     **{f"p{P}_library_pair_ms": time_ms(
                         lambda: (torch.mm(w16, ds16), torch.mm(feats, ds16.t())))},
                     bound=bound(bwd_bytes, (8 if std else 4) * M * f * c, peaks),
                     bwd_plan=gen_bwd_plan(c, P, f, std, es, True))
        close(d[1], gp, 2e-3, 1e-3 * float(gp.abs().max()), f"cell P={P} dprobs")
        if std:
            close(out[3], want[2].detach(), 1e-4, 1e-5, f"cell P={P} std")
            row("soft_centroids_fwd_std_general", **rec_f)
            row("soft_centroids_bwd_std_general", **rec_b)
        else:   # the std-free pair's rows are the slcl cell's: these go beside
            rows["soft_centroids_fwd_general"]["mccl_p1_soft"] = {
                k: v for k, v in rec_f.items() if k != "bound"} | {"bound_ms": rec_f["bound"][0]}
            rows["soft_centroids_bwd_general"]["mccl_p1_soft"] = {
                k: v for k, v in rec_b.items() if k != "bound"} | {"bound_ms": rec_b["bound"][0]}
        del yc, w32, w16, wc16, sq16

    # ---- forced at the main shape, beside the templated kernel ----
    feats = torch.randn(M, F, generator=g, device=dev).to(torch.bfloat16)
    centers = torch.randn(C, F, generator=g, device=dev)
    cen = K_pl.normalize_rows(centers).contiguous()
    labels = torch.randint(0, C, (M,), generator=g, device=dev, dtype=torch.int32)
    probs = torch.softmax(torch.randn(M, C, generator=g, device=dev), dim=-1)
    assign = torch.randint(0, 2, (M,), generator=g, device=dev, dtype=torch.int32)
    dc1 = torch.randn(1, C, F, generator=g, device=dev)
    dc2 = torch.randn(2, C, F, generator=g, device=dev)
    dstd = torch.randn(C, generator=g, device=dev)
    st = K_mpcl.mpcl_fwd_cuda(feats, labels, cen, None, T, 0.4, False, scale)
    sp = K_mp.mpcl_pseudo_fwd_cuda(feats, cen, T, tm, False, scale, th)
    c1 = K_sc.soft_centroids_fwd_cuda(feats, probs, None, 1, 0.0, False)
    c2 = K_sc.soft_centroids_fwd_cuda(feats, probs, assign, 2, 0.0, True, True)
    calls = {
        "mpcl_fwd_general": lambda r: K_mpcl.mpcl_fwd_cuda(
            feats, labels, cen, None, T, 0.4, False, scale, route=r),
        "mpcl_bwd_general": lambda r: K_mpcl.mpcl_bwd_cuda(
            feats, labels, cen, None, T, 0.4, False, scale, grad, st, route=r),
        "mpcl_pseudo_fwd_general": lambda r: K_mp.mpcl_pseudo_fwd_cuda(
            feats, cen, T, tm, False, scale, th, route=r),
        "mpcl_pseudo_bwd_general": lambda r: K_mp.mpcl_pseudo_bwd_cuda(
            feats, cen, T, tm, False, scale, th, grad, sp, route=r),
        "pseudo_label_general": lambda r: K_pl.pseudo_label_cuda(feats, centers, th, route=r),
        "soft_centroids_fwd_general": lambda r: K_sc.soft_centroids_fwd_cuda(
            feats, probs, None, 1, 0.0, False, route=r),
        "soft_centroids_bwd_general": lambda r: K_sc.soft_centroids_bwd_cuda(
            feats, probs, None, 1, 0.0, False, dc1, c1[0], c1[1], False, route=r),
        "soft_centroids_fwd_std_general": lambda r: K_sc.soft_centroids_fwd_cuda(
            feats, probs, assign, 2, 0.0, True, True, route=r),
        "soft_centroids_bwd_std_general": lambda r: K_sc.soft_centroids_bwd_cuda(
            feats, probs, assign, 2, 0.0, True, dc2, c2[0], c2[1], True, dstd=dstd,
            std=c2[3], s2=c2[4], route=r)}
    for kname, call in calls.items():
        rows[kname].update(forced_ms=time_ms(lambda: call("general")),
                           templated_ms=time_ms(lambda: call("templated")))
    for kname in rows:
        base = kname[:-len("_general")]
        by_shape = dict(errs.get(kname, {}), cell=rows[kname].pop("cell_err"))
        rows[kname].update(max_abs_err=max(by_shape.values()),
                           max_abs_err_by_shape=by_shape,
                           forced_vs_templated_max_abs_diff=max(
                               v.get(base, 0.0) for k, v in forced.items()
                               if k in ("bfloat16", "float32")))
    return rows


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
    """Phase 3's shallow backbones (``slcl_torch.testing.build_shallow``),
    seeded from ``run.seed``, for :func:`use_segmentor` to put in place of a
    built Trainer's network, whose discriminators were drawn after the
    factory's. Phases 3, 9 and 10 hold the card to the CPU and to one
    process on these weights; the CPU tests build the shallow net inside
    the Trainer instead (``shallow_segmentor``), which draws other
    discriminators: on those, phase 3's ``deeplabv2 advent`` ``dis_acc_t``
    read 0.5 on the card against 0.375 on the CPU in its second step."""
    import torch
    from slcl_torch.testing import build_shallow
    gen = torch.Generator().manual_seed(cfg.run.seed)
    return build_shallow(kind, cfg.model, gen).to(device, memory_format=torch.channels_last)


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
    # the general kernels on a step: phase 4's two GEN_CELLS at these sizes
    ("slcl c5 f24", "slcl", dict(num_classes=5, filters=24), 32, 2, None, "slcl_c5_f24"),
    ("mccl p4 c5 f48 std", "mccl", dict(num_classes=5, filters=48), 32, 2, None,
     "mccl_p4_c5_f48_std"),
)
# ... and their contrastive overrides (a DRUNet mccl run also takes stdmin
# and seg_pseudo, as the runs above)
SMALL_CONTRASTIVE = {"mccl p4 c5 f48 std": dict(part=4)}


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
        t0 = time.perf_counter()
        cfg = small_config(method)
        cfg.data.crop = crop
        for k, v in model.items():
            setattr(cfg.model, k, v)
        if method == "mccl" and "backbone" not in model:
            cfg.contrastive.concat_forward = "concat" in label
            cfg.contrastive.stdmin, cfg.contrastive.w_stdmin = True, 0.1
            cfg.contrastive.seg_pseudo = True
        for k, v in SMALL_CONTRASTIVE.get(label, {}).items():
            setattr(cfg.contrastive, k, v)
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
                      "launches": counts, "seconds": time.perf_counter() - t0}
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


def shared_dropout(seed: int):
    """Dropout masks for ``build_step``'s ``draw_dropout``: from a CPU
    generator seeded by (seed, step, module path, call), then moved to the
    step's device, so that a step on the card and one on the CPU drop alike."""
    import torch
    from slcl_torch.train.steps_extra import dropout_seed

    def draw(step, path, call, shape, keep, device):
        g = torch.Generator().manual_seed(dropout_seed(seed, step, path, call))
        return (torch.rand(shape, generator=g) < keep).to(device)
    return draw


def check_small_extra_steps() -> dict:
    """Phase 3, DDFSeg / AdaptEvery / BCL: two steps of each on the card
    against the CPU from the same weights, batches and dropout masks
    (``shared_dropout``) at 64x64 in f32: a slim DDFNet (``ddfseg.filters=4
    style_filters=4 ngf=8``), ResNetUNetPoint with one block a stage at base
    8 and a base-8 PointNet, BCLDeepLab likewise (the CPU's pseudo-label
    round given to both); each metric at phase 3's tolerance, and no port
    kernel launched."""
    import torch
    from slcl_torch.data import to_device
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train.steps import build_step
    from slcl_torch.train.trainer import Trainer

    out = {}
    for method in EXTRA_METHODS:
        cfg = small_config(method)
        cfg.data.crop = 64
        cfg.model.layers, cfg.model.base = (1, 1, 1, 1), 8
        d = cfg.ddfseg
        d.filters, d.style_filters, d.ngf, d.slim = 4, 4, 8, True
        cpu = Trainer(cfg, device="cpu")
        gpu = Trainer(cfg, device="cuda")
        for t in (cpu, gpu):
            t.step_fn = build_step(cfg, draw_dropout=shared_dropout(7))
        if method == "bcl":
            cpu.bcl_update_plabels(cfg.run.bcl_prop)
            gpu.bcl_plabels = cpu.bcl_plabels
        batches = [b for _, b in zip(range(2), cpu._epoch_batches())]
        sched = cpu._sched(0)
        reset_launch_counts()
        for i, b in enumerate(batches):
            m_cpu = cpu.step_fn(cpu.state, to_device(b, torch.device("cpu")), sched)
            m_gpu = gpu.step_fn(gpu.state, to_device(b, torch.device("cuda")), sched)
            if set(m_cpu) != set(m_gpu):
                raise AssertionError(f"small {method} step {i}: metric keys differ")
            for k, v in m_cpu.items():
                close(m_gpu[k].cpu(), v, 5e-3, 1e-4, f"small {method} step {i} {k}")
        counts = launch_counts()
        if any(counts.values()):
            raise AssertionError(f"small {method}: port kernels launched {counts}")
        torch.cuda.synchronize()
        out[method] = {"steps": len(batches), "crop": cfg.data.crop, "launches": counts,
                       "params": sum(p.numel() for p in gpu.state.seg.parameters()),
                       "metrics": {k: float(v) for k, v in m_gpu.items()}}
        log(f"small {method}: card matches CPU over {len(batches)} steps")
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
            "unet_baseline": 31_037_828,
            # DDFNet + SegDecoder (16/8/32, not slim); ResNetUNetPoint (the
            # ResNet-50 U-Net multilvl + the 300-vertex head); BCLDeepLab
            # (ResNet-101, one feature-returning ASPP head)
            "ddfseg": 39_665_640, "adaptevery": 37_834_348, "bcl": 42_795_088,
            # GEN_CELLS: DRUNet multilvl at 24 filters, 5 classes; the mccl
            # preset's DRUNet at 48 filters, 5 classes
            "slcl_c5_f24": 7_586_818, "mccl_p4_c5_f48_std": 30_340_517}
# phase 4's cells of DDFSeg, AdaptEvery and BCL: (method, timed steps)
EXTRA_CELLS = (("ddfseg", 10), ("adaptevery", 10), ("bcl", 10))
# phase 4's backbone cells: (name, method, backbone, timed steps); the paper's
# cell first (train_SLCL.py: resnet50, multilvl)
BACKBONE_CELLS = (("resnet50_slcl", "slcl", "resnet50", 20),
                  ("resnet50_mccl", "mccl", "resnet50", 10),
                  ("deeplabv2_advent", "advent", "deeplabv2", 5),
                  ("deeplabv2_adaptseg", "adaptseg", "deeplabv2", 5),
                  ("unet_baseline", "baseline", "unet", 10))


def train_full_width(work: Path, method: str = "slcl", stdmin: bool = False,
                     n_timed: int = 20, backbone: str = "drunet",
                     name: str = "", rain: dict = None, over: dict = None) -> dict:
    """Phase 4: one full-width recipe through the port's Trainer: ``slcl``
    with multilvl (the main path), or the ``mccl`` preset, with ``stdmin``
    its std term (``contrastive.stdmin=true contrastive.w_stdmin=0.1``) or
    ``rain`` its RAIN overrides (``rain.eps_iters`` steps a batch, a fresh
    sampling on the first); on ``backbone``, with ``advent``/``adaptseg``
    (multilvl) and ``baseline`` too; or ``pretrain_rain`` (bs16 content +
    16 style); or ``ddfseg``/``adaptevery``/``bcl`` on their recipes' own
    networks (BCL's epoch begins with a pseudo-label round); ``over`` sets
    config keys by section last (GEN_CELLS: other C, P and F, on the general
    kernels). ``name`` keys N_PARAMS and PER_METHOD (default: the
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
    if method not in EXTRA_METHODS:      # those build their own networks
        cfg.model.backbone = backbone
        cfg.model.multilvl = method in ("slcl", "advent", "adaptseg")
    if stdmin:
        cfg.contrastive.stdmin, cfg.contrastive.w_stdmin = True, 0.1
    for k, v in (rain or {}).items():
        setattr(cfg.rain, k, v)
    for section, kv in (over or {}).items():
        for k, v in kv.items():
            setattr(getattr(cfg, section), k, v)
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
    # each step alone, synchronised: its spread (no overlap with the next),
    # over half as many steps
    each = []
    for batch, s in iterations(batches, scheds, max(5, n_timed // 2)):
        t3 = time.perf_counter()
        trainer.step_fn(trainer.state, batch, s)
        torch.cuda.synchronize()
        each.append((time.perf_counter() - t3) * 1e3)
    each.sort()
    prof = profile_steps(trainer, batches, scheds, n=max(3, eps_iters))
    net = (backbone if method not in EXTRA_METHODS else type(trainer.state.seg).__name__)
    return {"method": method, "backbone": net, "stdmin": stdmin, "rain": rain,
            "eps_iters": eps_iters, "step_ms": step_ms,
            "timed_steps": n_timed,
            "step_ms_synced_min_median_max": [each[0], each[len(each) // 2], each[-1]],
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


def general_cli(work: Path, name: str, steps: int) -> dict:
    """Phase 4: a GEN_CELLS config for one epoch through ``python -m
    slcl_torch.train``'s ``main`` (synthetic data, validation, the final
    test): each kernel's launches in its ``steps`` steps as PER_METHOD[name]
    says, every epoch mean and test metric finite."""
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train import __main__ as train_cli

    method, over, _ = GEN_CELLS[name]
    args = [f"method={method}", "data.dataset=synthetic", "optim.epochs=1",
            f"run.out_dir={work / ('cli_' + name)}"]
    args += [f"{section}.{k}={str(v).lower() if isinstance(v, bool) else v}"
             for section, kv in over.items() for k, v in kv.items()]
    t0 = time.perf_counter()
    reset_launch_counts()
    rec = train_cli.main(args)
    counts = launch_counts()
    (epoch,) = rec["history"]
    for kname, per in PER_METHOD[name].items():
        if counts[kname] != steps * per:
            raise AssertionError(f"cli {name}: {kname} launched {counts[kname]} times in "
                                 f"{steps} steps, expected {steps * per}")
    vals = [v for v in epoch.values() if isinstance(v, float)]
    vals += [v for split in ("test",) for k in ("dc", "hd", "asd") for v in rec[split][k]]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"cli {name}: non-finite values {epoch} {rec['test']}")
    out = {"args": args, "seconds": time.perf_counter() - t0, "steps": steps,
           "launches": counts, "epoch": epoch,
           "test_dice": rec["test"]["dc"]}
    log(f"cli {name}: one epoch, {steps} steps in {out['seconds']:.1f} s")
    return out


def _same_state(a, b) -> None:
    """Raise unless two trainers hold bit-identical networks, optimizers,
    centres and step."""
    import torch
    from slcl_torch.train.trainer import _NETS, _OPTS
    for net in _NETS + _OPTS:
        if getattr(a.state, net) is None:
            continue
        sa, sb = getattr(a.state, net).state_dict(), getattr(b.state, net).state_dict()
        if net.startswith("opt_"):
            sa = {f"{i}.{k}": v for i, st in sa["state"].items() for k, v in st.items()}
            sb = {f"{i}.{k}": v for i, st in sb["state"].items() for k, v in st.items()}
        bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
        if bad:
            raise AssertionError(f"restore: {net} differs in {bad[:4]}")
    if a.state.centroids is not None and not torch.equal(a.state.centroids,
                                                         b.state.centroids):
        raise AssertionError("restore: centres differ")
    if a.state.step != b.state.step:
        raise AssertionError("restore: step differs")


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
            "resume_max_param_diff": diff, "launches": counts,
            # phase 7 serves this run's best checkpoint (popped before printing)
            "slcl_args": slcl_args, "slcl_best": str(Path(fine["out_dir"]) / "ckpt_best.pt")}


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


def protocol_extra(work: Path) -> dict:
    """Phase 5, DDFSeg / AdaptEvery / BCL through the training CLI at full
    width on the synthetic set: ``bcl`` two epochs with
    ``run.bcl_round_epochs=1`` (a pseudo-label round at the start of each),
    ``ddfseg`` and ``adaptevery`` one epoch each, each with its final test
    (Dice / HD95 / ASSD finite on both domains) and no port kernel launched;
    then DDFSeg's last checkpoint restored and continued against the
    uninterrupted run (the three discriminators, every optimizer and the
    dropout draw included)."""
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train import __main__ as train_cli

    t0 = time.perf_counter()
    base = ["data.dataset=synthetic", "data.gap=0.5", "run.eval_frequency=1",
            f"run.out_dir={work / 'extra'}"]
    runs = {"bcl": ["method=bcl", *base, "run.bcl_round_epochs=1", "optim.epochs=2"],
            "ddfseg": ["method=ddfseg", *base, "optim.epochs=1"],
            "adaptevery": ["method=adaptevery", *base, "optim.epochs=1"]}
    out = {}
    for method, args in runs.items():
        reset_launch_counts()
        t1 = time.perf_counter()
        run = train_cli.main(args)
        counts = launch_counts()
        if any(counts.values()):
            raise AssertionError(f"protocol {method}: port kernels launched {counts}")
        for split in ("test", "test_s"):
            vals = [v for k in ("dc", "hd", "asd") for v in run[split][k]]
            if len(vals) != 18 or not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"protocol {method}: {split} metrics {run[split]}")
        for r in run["history"]:
            bad = {k: v for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)}
            if bad:
                raise AssertionError(f"protocol {method}: non-finite {bad}")
        out[method] = {"seconds": time.perf_counter() - t1,
                       "val_dice": [r["val_dice"] for r in run["history"]],
                       "epoch_s": [r["epoch_time_s"] for r in run["history"]],
                       "test_dice_hd95_assd": [run["test"][k][0::2]
                                               for k in ("dc", "hd", "asd")]}
        if method == "bcl":
            # a round at the start of each epoch, each leaving some labels
            kept = [r.get("plabel_kept") for r in run["history"]]
            if len(kept) != 2 or not all(k is not None and 0.0 < k <= 1.0 for k in kept):
                raise AssertionError(f"protocol bcl: pseudo-label rounds {kept}")
            out[method]["plabel_kept"] = kept
    out["ddfseg"]["resume_max_param_diff"] = resumed_step_diff(runs["ddfseg"], "ddfseg")
    out["seconds"] = time.perf_counter() - t0
    return out


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


# ---------------------------------------------------------------------------
# phase 7: serving
# ---------------------------------------------------------------------------
SERVE_BATCHES = (1, 5, 16)
# the artifact's labels against the live evaluator's (the JAX export
# script's smoke threshold), its probabilities within PROBS_ATOL (the same
# bf16 ops; cuDNN may pick other algorithms in another process)
LABEL_AGREEMENT = 0.999
PROBS_ATOL = 2e-3
# (PROBS_ATOL holds each batch size against the live model at that size:
# across sizes cuDNN's algorithms, and so bf16 rounding, differ)
# a consumer with PyTorch alone: neither the checkout nor slcl_torch on its
# path; it parses the header, loads the program and runs each batch size
CONSUMER = r"""
import importlib.util, io, json, struct, sys
import numpy as np, torch
assert importlib.util.find_spec("slcl_torch") is None, "slcl_torch is importable"
for name in sys.argv[1:]:
    raw = open(name + ".slclt", "rb").read()
    assert raw[:6] == b"SLCLT\x01", raw[:6]
    (n,) = struct.unpack(">I", raw[6:10])
    meta = json.loads(raw[10:10 + n])
    prog = torch.export.load(io.BytesIO(raw[10 + n:])).module()
    x = torch.from_numpy(np.load("images.npy")).to(meta["device"])
    for bs in (1, 5, 16):
        with torch.no_grad():
            out = prog(x[:bs])
        labels, probs = out if isinstance(out, tuple) else (out, None)
        np.save(f"{name}_{bs}_labels.npy", labels.cpu().numpy())
        if probs is not None:
            np.save(f"{name}_{bs}_probs.npy", probs.float().cpu().numpy())
assert not [m for m in sys.modules if m.startswith("slcl")]
print("consumer ok")
"""


# every CLI process started, stopped at the script's end if still running
STARTED: list = []


def start_cli(args, cwd: Path = ROOT, env=None) -> subprocess.Popen:
    """Start ``python <args>``, its stdout and stderr to files: several run
    at once (:func:`wait_cli` each)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, *args], cwd=cwd, env=env, stdout=out,
                            stderr=err, text=True)
    proc.files, proc.what = (out, err), " ".join(args[:3])
    STARTED.append(proc)
    return proc


def wait_cli(proc: subprocess.Popen, timeout: int = 900) -> str:
    """The stdout of a :func:`start_cli` process once it ends, or raise with
    its stderr (killed after ``timeout`` seconds)."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out, err = proc.files
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        raise AssertionError(f"{proc.what}: exit {proc.returncode}\n{stderr[-3000:]}")
    return stdout


def run_cli(args, cwd: Path = ROOT, env=None, timeout: int = 900) -> str:
    """Run ``python <args>`` to its end; its stdout, or raise with its stderr."""
    return wait_cli(start_cli(args, cwd, env), timeout)


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _throughput(fn, bs: int, n: int, crop: int, device, repeats: int = 5) -> list:
    """Images per second of ``fn`` on (bs, crop, crop, 3) inputs: a warm-up,
    then ``repeats`` runs of ``n`` batches, each ending in a synchronise;
    [min, median, max] over the runs."""
    import torch
    x = torch.randn(bs, crop, crop, 3, device=device)
    with torch.no_grad():
        for _ in range(5):
            fn(x)
        torch.cuda.synchronize()
        rates = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(n):
                fn(x)
            torch.cuda.synchronize()
            rates.append(bs * n / (time.perf_counter() - t0))
    rates.sort()
    return [rates[0], rates[len(rates) // 2], rates[-1]]


def _start_consumer(cell: Path, names) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return start_cli(["-c", CONSUMER, *names], cwd=cell, env=env)


def _consumer_results(cell: Path, names, proc: subprocess.Popen) -> dict:
    out = wait_cli(proc, timeout=600)
    if "consumer ok" not in out:
        raise AssertionError(f"serve consumer: {out[-500:]}")
    import numpy as np
    res = {}
    for name in names:
        for bs in SERVE_BATCHES:
            probs = cell / f"{name}_{bs}_probs.npy"
            res[name, bs] = (np.load(cell / f"{name}_{bs}_labels.npy"),
                             np.load(probs) if probs.exists() else None)
    return res


def _hold_artifact(res, name: str, labels, probs, crop: int) -> dict:
    """The consumer's outputs of artifact ``name`` against the live ones at
    the same batch size (``labels[bs]``, ``probs[bs]``): labels at >=
    LABEL_AGREEMENT of pixels, probabilities within PROBS_ATOL."""
    import numpy as np
    agree, perr = [], []
    for bs in SERVE_BATCHES:
        got_l, got_p = res[name, bs]
        if got_l.shape != (bs, crop, crop) or got_l.dtype != np.int32:
            raise AssertionError(f"serve {name} bs {bs}: labels {got_l.shape} {got_l.dtype}")
        a = float((got_l == labels[bs]).mean())
        if a < LABEL_AGREEMENT:
            raise AssertionError(f"serve {name} bs {bs}: labels agree at {a}")
        agree.append(a)
        if probs is not None:
            e = float(np.abs(got_p - probs[bs]).max())
            if not e <= PROBS_ATOL:
                raise AssertionError(f"serve {name} bs {bs}: probabilities off by {e}")
            perr.append(e)
    return {"label_agreement": agree, "probs_max_abs_err": perr or None}


def _live_labels(evaluator, images) -> dict:
    """``Evaluator.predict``'s labels of ``images[:bs]`` at each batch size."""
    return {bs: evaluator.predict([(images[:bs], images[:bs, ..., 0], None)])[0]
            for bs in SERVE_BATCHES}


def _live_probs(model, x, dtype: str) -> dict:
    """The live model's softmax probabilities of ``x[:bs]`` at each batch
    size of SERVE_BATCHES."""
    import torch
    from slcl_torch import serve
    infer = serve.make_infer_fn(model, with_probs=True, dtype=dtype)
    with torch.no_grad():
        return {bs: infer(x[:bs])[1].float().cpu().numpy() for bs in SERVE_BATCHES}


def start_export(work: Path, protocol: dict) -> subprocess.Popen:
    """Phase 7's export CLI, ``python -m slcl_torch.scripts.export ...
    smoke=1`` on phase 5's trained ``slcl`` DRUNet (bf16, on the card), into
    ``work/serve``: started as soon as phase 5 has trained it, and run beside
    the rest of phase 5 (:func:`wait_cli` in :func:`serve_phase`)."""
    cell = work / "serve"
    cell.mkdir()
    return start_cli(["-m", "slcl_torch.scripts.export", *serve_args(protocol),
                      f"out={cell / 'drunet.slclt'}", "smoke=1"])


def serve_args(protocol: dict) -> list:
    """The CLI arguments of phase 5's trained ``slcl`` run, restored from its
    best checkpoint, on this process's device."""
    import torch
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return [*protocol["slcl_args"], f"run.restore_from={protocol['slcl_best']}",
            "--device", dev]


def serve_phase(work: Path, protocol: dict, trees: dict, export: subprocess.Popen) -> dict:
    """Phase 7: the trained ``slcl`` DRUNet of phase 5 exported through the
    export CLI (``export``: :func:`start_export`) and with probabilities
    in-process, a full-width ResNet-50 U-Net from random init likewise; both
    served at batch 1, 5 and 16 by a process without slcl_torch and held to
    the live evaluator; the batch server on 57 of phase 6's PNGs at bs=16;
    ``predict`` against ``Trainer.eval`` (the three CLIs at once); images
    per second through the artifact and the live model."""
    import numpy as np
    import torch
    from slcl_torch import serve
    from slcl_torch.data import Loader
    from slcl_torch.train import __main__ as train_cli
    from slcl_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cell = work / "serve"
    best = protocol["slcl_best"]
    cfg, _, _ = train_cli.parse_args(protocol["slcl_args"], "slcl")
    trainer = Trainer(cfg)
    dev, crop = trainer.device, cfg.data.crop
    args = serve_args(protocol)
    printed = wait_cli(export)
    if "smoke ok" not in printed:
        raise AssertionError(f"export CLI: {printed[-500:]}")

    trainer.restore_checkpoint(best, params_only=True)
    test = trainer.datasets["test_t"]
    images = np.stack([test[i][0] for i in range(16)]).astype(np.float32)
    np.save(cell / "images.npy", images)
    loader = Loader(test, cfg.data.eval_bs, shuffle=False, drop_last=False, num_threads=1)
    labels = _live_labels(trainer.evaluator, images)
    # the evaluator over the test set (batches of eval_bs) against batches of 16
    split = trainer.evaluator.predict(loader)[0][:16]
    if len(np.unique(split)) < 2 or (split == labels[16]).mean() < LABEL_AGREEMENT:
        raise AssertionError(f"serve: the trained model's labels: classes {np.unique(split)}, "
                             f"agreement across batch sizes {(split == labels[16]).mean()}")
    model = trainer.evaluator.model
    t1 = time.perf_counter()
    exported = serve.export_segmentor(model, crop=crop, with_probs=True, dtype=cfg.model.dtype)
    export_s = time.perf_counter() - t1
    serve.save_artifact(cell / "drunet_probs.slclt", exported, {"crop": crop},
                        dtype=cfg.model.dtype)
    x = torch.from_numpy(images).to(dev)
    probs = _live_probs(model, x, cfg.model.dtype)

    rcfg, _, _ = train_cli.parse_args(["method=slcl", "model.backbone=resnet50",
                                       "model.multilvl=true", "data.dataset=synthetic",
                                       f"run.out_dir={work}"], "slcl")
    rtrainer = Trainer(rcfg)
    rmodel = rtrainer.evaluator.model
    t1 = time.perf_counter()
    rexported = serve.export_segmentor(rmodel, crop=crop, with_probs=True,
                                       dtype=rcfg.model.dtype)
    rexport_s = time.perf_counter() - t1
    serve.save_artifact(cell / "resnet50.slclt", rexported, {"crop": crop},
                        dtype=rcfg.model.dtype)
    rlabels = _live_labels(rtrainer.evaluator, images)
    rprobs = _live_probs(rmodel, x, rcfg.model.dtype)

    for a in ("drunet", "drunet_probs", "resnet50"):
        meta = serve.read_artifact(cell / f"{a}.slclt")[0]
        if (meta["device"], meta["dtype"]) != (dev.type, cfg.model.dtype):
            raise AssertionError(f"serve {a}: header {meta}")
    # the consumer, the batch server (57 PNGs, a ragged last batch of 9, at
    # bs=16) and predict, at once
    names = ("drunet", "drunet_probs", "resnet50")
    src = cell / "pngs"
    src.mkdir()
    pngs = sorted(Path(trees["mscmrseg"], "testB").glob("*.png"))[:57]
    for p in pngs:
        shutil.copy(p, src / p.name)
    consumer = _start_consumer(cell, names)
    server = start_cli(["-m", "slcl_torch.serve", str(cell / "drunet.slclt"), str(src),
                        str(cell / "masks"), "bs=16", "--device", dev.type])
    predict = start_cli(["-m", "slcl_torch.scripts.predict", *args,
                         f"out_dir={cell / 'pred'}"])
    want = trainer.eval("test_t")
    res = _consumer_results(cell, names, consumer)
    held = {"drunet": _hold_artifact(res, "drunet", labels, None, crop),
            "drunet_probs": _hold_artifact(res, "drunet_probs", labels, probs, crop),
            "resnet50": _hold_artifact(res, "resnet50", rlabels, rprobs, crop)}
    log(f"serve: artifacts agree with the live evaluator {held}")

    wait_cli(server)
    from slcl_torch.data.png import read_png_gray
    masks = sorted((cell / "masks").glob("*_pred.png"))
    if {m.name for m in masks} != {f"{p.stem}_pred.png" for p in pngs}:
        raise AssertionError(f"serve CLI: {len(masks)} masks for {len(pngs)} images")
    values = set()
    for m in masks:
        values |= set(np.unique(read_png_gray(m)).tolist())
    if not values <= {0, 60, 120, 180}:
        raise AssertionError(f"serve CLI: mask values {sorted(values)}")

    # predict: its table against Trainer.eval on the same weights
    printed = wait_cli(predict)
    pred = json.loads(printed.strip().splitlines()[-1])["test"]
    for k in ("dc", "hd", "asd"):
        close(torch.tensor(pred[k]), torch.tensor(want[k]), 0.0, 1e-6, f"predict {k}")
    if len(list((cell / "pred").glob("*_pred.png"))) != len(test):
        raise AssertionError("predict: a mask per test image")

    # images per second at 224x224: the artifact and the live model in turns
    fn, _ = serve.load_artifact(cell / "drunet.slclt", dev)
    live = serve.make_infer_fn(model, dtype=cfg.model.dtype)
    speed = {}
    for bs, n in ((1, 40), (16, 10)):
        speed[f"bs{bs}"] = {"artifact_img_per_s": _throughput(fn, bs, n, crop, dev),
                            "live_img_per_s": _throughput(live, bs, n, crop, dev),
                            "artifact_img_per_s_again": _throughput(fn, bs, n, crop, dev)}
    del trainer, rtrainer
    torch.cuda.synchronize()
    return {"card": card_line(), "seconds": time.perf_counter() - t0, "export_s": export_s,
            "resnet50_export_s": rexport_s,
            "artifact_mb": {p.stem: p.stat().st_size / 1e6 for p in cell.glob("*.slclt")},
            "classes_in_trained_labels": int(len(np.unique(split))),
            "held": held, "serve_cli_masks": len(masks), "serve_cli_values": sorted(values),
            "predict_dice": pred["dc"][0::2], "throughput": speed}


# ---------------------------------------------------------------------------
# phase 8: run utilities
# ---------------------------------------------------------------------------
# (cell, backbone, rtol, atol): the run without remat against the remat ones;
# resnet50_slcl's centre norms run away (ROADMAP queue 3 item 2), so its
# values are held relatively
# (cell, backbone, rtol, atol): the slcl multilvl cell, and mccl_rain (the
# MCCL preset with RAIN's ascent: a backward through the checkpointed
# forward for the sampling, then the update's)
REMAT_CELLS = (("slcl", "drunet", 1e-3, 1e-5), ("resnet50_slcl", "resnet50", 1e-2, 1e-6),
               ("mccl_rain", "drunet", 1e-3, 1e-5))
REMAT_TIMED = 5


def remat_cell(work: Path, name: str, backbone: str, rtol: float, atol: float) -> dict:
    """Two steps of a full-width cell (``slcl`` multilvl, or ``mccl_rain``:
    two epsilon iterations, a fresh sampling then the carried one, the
    ascent on) with ``model.remat`` off, ``full`` and ``dots`` from the same
    init and batches, under :func:`deterministic`: parameters, BatchNorm
    buffers, centres, the sampling and the metrics against the run without
    remat, the port kernels' launches, then REMAT_TIMED synchronised steps
    (cuDNN's default algorithms) and their peak."""
    import torch
    from slcl_torch.config import Config, apply_recipe
    from slcl_torch.data import device_prefetch
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.testing import configure_cell
    from slcl_torch.train.trainer import Trainer

    method = "mccl" if name == "mccl_rain" else "slcl"
    out, base = {}, None
    for mode in ("", "full", "dots"):
        cfg = configure_cell(apply_recipe(Config(method=method)), name)
        cfg.model.backbone, cfg.model.remat = backbone, mode
        cfg.model.multilvl = method == "slcl"
        cfg.data.dataset, cfg.run.out_dir = "synthetic", str(work)
        # the last mode's trainer is a reference cycle (its evaluator's
        # autocast closure): free it before reading what stays resident
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(cfg)
        batches = [b for _, b in zip(range(2), device_prefetch(trainer._epoch_batches(),
                                                              trainer.device))]
        scheds = cell_scheds(trainer, cfg)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        reset_launch_counts()
        # deterministic algorithms (phase 10's reason): with cuDNN's default
        # choice mccl_rain's full and dots part from off at the sampling
        with deterministic():
            for b, sched in zip(batches, scheds):
                metrics = trainer.step_fn(trainer.state, b, sched)
        counts = launch_counts()
        for kname, per in PER_METHOD[name if name == "mccl_rain" else "slcl"].items():
            if counts[kname] != 2 * per:
                raise AssertionError(f"remat {name} {mode or 'off'}: {kname} launched "
                                     f"{counts[kname]} times in 2 steps")
        if name == "mccl_rain" and not float(metrics["eps_step_norm"]) > 0:
            raise AssertionError(f"remat {name} {mode or 'off'}: the ascent did not run")
        state = {**{f"seg.{k}": v.detach().clone()
                    for k, v in trainer.state.seg.state_dict().items()},
                 "centroids": trainer.state.centroids.clone(),
                 **{f"metric.{k}": v.reshape(1) for k, v in metrics.items()}}
        if trainer.state.sampling is not None:
            state["sampling"] = trainer.state.sampling.clone()
        err = 0.0
        if base is None:
            base = state
        else:
            for k, v in base.items():
                err = max(err, close(state[k], v, rtol, atol, f"remat {name} {mode} {k}"))
        # the peak of the timed steps: the deterministic algorithms take
        # other workspaces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(REMAT_TIMED):
            trainer.step_fn(trainer.state, batches[i % 2], scheds[1])
        torch.cuda.synchronize()
        out[mode or "off"] = {"step_ms": (time.perf_counter() - t0) / REMAT_TIMED * 1e3,
                              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                              "peak_above_resident_gb":
                                  (torch.cuda.max_memory_allocated() - resident) / 1e9,
                              "max_abs_diff_vs_off": err, "launches": counts}
        del trainer, batches
    log(f"remat {name}: {out}")
    return out


def profile_run(work: Path) -> dict:
    """A two-epoch full-width ``slcl`` run with ``run.profile_dir``: the
    second epoch's trace exists, parses, and names the port's kernels of
    mpcl.cu, mpcl_pseudo.cu and soft_centroids.cu among its device events."""
    from slcl_torch.config import Config, apply_recipe
    from slcl_torch.train.trainer import Trainer

    cfg = apply_recipe(Config(method="slcl"))
    cfg.model.multilvl, cfg.data.dataset, cfg.optim.epochs = True, "synthetic", 2
    prof = work / "prof"
    cfg.run.out_dir, cfg.run.profile_dir = str(work), str(prof)
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    trainer.train()
    traces = list(prof.glob("trace_*.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile: {len(traces)} traces under {prof}")
    t1 = time.perf_counter()
    events = json.loads(traces[0].read_text())["traceEvents"]
    parse_s = time.perf_counter() - t1
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {src: sum(any(p in k for p in PORT_KERNELS[src]) for k in kernels)
             for src in ("mpcl", "mpcl_pseudo", "soft_centroids")}
    if not all(found.values()):
        raise AssertionError(f"profile: port kernels in the trace {found}")
    epochs = [r["epoch_time_s"] for r in trainer.history]
    return {"seconds": time.perf_counter() - t0, "trace_mb": traces[0].stat().st_size / 1e6,
            "parse_s": parse_s, "device_kernel_events": len(kernels),
            "port_kernel_events": found, "epoch_time_s": epochs,
            "tb_written": (trainer.out_dir / "tb").exists()}


def data_tools(work: Path) -> dict:
    """The offline tools through their CLI on the MMWHS fixture tree, and one
    augmented batch each of the legacy bSSFP / LGE datasets on the MS-CMRSeg
    fixture tree: no cv2 or pandas on this host."""
    import numpy as np
    from slcl_torch.data import Loader
    from slcl_torch.data.legacy import BSSFPDataset, LGEDataset

    fix = ROOT / "tests" / "fixtures"
    out_dir = work / "pre"
    out_dir.mkdir()
    t0 = time.perf_counter()
    # the two CLIs at once
    minmax = start_cli(["-m", "slcl_torch.data.preprocess", "minmax-csv", "--data_dir",
                        str(fix / "mini_mmwhs"), "--modality", "CT", "--out_dir", str(out_dir)])
    to_png = start_cli(["-m", "slcl_torch.data.preprocess", "nii-to-png-mmwhs", "--data_dir",
                        str(fix / "mini_mmwhs"), "--out", str(out_dir / "png"),
                        "--modality", "MR"])
    printed = wait_cli(minmax)
    if (out_dir / "CTminmax99.csv").read_bytes() != (fix / "mini_mmwhs" / "CTminmax99.csv"
                                                      ).read_bytes():
        raise AssertionError(f"minmax-csv: {printed}")
    wait_cli(to_png)
    n_png = len(list((out_dir / "png").glob("*.png")))
    if n_png != len(list((fix / "mini_mmwhs" / "MR_woGT").glob("*.nii"))):
        raise AssertionError(f"nii-to-png-mmwhs: {n_png} PNGs")
    shapes = {}
    for name, ds in (("bssfp", BSSFPDataset(str(fix / "mini_mscmrseg"), augmentation=True)),
                     ("lge", LGEDataset(str(fix / "mini_mscmrseg"), pat_id=6,
                                        augmentation=True, virtual_len=4))):
        batch = next(iter(Loader(ds, 2, num_threads=1)))
        if not all(np.isfinite(b).all() for b in batch[:-1]):
            raise AssertionError(f"{name}: non-finite batch")
        shapes[name] = [list(b.shape) for b in batch[:-1]]
    bad = [m for m in ("cv2", "pandas", "PIL") if m in sys.modules]
    if bad:
        raise AssertionError(f"data tools imported {bad}")
    return {"seconds": time.perf_counter() - t0, "mmwhs_pngs": n_png, "batch_shapes": shapes}


def run_utils_phase(work: Path) -> dict:
    """Phase 8: ``model.remat`` on two full-width cells, the profiler trace
    of a two-epoch run, and the offline data tools."""
    t0 = time.perf_counter()
    remat = {name: remat_cell(work, name, bb, rtol, atol)
             for name, bb, rtol, atol in REMAT_CELLS}
    out = {"card": card_line(), "remat": remat, "profile": profile_run(work),
           "data_tools": data_tools(work)}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 9: data parallelism
# ---------------------------------------------------------------------------
def one_call(src: str, *args):
    """A forward through its one-call C entry (``soft_centroids_fwd``,
    ``mpcl_fwd``, ``mpcl_pseudo_fwd``), which launches both kernels; the
    wrappers take the two-call entries. Returns what the wrapper returns."""
    import ctypes
    import torch
    from slcl_torch.ops.cuda import build, ptr, raise_on_error, stream_of
    mod = importlib.import_module(f"slcl_torch.ops.cuda.{src}")
    lib = build.load(src, mod._SIGS)
    feats = args[0]
    dev, bf16, n = feats.device, int(feats.dtype == torch.bfloat16), ctypes.c_int()
    f32 = dict(dtype=torch.float32, device=dev)
    if src == "soft_centroids":
        probs, a, P, thd, weighted, std = args[1:]
        m, f = feats.shape
        raise_on_error(lib.soft_centroids_partials_size(bf16, m, f, P, C, int(std),
                                                        ctypes.byref(n)), src)
        out = [torch.empty((P, C, f), **f32), torch.empty(P * C, **f32),
               torch.empty((), **f32)] + ([torch.empty(C, **f32), torch.empty((C, f), **f32)]
                                          if std else [None, None])
        raise_on_error(lib.soft_centroids_fwd(
            ptr(feats), bf16, ptr(probs), ptr(a), m, f, C, P, float(thd), int(weighted),
            ptr(torch.empty(n.value, **f32)), *map(ptr, out[:3]), ptr(out[4]), ptr(out[3]),
            stream_of(feats)), src)      # out: cents, counts, ratio, std, s2
        return tuple(out[:5] if std else out[:3])
    raise_on_error(getattr(lib, f"{src}_num_partials")(bf16, *feats.shape,
                                                       ctypes.byref(n)), src)
    stats = torch.empty(3, **f32)
    raise_on_error(getattr(lib, f"{src}_fwd")(
        *mod._args(*args), ptr(torch.empty(2 * n.value, **f32)), ptr(stats),
        stream_of(feats)), src)
    return stats


def split_entries() -> dict:
    """The forwards' two-call entries at the main shape, as the wrappers
    launch them: bit-identical to the one-call entry; and with the rows in
    two halves, the first half's partials added to the second's, against the
    one-call entry on all rows (phase 2's tolerances). Returns the max
    errors."""
    import torch
    from slcl_torch.ops.cuda import mpcl as K_mpcl, mpcl_pseudo as K_mp
    from slcl_torch.ops.cuda import soft_centroids as K_sc
    g = torch.Generator(device="cuda").manual_seed(9)
    dev = torch.device("cuda")
    feats = torch.randn(M, F, generator=g, device=dev).to(torch.bfloat16)
    probs = torch.softmax(3 * torch.randn(M, C, generator=g, device=dev), -1)
    assign = torch.randint(0, 2, (M,), generator=g, device=dev, dtype=torch.int32)
    labels = torch.randint(0, C, (M,), generator=g, device=dev, dtype=torch.int32)
    sel = (torch.rand(M, generator=g, device=dev) > 0.3).float()
    cen = torch.nn.functional.normalize(torch.randn(C, F, generator=g, device=dev), dim=1)
    h = M // 2
    out = {}

    def halves(call, cut):
        """call(rows, reduce, m_total) on each half, the first's partials
        added to the second's before its final pass."""
        kept = []
        call(cut(0, h), lambda t: kept.append(t.clone()), M)
        return call(cut(h, M), lambda t: t.add_(kept[0]), M)

    for P, std in ((1, False), (2, False), (2, True)):
        tag = f"soft_centroids P={P}" + (" std" if std else "")
        a = assign if P > 1 else None

        def call(rows, reduce=None, m_total=0):
            f, p, aa = rows
            return K_sc.soft_centroids_fwd_cuda(f, p, aa, P, 0.9, True, std,
                                                reduce=reduce, m_total=m_total)
        one = call((feats, probs, a))
        fused = one_call("soft_centroids", feats, probs, a, P, 0.9, True, std)
        if not all(torch.equal(x, y) for x, y in zip(one, fused)):
            raise AssertionError(f"{tag}: two-call entry differs from the one-call one")
        two = halves(call, lambda i, j: (feats[i:j], probs[i:j],
                                         None if a is None else a[i:j]))
        out[tag] = {"cents": close(two[0], one[0], 1e-4, 1e-5, tag + " cents"),
                    "ratio": close(two[2], one[2], 1e-5, 0.0, tag + " ratio")}
        if std:
            out[tag]["std"] = close(two[3], one[3], 1e-4, 1e-5, tag + " std")
    T, scale = 0.1, 0.1
    for s_ in (None, sel):
        tag = "mpcl_fwd" + (" sel" if s_ is not None else "")

        def call(rows, reduce=None, m_total=0):
            f, lab, ss = rows
            return K_mpcl.mpcl_fwd_cuda(f, lab, cen, ss, T, 0.4, False, scale,
                                        reduce=reduce, m_total=m_total)
        one = call((feats, labels, s_))
        if not torch.equal(one, one_call("mpcl", feats, labels, cen, s_, T, 0.4, False,
                                         scale)):
            raise AssertionError(f"{tag}: two-call entry differs from the one-call one")
        two = halves(call, lambda i, j: (feats[i:j], labels[i:j],
                                         None if s_ is None else s_[i:j]))
        out[tag] = close(two, one, 1e-4, 0.0, tag)

    def call(f, reduce=None, m_total=0):
        return K_mp.mpcl_pseudo_fwd_cuda(f, cen, T, 0.2, False, scale, 0.25, reduce=reduce)
    one = call(feats)
    if not torch.equal(one, one_call("mpcl_pseudo", feats, cen, T, 0.2, False, scale, 0.25)):
        raise AssertionError("mpcl_pseudo_fwd: two-call entry differs from the one-call one")
    out["mpcl_pseudo_fwd"] = close(halves(call, lambda i, j: feats[i:j]), one, 1e-4, 0.0,
                                   "mpcl_pseudo_fwd")
    return out


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_config(work: Path, method: str, fsdp: bool = False, dtype: str = "",
              spatial: bool = False):
    """The full-width ``slcl`` multilvl cell or the ``mccl`` preset; with
    ``spatial`` its image rows split over two model ranks."""
    from slcl_torch.config import Config, apply_recipe
    cfg = Config()
    cfg.method = method
    cfg = apply_recipe(cfg)
    cfg.model.multilvl = method == "slcl"
    cfg.mesh.fsdp = fsdp
    if spatial:
        cfg.mesh.model_axis, cfg.mesh.spatial = 2, True
    if dtype:
        cfg.model.dtype = dtype
    cfg.data.dataset = "synthetic"
    cfg.optim.epochs = 1
    cfg.run.out_dir = str(work)
    return cfg


# phase 9(b)'s cells beyond DRUNet's two, at phase 3's sizes
# (slcl_torch.testing.SPATIAL_CELLS)
SMOKE_DP = ("mccl_rain_mulstyle",)
# phase 9(c)'s cells beyond DRUNet's slcl: the paper's cell, MCCL + RAIN and
# DDFSeg at full width, the others at phase 3's sizes
SMOKE_SPATIAL = ("resnet50_slcl", "mccl_rain", "drunet_mccl", "unet_baseline",
                 "deeplabv2_advent", "slcl_remat_full", "rain_seg", "ddfseg",
                 "adaptevery_small", "bcl_small")
FULL_WIDTH = ("resnet50_slcl", "mccl_rain", "ddfseg")
# a cell's data settings beside its config's: DDFSeg at full width on a
# global batch of 4 + 4 (a gloo rank's step takes 5 s); AdaptEvery's and
# BCL's shallow nets at phase 3's 64x64 (SCAN_SMALL's rows), BCL on four
# images, so that its reversed-images run (image 0 kept first: its metric
# loss reads it) sums in another order
CELL_DATA = {"ddfseg": {"bs": 4}, "adaptevery_small": {"crop": 64},
             "bcl_small": {"crop": 64, "bs": 4}}


def cell_config(work: Path, cell: str, spatial: bool = False):
    """(cfg, shallow segmentor kind) of a phase 9 cell in f32: DRUNet's
    ``slcl`` and ``mccl`` (:func:`dp_config`) or one of ``SPATIAL_CELLS``
    (with its ``CELL_RAIN`` settings); with ``spatial`` its image rows split
    over two model ranks."""
    from slcl_torch.testing import SPATIAL_CELLS, configure_cell
    if cell not in SPATIAL_CELLS:
        return dp_config(work, cell, dtype="float32", spatial=spatial), ""
    method, _, shallow = SPATIAL_CELLS[cell]
    if cell in FULL_WIDTH:
        cfg = dp_config(work, method, dtype="float32", spatial=spatial)
    else:
        cfg = small_config(method)
        cfg.mesh.model_axis, cfg.mesh.spatial = (2, True) if spatial else (1, False)
        cfg.optim.epochs = 1
        cfg.run.out_dir = str(work)
    for k, v in CELL_DATA.get(cell, {}).items():
        setattr(cfg.data, k, v)
    return configure_cell(cfg, cell), shallow


def cell_method(cell: str) -> str:
    from slcl_torch.testing import SPATIAL_CELLS
    return SPATIAL_CELLS[cell][0] if cell in SPATIAL_CELLS else cell


def cell_scheds(trainer, cfg) -> list:
    """The two steps' scheds of a phase 9 cell: the Trainer's epoch 0; with
    RAIN's ascent (``rain.update_eps``) a fresh sampling, then the carried
    one, the ascent on in both (two epsilon iterations, on the two batches)."""
    sched = trainer._sched(0)
    if not cfg.rain.update_eps:
        return [sched, sched]
    return [{**sched, "fresh": 1.0, "eps_on": 1.0}, {**sched, "fresh": 0.0, "eps_on": 1.0}]


def reversed_order(cfg, n: int) -> list:
    """The image order of the reversed-images run (``flip``): all ``n``
    reversed, or with RAIN (the stylised pair is the batch's first images)
    and BCL (its metric loss reads the first image of each domain) image 0
    kept first and the rest reversed."""
    first = cfg.rain.enabled or cfg.method in ("rain", "bcl")
    return [0] + list(range(n - 1, 0, -1)) if first else list(range(n - 1, -1, -1))


def permuted_dropout(trainer, order):
    """DDFSeg's and AdaptEvery's ``draw_dropout`` for images in ``order``:
    the step's own masks of the unpermuted batch (seeded by the state's seed
    and step), each image's mask moved with it."""
    import torch
    from slcl_torch.train.steps_extra import dropout_draw
    from slcl_torch.train.steps import Generators
    gens, s = Generators(), trainer.state

    def draw(step, path, call, shape, keep, device):
        mask = dropout_draw(gens, s.seed, step, path, call, shape, keep, device)
        return mask.index_select(0, torch.tensor(order, device=device))
    return draw


def permuted_draw(trainer, order):
    """MCCL's ``draw_assign`` for images in ``order``: the step's own rMC
    draw of the unpermuted batch (seeded by the state's seed and step),
    each image's ids moved with it, so the reversed images take the same
    partitions pixel by pixel."""
    import torch
    from slcl_torch.train.steps import Generators, rmc_draw
    gens, s = Generators(), trainer.state

    def draw(m: int, P: int, device):
        ids = rmc_draw(gens, s.seed, s.step, m, P, device)
        return ids.view(len(order), -1)[torch.tensor(order, device=device)].reshape(-1)
    return draw


def state_of(trainer) -> dict:
    """Every network's whole state, the centres and the step, on the card."""
    from slcl_torch.parallel import mesh as dp
    from slcl_torch.train.trainer import _NETS
    s = trainer.state
    out = {f"{n}/{k}": v.detach().clone() for n in _NETS if getattr(s, n) is not None
           for k, v in dp.full_state_dict(getattr(s, n)).items()}
    if s.centroids is not None:
        out["centroids"] = s.centroids.detach().clone()
    if s.sampling is not None:
        out["sampling"] = s.sampling.detach().clone()
    return out


def dp_steps(trainer, batches, sched, mesh) -> tuple:
    """Two steps of ``trainer`` under ``mesh``: (metrics of each, launches)."""
    import torch
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.parallel import mesh as dp
    reset_launch_counts()
    metrics = []
    with dp.use(mesh):
        for b in batches:
            metrics.append({k: v.clone() for k, v in trainer.step_fn(trainer.state, b,
                                                                     sched).items()})
    torch.cuda.synchronize()
    return metrics, launch_counts()


def step_ms(trainer, batches, sched, mesh, n: int = 10) -> float:
    """Mean wall time of ``n`` back-to-back steps (one sync at the end)."""
    import torch
    from slcl_torch.parallel import mesh as dp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dp.use(mesh):
        for i in range(n):
            trainer.step_fn(trainer.state, batches[i % len(batches)], sched)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def dp_one_rank(work: Path, mesh, method: str, fsdp: bool) -> dict:
    """(a): the plain Trainer and the Trainer under the one-rank NCCL mesh,
    from the same seed, two steps on the same batches: bit for bit."""
    import torch
    from slcl_torch.data import device_prefetch
    from slcl_torch.parallel import mesh as dp
    from slcl_torch.train.trainer import Trainer
    plain = Trainer(dp_config(work, method, fsdp))
    with dp.use(mesh):
        ranked = Trainer(dp_config(work, method, fsdp))
    if ranked.mesh is not mesh:
        raise AssertionError("the Trainer did not take the mesh")
    batches = []
    for b in device_prefetch(plain._epoch_batches(), plain.device):
        batches.append(b)
        if len(batches) == 2:
            break
    sched = plain._sched(0)
    m_plain, c_plain = dp_steps(plain, batches, sched, None)
    m_rank, c_rank = dp_steps(ranked, batches, sched, mesh)
    per = PER_METHOD[method]
    for counts, who in ((c_plain, "plain"), (c_rank, "mesh")):
        for k, v in per.items():
            if counts[k] != 2 * v:
                raise AssertionError(f"parallel {method} {who}: {k} launched {counts[k]} "
                                     f"times in 2 steps, expected {2 * v}")
    for i, (a, b) in enumerate(zip(m_plain, m_rank)):
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        if diff:
            raise AssertionError(f"parallel {method} step {i}: metrics differ: {diff}")
    sa, sb = state_of(plain), state_of(ranked)
    diff = [k for k in sa if not torch.equal(sa[k], sb[k])]
    if diff:
        raise AssertionError(f"parallel {method}: state differs: {diff[:8]}")
    # ten steps of each, in the order plain, mesh, mesh, plain
    times = {"plain": [], "mesh": []}
    for who in ("plain", "mesh", "mesh", "plain"):
        t, m_ = (plain, None) if who == "plain" else (ranked, mesh)
        times[who].append(step_ms(t, batches, sched, m_, n=10))
    rec = {"bit_identical": True, "launches_per_step": {k: c_rank[k] / 2 for k in per},
           "plain_step_ms": times["plain"], "mesh_step_ms": times["mesh"],
           "fsdp": fsdp, "sharded_params": sum(
               1 for p in ranked.state.seg.parameters() if dp.is_dtensor(p))}
    del plain, ranked, batches
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def two_rank_entry(mesh, method: str, work: str, d_step: str = "",
                   flip: bool = False, carry: str = "", ulp: bool = False,
                   plabels: str = "") -> dict:
    """(b) and (c), in each rank (and with ``mesh`` None in one process):
    two f32 steps of the cell ``method`` (:func:`cell_config`; the
    full-width ones on the first global batch of 16 rows, this rank's 8,
    under a spatial mesh its band of 112 rows of all 16); metrics, the
    state after each step (on the host), launches, each network's
    first-step gradient as its optimizer receives it (summed over the
    ranks), the first ``d_main`` update's inputs, and the ms of the second
    step (synchronised before and after). With ``d_step`` (a file of such
    inputs), also :func:`disc_update_f64`; with ``flip``, each batch's images in reverse order (the same step, its sums
    over the images in another order); with ``ulp``, every image one
    float32 ulp up (the same step on inputs a rounding apart); with ``carry`` (a file of the one
    process's sampling after its first iteration), RAIN's second iteration
    starts from that sampling, so that it is compared on the same inputs.
    BCL runs a pseudo-label round first (whole images on every rank) and
    steps on the round's labels, with ``plabels`` (the one process's round,
    on file) on those; its record says whether its own round gave them."""
    import torch
    from slcl_torch.data import device_prefetch
    from slcl_torch.ops.cuda import build, launch_counts, reset_launch_counts
    from slcl_torch.parallel import mesh as dp
    from slcl_torch.train import steps as S
    from slcl_torch.train.trainer import _OPTS, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()       # built by the parent: loads the libraries
    spatial = mesh is not None and mesh.spatial
    cfg, shallow = cell_config(Path(work), method, spatial)
    with dp.use(mesh):
        trainer = Trainer(cfg, device=torch.device("cuda", torch.cuda.current_device()))
    if shallow:
        # seeded alike on every rank and in the one process
        use_segmentor(trainer, small_segmentor(shallow, cfg, trainer.device))
    s = trainer.state
    plabel_round = None
    if cfg.method == "bcl":
        import numpy as np
        kept = trainer.bcl_update_plabels(cfg.run.bcl_prop)
        plabel_round = {"kept": kept, "labels": dict(trainer.bcl_plabels)}
        if plabels:
            trainer.bcl_plabels = torch.load(plabels, weights_only=False)
            own = plabel_round.pop("labels")
            plabel_round["same_as_one_process"] = all(
                np.array_equal(v, trainer.bcl_plabels[k]) for k, v in own.items())
    batches = []
    for b in device_prefetch(trainer._epoch_batches(), trainer.device):
        batches.append(b)
        if len(batches) == 2:
            break
    scheds = cell_scheds(trainer, cfg)
    if flip:
        order = reversed_order(cfg, int(batches[0]["img_s"].shape[0]))
        idx = torch.tensor(order, device=trainer.device)
        batches = [{k: v.index_select(0, idx) for k, v in b.items()} for b in batches]
        if cfg.method == "mccl":
            trainer.step_fn = S.build_step(cfg, trainer.centroids_loaded,
                                           draw_assign=permuted_draw(trainer, order))
        if cfg.method in ("ddfseg", "adaptevery"):
            trainer.step_fn = S.build_step(cfg, draw_dropout=permuted_dropout(trainer, order))
    if ulp:
        batches = [{k: torch.nextafter(v, torch.full_like(v, math.inf))
                    if k.startswith("img") else v for k, v in b.items()} for b in batches]
    grads, first = {}, {}

    def first_grads(name):
        def hook(opt, args, kwargs):
            if name not in grads:
                grads[name] = [p.grad.detach().float().cpu().clone()
                               for g in opt.param_groups for p in g["params"]]
        return hook
    # the segmentor's where its gradient is held (FLOOR_HELD)
    for name in _OPTS:
        if getattr(s, name, None) is not None and (name != "opt_seg" or method in FLOOR_HELD):
            getattr(s, name).register_step_pre_hook(first_grads(name))
    # the entries whose moves are compared: the discriminators', and an Adam
    # generator's parameters (ADAM_SEG)
    adam_seg = method in ADAM_SEG
    init = {k: v.cpu() for k, v in state_of(trainer).items()
            if k.startswith("d_") or (adam_seg and k.startswith("seg/") and not is_buffer(k))}
    d_update = S._d_update
    # MPCL's fault on exactly-zero feature rows (ROADMAP queue 3 item 2):
    # the rows of each forward's dcdr_ft with a zero norm
    zero_rows = []
    hook = s.seg.register_forward_hook(lambda m, i, o: zero_rows.append(
        int((o.dcdr_ft.float().norm(dim=-1) == 0).sum())) if hasattr(o, "dcdr_ft") else None)

    def recorded(disc, opt, lr, pred_s, pred_t, kind, amp):
        if disc is s.d_main and not first:
            first.update(pred_s=pred_s.detach().cpu().clone(),
                         pred_t=pred_t.detach().cpu().clone(), kind=kind, lr=lr,
                         n_class=int(pred_s.shape[-1]),
                         init={k: v.detach().cpu().clone()
                               for k, v in s.d_main.state_dict().items()})
        return d_update(disc, opt, lr, pred_s, pred_t, kind, amp)
    S._d_update = recorded
    reset_launch_counts()
    metrics, first_state = [], None
    try:
        with dp.use(mesh):
            for b, sched in zip(batches, scheds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics.append({k: float(v) for k, v in trainer.step_fn(s, b,
                                                                         sched).items()})
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if first_state is None:
                    first_state = {k: v.cpu() for k, v in state_of(trainer).items()}
                    if carry:
                        s.sampling.copy_(torch.load(carry).to(s.sampling.device))
        torch.cuda.synchronize()
    finally:
        S._d_update = d_update
        hook.remove()
    out = {"metrics": metrics, "launches": launch_counts(), "first_state": first_state,
           "zero_feature_rows": zero_rows,
           "rows": int(batches[0]["img_s"].shape[0]),
           "image_rows": int(batches[0]["img_s"].shape[1]),
           "state": {k: v.cpu() for k, v in state_of(trainer).items()},
           "init": init, "lr_dis": scheds[0]["lr_dis"], "first_grads": grads,
           "adam_seg": adam_seg, "step_ms": ms,
           "d_step": first, "plabel_round": plabel_round}
    if d_step:
        out["disc_f64"] = disc_update_f64(mesh, d_step)
    return out


def cells_entry(mesh, cells, work: str, files: dict) -> dict:
    """:func:`two_rank_entry` of each cell in turn, in one set of ranks, with
    its ``files`` (``d_step``, ``carry``: :func:`one_process`)."""
    import torch
    out = {}
    for cell in cells:
        out[cell] = two_rank_entry(mesh, cell, work, **files.get(cell, {}))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def disc_update_f64(mesh, path: str) -> dict:
    """The main path's first ``d_main`` update (``train/steps.py::_d_update``:
    the BCE's global means, ``net_update``'s share and ``reduce_grads``)
    redone in float64 on the card from the one process's recorded inputs
    and initial weights, on this rank's rows: its summed gradients (on the
    host); in one process also the norms of the source and the target
    terms' gradients, whose near cancellation turns float32 rounding of the
    inputs into a larger error of their sum."""
    import contextlib

    import torch
    from slcl_torch.models import UncertaintyDiscriminator
    from slcl_torch.ops import losses as L
    from slcl_torch.parallel import mesh as dp
    from slcl_torch.train import steps as S
    rec = torch.load(path, weights_only=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    d = UncertaintyDiscriminator(rec["n_class"]).to(dev, torch.float64)
    d.load_state_dict(rec["init"])
    opt = torch.optim.Adam(d.parameters(), lr=rec["lr"])
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.extend(
        p.grad.detach().cpu().clone() for p in d.parameters()))
    with dp.use(mesh):
        # this rank's rows (under a spatial mesh, its band of their rows)
        ps, pt = (dp.spatial_rows(dp.local_rows(rec[k].to(dev, torch.float64)))
                  for k in ("pred_s", "pred_t"))
        S._d_update(d, opt, rec["lr"], ps, pt, rec["kind"], contextlib.nullcontext())
    out = {"grads": grads}
    if mesh is None:
        d.load_state_dict(rec["init"])
        params = list(d.parameters())
        norms = []
        for pred, target in ((ps, 1.0), (pt, 0.0)):
            loss = 0.5 * L.bce_with_logits(d(S._d_input(pred, rec["kind"])), target)
            g = torch.autograd.grad(loss, params)
            norms.append(float(torch.linalg.vector_norm(torch.cat([x.flatten() for x in g]))))
        total = float(torch.linalg.vector_norm(torch.cat([x.flatten() for x in grads])))
        out["cancellation"] = total / sum(norms)
    return out


def grad_rel_err(got, want, what: str) -> float:
    """A gradient tensor held as the CPU tests hold gradients: elementwise
    rtol 1e-4 with an atol of 1e-5 of its largest entry, and its error's
    norm within 1e-4 of its norm; returns that norm ratio."""
    import torch
    scale = float(want.abs().max())
    bad = (got - want).abs() > 1e-5 * scale + 1e-4 * want.abs()
    rel = float(torch.linalg.vector_norm(got - want) /
                max(float(torch.linalg.vector_norm(want)), 1e-30))
    if bool(bad.any()) or rel > 1e-4:
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} entries off, "
                             f"error norm {rel:.3g} of the norm")
    return rel


def norm_rel_err(got, want) -> float:
    import torch
    return float(torch.linalg.vector_norm(got - want) /
                 max(float(torch.linalg.vector_norm(want)), 1e-30))


def one_process(work: Path, method: str) -> tuple:
    """The one-process side of (b) and (c): two steps of the cell, and its
    first discriminator update's inputs on file (the ranks
    redo it in float64); with RAIN its sampling after the first iteration
    on file (the ranks' second iteration starts from it); for a cell of
    :data:`LATER_FACTOR` or :data:`FLOOR_HELD` also its two steps on the
    images in reverse order (``floor``, from the same sampling at the
    second), and for one of :data:`FLOOR_HELD` on the images one float32
    ulp up (``ulp_floor``); (its record, the files for
    :func:`two_rank_entry`)."""
    import torch
    want = two_rank_entry(None, method, str(work))
    files = {}
    if want["plabel_round"] is not None:
        files["plabels"] = str(work / f"plabels_{method}.pt")
        torch.save(want["plabel_round"].pop("labels"), files["plabels"])
    if "sampling" in want["first_state"]:
        files["carry"] = str(work / f"carry_{method}.pt")
        torch.save(want["first_state"]["sampling"], files["carry"])
    if method in LATER_FACTOR or method in FLOOR_HELD:
        want["floor"] = two_rank_entry(None, method, str(work), flip=True, **files)
    if method in FLOOR_HELD:
        want["ulp_floor"] = two_rank_entry(None, method, str(work), ulp=True, **files)
    if want["d_step"]:
        files["d_step"] = str(work / f"d_step_{method}.pt")
        torch.save(want["d_step"], files["d_step"])
        want["disc_f64"] = disc_update_f64(None, files["d_step"])
    gc.collect()
    torch.cuda.empty_cache()
    return want, files


def tol_ratio(got, want, rtol: float, atol: float) -> float:
    """The largest |got - want| / (atol + rtol |want|) (inf where a value is
    not finite): at most 1 within tolerance."""
    import torch
    got, want = got.double(), want.double()
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        return math.inf
    return float(((got - want).abs() / (atol + rtol * want.abs())).max()) if got.numel() else 0.0


def metric_ratio(got: float, want: float) -> float:
    """A metric's error over (b)'s tolerance (rel 1e-5, abs 1e-6; inf where
    either is not finite)."""
    r = abs(got - want) / max(1e-5 * abs(want), 1e-6)
    return r if math.isfinite(r) else math.inf


# RAIN's ascent and pixel-count diagnostics on the card, held at phase 3's
# RAIN tolerance (card against CPU, ``close(..., 5e-3, 1e-4)``): the new
# sampling and the step's norm come from a float32 gradient through the
# segmentor, the style decoder and fc_decoder, whose sums in another order
# part by up to 1e-3 relative (full-width mccl_rain: the one process on the
# reversed images 9.2 times (b)'s tolerance on eps_step_norm and 6.5 times
# on the sampling after the first iteration; the bands 100 and 49 times;
# PERF.md §6); the hard Dice and the histogram distance count pixels, which
# a rounding-level tie moves from one class or bin to the next
RAIN_TOL = (5e-3, 1e-4)
RAIN_METRICS = ("eps_step_norm", "sampling_norm", "style_hist_d", "dice_")


def step_ratios(got: dict, want: dict, i: int) -> tuple:
    """Step ``i`` of the :func:`two_rank_entry` record ``got`` against
    ``want``'s at (b)'s tolerances: (the largest error over tolerance of the
    metrics, the segmentor and centres (``seg``) and the discriminators,
    and of RAIN's sampling and ascent metrics (``rain``, :data:`RAIN_TOL`);
    the worst ``seg`` entry, each entry's max abs error). Adam's first
    steps move a parameter whose gradient is rounding noise by up to lr_dis
    each: the discriminators' states are held to 2 lr_dis a step, their
    gradients by the float64 update (:func:`disc_update_f64`). An
    :data:`ADAM_SEG` generator's parameters are not held entry by entry
    (Adam moves each by about lr, whatever its gradient): its first-step
    gradient and its move are (:func:`hold_cell`)."""
    import torch
    g_state, w_state = ((got["first_state"], want["first_state"]) if i == 0
                        else (got["state"], want["state"]))
    ratio, rain = {"metrics": 0.0}, []
    for k, w in want["metrics"][i].items():
        g = got["metrics"][i][k]
        if k.startswith(RAIN_METRICS):
            r = abs(g - w) / (RAIN_TOL[1] + RAIN_TOL[0] * abs(w))
            rain.append(r if math.isfinite(r) else math.inf)
        else:
            ratio["metrics"] = max(ratio["metrics"], metric_ratio(g, w))
    if "sampling" in w_state:
        rain.append(tol_ratio(g_state["sampling"], w_state["sampling"], *RAIN_TOL))
    if rain:
        ratio["rain"] = max(rain)
    top, err = None, {}
    for k, w in w_state.items():
        g = g_state[k]
        if not torch.is_floating_point(w):
            # step counters and the like: equal or failed
            ratio["exact"] = max(ratio.get("exact", 0.0), 0.0 if torch.equal(g, w) else math.inf)
            continue
        err[k] = float((g.double() - w.double()).abs().max())
        if k == "sampling" or (want["adam_seg"] and k.startswith("seg/") and not is_buffer(k)):
            continue
        d = k.startswith("d_")
        part = "disc" if d else "seg"
        t = tol_ratio(g, w, 0.0 if d else 1e-4, 2 * (i + 1) * want["lr_dis"] if d else 1e-6)
        if t >= ratio.get(part, -1.0):
            ratio[part] = t
            if not d:
                top = k
    return ratio, top, err


# the factor on (b)'s tolerances for a cell's second step in (c); a cell not
# named is held to (b)'s. resnet50_slcl on the H100: the bands' second-step
# state lies 19.1-19.4 times (b)'s tolerance from one process's, at a
# layer-4 BatchNorm's running mean; the one process on the same images in
# reverse order (its sums in another order: ``floor_tol_ratio``) 8.9-9.1
# times, at the same entry, its metrics past (b)'s too; the halos'
# gradients not sent back (a planted fault) 21 times at the first step and
# 1,175 at the second (PERF.md §6)
LATER_FACTOR = {"resnet50_slcl": 50.0}
# cells held at each step to what sound runs of the one process give in the
# same call (each part's ratio at most the larger of 1 and the reversed
# images' or the images one float32 ulp up's): mccl_rain at full width,
# whose first Adam step moves encoder1's first convolution by 1.01 times
# (b)'s tolerance on the bands, 2.38 times on inputs one ulp apart, and
# whose second iteration parts by 5-7 times on the bands, 10-11 times on
# the ulp inputs (PERF.md §6); ddfseg, adaptevery_small and bcl_small
FLOOR_HELD = ("mccl_rain", "ddfseg", "adaptevery_small", "bcl_small")
# a FLOOR_HELD cell's second step and first-step gradients held to this
# factor times its sound runs: on the H100 ddfseg's bands read 0.78-1.03
# times the larger sound run at its second step's BatchNorm statistics
# (11,693-14,089 times (b)'s tolerance: its first Adam step moves every
# entry whose gradient is rounding noise by a full lr either way, in every
# run), up to 1.36 times at its pixel-count metrics, and 1.002 times at
# d_main's first-step gradient (10.02 against 10.00: its real and fake
# terms nearly cancel); a planted halo fault 1.8-3.9 times this bound at
# the second step, 4.6-100 times at the gradients (PERF.md §6)
FLOOR_FACTOR = {"ddfseg": 2.0}
# the margin under a sound run's cosine at which a FLOOR_HELD cell's
# network must move as one process's: a noise entry moves each run its own
# way, which spreads the cosine of a network's move from run to run
NET_MOVE_MARGIN = 0.1
# cells whose segmentor Adam updates (DDFSeg's generator): its parameters
# are held by their first-step gradient (a network's error norm within
# 1e-4 of its norm, or its sound runs') and their move (with the
# discriminators'), its BatchNorm statistics to (b)'s tolerance
ADAM_SEG = ("ddfseg",)


def dp_two_ranks(work: Path, cells, ones: dict, spatial: bool = False) -> dict:
    """(b): two gloo ranks on the card, data-parallel (8 of the 16 rows each),
    against one process on the card (``ones[cell]``: :func:`one_process`);
    (c) with ``spatial``: the two ranks as one data rank's two model ranks,
    each with its band of the rows of all 16 images, and each rank's second
    step timed. Each of ``cells`` is a cell of :func:`cell_config`, all run
    in turn in one pair of ranks (``seconds``: the pair's whole run, on each
    cell's record). Returns :func:`hold_cell`'s record of each."""
    from slcl_torch.parallel.dryrun import spawn
    t0 = time.perf_counter()
    ranks = spawn(2, "cells_entry", (list(cells), str(work), {c: ones[c][1] for c in cells}),
                  module="chip_smoke", device="cuda:0", timeout=900,
                  model_axis=2 if spatial else 1, spatial=spatial)
    seconds = round(time.perf_counter() - t0, 1)
    return {c: hold_cell(c, ones[c][0], [r[c] for r in ranks], spatial, seconds)
            for c in cells}


def is_buffer(key: str) -> bool:
    """A BatchNorm's statistics or counter, which no optimizer moves."""
    return key.endswith(("running_mean", "running_var", "num_batches_tracked"))


def move_cosines(got: dict, want: dict) -> dict:
    """Per network of ``want``'s ``init`` (the discriminators, and an
    :data:`ADAM_SEG` generator), the cosine of ``got``'s move in its two
    steps against ``want``'s, the entries' moves taken together."""
    import torch
    sums = {}
    for k in want["init"]:
        w = want["state"][k]
        if torch.is_floating_point(w):
            dg = (got["state"][k] - got["init"][k]).double()
            dw = (w - want["init"][k]).double()
            s = sums.setdefault(k.split("/")[0], [0.0, 0.0, 0.0])
            s[0] += float((dg * dg).sum())
            s[1] += float((dw * dw).sum())
            s[2] += float((dg * dw).sum())
    return {k: c / math.sqrt(a * b) for k, (a, b, c) in sums.items() if a > 0 and b > 0}


def grad_ratios(got: dict, want: dict) -> dict:
    """Per network, the error of ``got``'s first-step gradient (as its
    optimizer received it) against ``want``'s: its norm over the network's
    entries taken together, over 1e-4 of the norm of ``want``'s (at most 1
    within (b)'s gradient tolerance). A bias ahead of a norm, whose gradient
    is rounding noise, weighs nothing here."""
    import torch
    out = {}
    for name, ws in want["first_grads"].items():
        gs = got["first_grads"][name]
        diff = math.sqrt(sum(float((g.double() - w.double()).square().sum())
                             for g, w in zip(gs, ws)))
        norm = math.sqrt(sum(float(w.double().square().sum()) for w in ws))
        r = diff / max(norm, 1e-30) / 1e-4
        out[name[len("opt_"):]] = r if math.isfinite(r) else math.inf
    return out


def hold_cell(method: str, want: dict, ranks: list, spatial: bool, seconds: float) -> dict:
    """The ranks' records of the cell ``method`` against the one process's
    ``want``: the metrics of each step and the state after each (the
    sampling among it, with RAIN) at (b)'s tolerances (the second step's
    scaled by :data:`LATER_FACTOR`; a cell of :data:`FLOOR_HELD` held to
    its sound runs); :func:`step_ratios` of each, the largest error over
    its tolerance, is reported (and the sound runs', where they ran), and
    any that is over its bound or not finite fails. Each network's first-
    step gradient (:func:`grad_ratios`) is reported; a cell of
    :data:`FLOOR_HELD` holds it to the larger of 1 and its sound runs'
    (times its :data:`FLOOR_FACTOR`).
    Each network's move (:func:`move_cosines`) must have a cosine against
    one process's of at least 0.9, and at least each sound run's less
    :data:`NET_MOVE_MARGIN`: a gradient that is zero in exact arithmetic,
    as a bias ahead of a norm, is rounding noise, and Adam's step on it has
    no direction. BCL's ranks must take one process's pseudo-label round."""
    per = PER_METHOD[cell_method(method)]
    who = f"{'spatial ' if spatial else ''}two ranks {method}"
    rec = {"rows_per_rank": [r["rows"] for r in ranks], "rows_one": want["rows"],
           "seconds": seconds}
    if spatial:
        rec["image_rows_per_rank"] = [r["image_rows"] for r in ranks]
        if rec["image_rows_per_rank"] != [want["image_rows"] // 2] * 2:
            raise AssertionError(f"spatial {method}: bands of {rec['image_rows_per_rank']} "
                                 f"rows of {want['image_rows']}")
        rec["step_ms_per_rank"] = [r["step_ms"] for r in ranks]
        rec["one_process_step_ms"] = want["step_ms"]
        rec["card"] = card_line()
    if "disc_f64" in want:
        rec["disc_f64_cancellation"] = want["disc_f64"]["cancellation"]
    rec["zero_feature_rows_one"] = want["zero_feature_rows"]
    if want["plabel_round"] is not None:
        rec["plabel_kept"] = want["plabel_round"]["kept"]
        same = [r["plabel_round"]["same_as_one_process"] for r in ranks]
        if not all(same):
            raise AssertionError(f"{who}: the ranks' pseudo-label rounds {same} differ "
                                 f"from one process's")
    floors, floor_grads, move_bound = [], [], {}
    for name in ("floor", "ulp_floor"):
        if name in want:
            fl = [step_ratios(want[name], want, i) for i in range(2)]
            rec[f"{name}_tol_ratio"] = [r for r, _, _ in fl]
            rec[f"{name}_worst_seg_entry"] = [t for _, t, _ in fl]
            rec[f"{name}_grad_ratio"] = grad_ratios(want[name], want)
            cos = move_cosines(want[name], want)
            rec[f"{name}_move_cosine"] = cos
            if method in FLOOR_HELD:
                for k, v in cos.items():
                    move_bound[k] = min(move_bound.get(k, 0.9), v - NET_MOVE_MARGIN)
                if not all(math.isfinite(v) for r, _, _ in fl for v in r.values()):
                    raise AssertionError(f"{method}: a sound run ({name}) is not finite: "
                                         f"{rec[f'{name}_tol_ratio']}")
                floors.append([r for r, _, _ in fl])
                floor_grads.append(rec[f"{name}_grad_ratio"])

    def limit(i: int, part: str) -> float:
        """The bound on a part's ratio at step i: (b)'s tolerance (1) at the
        first, the cell's :data:`LATER_FACTOR` at the second; for a cell of
        :data:`FLOOR_HELD` the larger of 1 and the sound runs' ratios (at the
        second step times its :data:`FLOOR_FACTOR`)."""
        if floors:
            factor = FLOOR_FACTOR.get(method, 1.0) if i else 1.0
            return max([1.0] + [factor * fl[i].get(part, 0.0) for fl in floors])
        return LATER_FACTOR.get(method, 1.0) if i else 1.0

    for r, got in enumerate(ranks):
        for k, v in per.items():
            if got["launches"][k] != 2 * v:
                raise AssertionError(f"{who} rank {r}: {k} launched "
                                     f"{got['launches'][k]} times in 2 steps, expected {2 * v}")
        steps = [step_ratios(got, want, i) for i in range(2)]
        rec[f"rank{r}_tol_ratio"] = [x for x, _, _ in steps]
        rec[f"rank{r}_worst_seg_entry"] = [t for _, t, _ in steps]
        rec[f"rank{r}_zero_feature_rows"] = got["zero_feature_rows"]
        bounds = [{k: limit(i, k) for k in x} for i, (x, _, _) in enumerate(steps)]
        rec["tol_bounds"] = bounds
        bad = {i: {k: v for k, v in x.items() if not v <= bounds[i][k]}
               for i, (x, _, _) in enumerate(steps)}
        if any(bad.values()):
            raise AssertionError(f"{who} rank {r}: error over tolerance {bounds} "
                                 f"{bad}; all {rec[f'rank{r}_tol_ratio']}")
        if set(got["first_grads"]) != set(want["first_grads"]):
            raise AssertionError(f"{who} rank {r}: networks "
                                 f"{sorted(got['first_grads'])} vs {sorted(want['first_grads'])}")
        grads = grad_ratios(got, want)
        rec[f"rank{r}_grad_ratio"] = grads
        if floor_grads:
            factor = FLOOR_FACTOR.get(method, 1.0)
            rec["grad_bound"] = {k: max([1.0] + [factor * fl[k] for fl in floor_grads])
                                 for k in grads}
            bad = {k: v for k, v in grads.items() if not v <= rec["grad_bound"][k]}
            if bad:
                raise AssertionError(f"{who} rank {r}: first-step gradients {bad} over "
                                     f"{rec['grad_bound']}")
        cosines = move_cosines(got, want)
        rec[f"rank{r}_move_cosine"] = cosines
        rec["move_cosine_bound"] = {k: move_bound.get(k, 0.9) for k in cosines}
        bad = {k: v for k, v in cosines.items() if not v >= rec["move_cosine_bound"][k]}
        if bad:
            raise AssertionError(f"{who} rank {r}: {bad} moved unlike one process's "
                                 f"(bounds {rec['move_cosine_bound']})")
        if "disc_f64" in want:
            rec[f"rank{r}_disc_f64_grad_rel_err"] = max(
                grad_rel_err(g_, w_, f"{who} rank {r} d_main f64 gradient {j}")
                for j, (g_, w_) in enumerate(zip(got["disc_f64"]["grads"],
                                                 want["disc_f64"]["grads"])))
        err = steps[1][2]
        seg = [v for k, v in err.items() if not k.startswith("d_") and k != "sampling"]
        rec[f"rank{r}_max_abs_err"] = max(seg)
        if "sampling" in err:
            rec[f"rank{r}_sampling_max_abs_err"] = err["sampling"]
        rec[f"rank{r}_disc_max_abs_err"] = max([v for k, v in err.items()
                                                if k.startswith("d_")], default=0.0)
        rec[f"rank{r}_launches_per_step"] = {k: got["launches"][k] / 2 for k in per}
    return rec


def spatial_cell(cell: str) -> int:
    """``python3 chip_smoke.py --spatial-cell NAME``: phase 9(c)'s cell NAME
    alone (one of :data:`SMOKE_SPATIAL`, or DRUNet's ``slcl`` / ``mccl``):
    the one process (and the reversed images, :func:`one_process`), the two
    ranks. Prints the cell's record as one JSON line, or its failure with
    every ratio; exits 1 when it fails."""
    (ROOT / "runs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "runs"))
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rec = dp_two_ranks(work, [cell], {cell: one_process(work, cell)},
                               spatial=True)[cell]
    except AssertionError as e:
        print(json.dumps({"cell": cell, "ok": False, "error": str(e), "card": card_line()}))
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"cell": cell, "ok": True, **rec}))
    return 0


def parallel_phase(work: Path, one_slcl: tuple, gloo_dp: dict) -> dict:
    """Phase 9 (see the module docstring): (a), then (c); ``gloo_dp`` is
    (b)'s record, whose ranks ran beside phase 5, ``one_slcl`` its
    :func:`one_process` of ``slcl``."""
    import torch
    from slcl_torch.parallel import mesh as dp
    out = {"split_entries": split_entries()}
    mesh = dp.make_mesh(1, backend="nccl", device=torch.device("cuda"),
                        init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        out["nccl_one_rank"] = {
            "slcl": dp_one_rank(work, mesh, "slcl", False),
            "mccl": dp_one_rank(work, mesh, "mccl", False),
            "slcl_fsdp": dp_one_rank(work, mesh, "slcl", True)}
    finally:
        dp.release()
    out["gloo_two_ranks_one_card"] = gloo_dp
    # (c): one pair of ranks, its cells in turn
    one = {"slcl": one_slcl, **{c: one_process(work, c) for c in SMOKE_SPATIAL}}
    gc.collect()
    torch.cuda.empty_cache()
    out["gloo_spatial_two_ranks_one_card"] = dp_two_ranks(work, list(one), one, spatial=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: run.scan_steps (CUDA-graph capture and replay of the step)
# ---------------------------------------------------------------------------
SCAN_K = 4
# JAX's scan test's tolerances (tests/test_trainer.py: the state rtol 2e-5 /
# atol 1e-6, the metrics rel 1e-4 / abs 1e-6), for the runner against
# scan_steps=1: the capturable optimizers round differently
SCAN_RTOL, SCAN_ATOL, SCAN_METRICS_RTOL = 2e-5, 1e-6, 1e-4
_SMALL_NETS = dict(layers=(1, 1, 1, 1), base=8)
_SMALL_RAIN = dict(enabled=True, update_eps=True, eps_clip=3.0)
# phase 10's runs of every method at phase 3's sizes: (label, method, model
# overrides, crop, config overrides by section, a shallow backbone the
# factory does not build)
SCAN_SMALL = (
    ("baseline", "baseline", {}, 32, {}, None),
    ("adaptseg deeplabv2", "adaptseg", dict(backbone="deeplabv2"), 32, {}, "deeplabv2"),
    ("advent", "advent", {}, 32, {}, None),
    ("mpscl", "mpscl", {}, 32, {}, None),
    ("slcl", "slcl", {}, 32, {}, None),
    ("mccl stdmin", "mccl", {}, 32,
     {"contrastive": dict(stdmin=True, w_stdmin=0.1, seg_pseudo=True)}, None),
    ("resnet50 mccl", "mccl", dict(backbone="resnet50", filters=32, **_SMALL_NETS), 64, {},
     None),
    # RAIN before warm-up (the ascent off), and the ascent at one iteration a batch
    ("mccl rain before warm-up", "mccl", {}, 64,
     {"rain": dict(_SMALL_RAIN, eps_iters=2), "contrastive": dict(warmup_epochs=1)}, None),
    ("mccl rain ascent", "mccl", {}, 64,
     {"rain": dict(_SMALL_RAIN, eps_iters=1), "contrastive": dict(warmup_epochs=0)}, None),
    ("rain", "rain", {}, 64, {"rain": dict(_SMALL_RAIN, eps_iters=1)}, None),
    ("pretrain_rain", "pretrain_rain", {}, 64, {"optim": dict(lr=1e-4)}, None),
    ("ddfseg", "ddfseg", {}, 64, {"ddfseg": dict(filters=4, style_filters=4, ngf=8,
                                                 slim=True)}, None),
    ("adaptevery", "adaptevery", _SMALL_NETS, 64, {}, None),
    ("bcl", "bcl", _SMALL_NETS, 64, {}, None),
    # the general kernels replayed: GEN_CELLS' mccl at P = 4, C = 5, F = 48
    ("mccl p4 c5 f48 std", "mccl", dict(num_classes=5, filters=48), 32,
     {"contrastive": dict(part=4, stdmin=True, w_stdmin=0.1, seg_pseudo=True)}, None),
)
# the runs also held to the Trainer at scan_steps=1 (JAX's scan test's
# tolerances: the capturable optimizers round differently)
SCAN_VS_PLAIN = ("mccl p4 c5 f48 std",)


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic mode (an op
    without a deterministic form raises) for phase 10's comparisons: with
    cuDNN's default choice two uncaptured runs of the same steps differ on
    the card, so only then does equality say that a replay took the eager
    step."""
    import torch
    before = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before[0]
        torch.use_deterministic_algorithms(before[1])


def scan_state(trainer) -> dict:
    """Every network's state, every optimizer's state tensors, the centres
    and the sampling, cloned."""
    from slcl_torch.train.state import optimizers
    from slcl_torch.train.trainer import _NETS
    s, out = trainer.state, {}
    for n in _NETS:
        if getattr(s, n) is not None:
            out.update({f"{n}/{k}": v.detach().clone()
                        for k, v in getattr(s, n).state_dict().items()})
    for n, opt in optimizers(s).items():
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{n}/{i}/{k}": v.detach().clone() for k, v in st.items()})
    for n in ("centroids", "sampling"):
        if getattr(s, n) is not None:
            out[n] = getattr(s, n).detach().clone()
    return out


def scan_compare(a: dict, b: dict, what: str, rtol=None, atol=None) -> float:
    """``a`` against ``b`` (tensors by name): equal bit for bit when
    ``rtol`` is None (Adam's step counters too), else within rtol / atol
    (the step counters, kept on another device, equal); returns the largest
    difference."""
    import torch
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: entries differ {sorted(set(a) ^ set(b))[:4]}")
    worst = 0.0
    for k in a:
        x, y = a[k].float().cpu(), b[k].float().cpu()
        if rtol is None or k.endswith("/step"):
            if not torch.equal(x, y):
                d = float((x - y).abs().max()) if x.shape == y.shape else math.inf
                raise AssertionError(f"{what}: {k} differs by {d}")
            continue
        worst = max(worst, close(x, y, rtol, atol, f"{what} {k}"))
    return worst


def scan_epoch(trainer, batches, sched) -> tuple:
    """``trainer.train_steps`` on device ``batches``, synchronised:
    (summed metrics cloned, steps, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, n = trainer.train_steps(batches, sched)
    torch.cuda.synchronize()
    return {k: v.clone() for k, v in acc.items()}, n, time.perf_counter() - t0


def scan_profile(trainer, batches, sched) -> dict:
    """``trainer.train_steps`` on ``batches`` under torch.profiler: device busy
    ms a step, its idle share, and the port kernels' device events a step
    by source (``PORT_KERNELS``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_steps(batches, sched)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, port = 0.0, dict.fromkeys(PORT_KERNELS, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            for src, parts in PORT_KERNELS.items():
                port[src] += any(p in e.name for p in parts)
    n = len(batches)
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "idle_share": 1.0 - busy_us / wall_us,
            "port_kernel_events_per_step": {k: v / n for k, v in port.items()}}


def scan_cell(work: Path, method: str) -> dict:
    """Phase 10, one full-width cell (``dp_config``: ``slcl`` multilvl + CNR,
    the ``mccl`` preset): 2K + 1 steps at K = SCAN_K through the Trainer's
    captured runner, the same runner uncaptured and the Trainer at
    ``scan_steps=1``, from the same init, batches and sched, under
    :func:`deterministic`; then, with cuDNN's default algorithms and a graph
    captured anew, the timing, profile and memory of the plain and the
    replayed step."""
    import itertools
    import torch
    from slcl_torch.data import device_prefetch
    from slcl_torch.ops.cuda import launch_counts, reset_launch_counts
    from slcl_torch.train.trainer import Trainer

    cfg_k = dp_config(work, method)
    cfg_k.run.scan_steps = SCAN_K
    graph, uncaptured = Trainer(cfg_k), Trainer(cfg_k)
    uncaptured.multi = uncaptured.build_multi_step(capture=False)
    plain = Trainer(dp_config(work, method))
    batches = list(itertools.islice(device_prefetch(itertools.chain(
        graph._epoch_batches(), graph._epoch_batches()), graph.device), 2 * SCAN_K + 1))
    sched = graph._sched(0)
    rec: dict = {"k": SCAN_K, "steps": len(batches)}
    runs = {}
    for mode, t in (("graph", graph), ("uncaptured", uncaptured), ("plain", plain)):
        reset_launch_counts()
        with deterministic():
            acc, n, sec = scan_epoch(t, batches, sched)
        runs[mode] = (acc, scan_state(t))
        rec[mode] = {"seconds": sec, "steps": n, "launches": launch_counts(),
                     "metrics": {k: float(v) / n for k, v in acc.items()}}
        if not all(math.isfinite(v) for v in rec[mode]["metrics"].values()):
            raise AssertionError(f"scan {method} {mode}: non-finite metrics")
    m = graph.multi
    rec["graph"].update(capture_s=m.capture_s, captured_step=m.captured_step,
                        replays=m.replays, eager_steps=m.eager_steps)
    if (m.captured_step, m.replays, m.eager_steps) != (3, 2 * SCAN_K - 3, 3):
        raise AssertionError(f"scan {method}: captured at {m.captured_step}, "
                             f"{m.replays} replays, {m.eager_steps} eager runner steps")
    # the wrappers count where they launch: the three eager steps, the
    # capture and the plain tail step; a replay launches without Python
    for kname, per in PER_METHOD[method].items():
        if rec["graph"]["launches"][kname] != 5 * per:
            raise AssertionError(f"scan {method}: {kname} counted "
                                 f"{rec['graph']['launches'][kname]}, expected {5 * per}")
    acc_g, state_g = runs["graph"]
    scan_compare(acc_g, runs["uncaptured"][0], f"scan {method} metrics, graph vs uncaptured")
    scan_compare(state_g, runs["uncaptured"][1], f"scan {method} state, graph vs uncaptured")
    rec["max_abs_diff_vs_scan_steps_1"] = {
        "metrics": scan_compare({k: v / len(batches) for k, v in acc_g.items()},
                                {k: v / len(batches) for k, v in runs["plain"][0].items()},
                                f"scan {method} metrics vs scan_steps=1",
                                SCAN_METRICS_RTOL, SCAN_ATOL),
        "state": scan_compare(state_g, runs["plain"][1], f"scan {method} state vs "
                              "scan_steps=1", SCAN_RTOL, SCAN_ATOL)}
    log(f"scan {method}: replayed == uncaptured bit for bit, within JAX's scan "
        "test's tolerances of scan_steps=1")

    # cuDNN's default algorithms: a graph captured anew (two warm-up steps,
    # the capture, a replay), then 20 steps back to back of each, eager /
    # graph / graph / eager, each mode's peak memory over the resident state
    graph.multi = uncaptured.multi = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reserved, before = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scan_epoch(graph, batches[:SCAN_K], sched)
    mem = {"capture": {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "above_resident_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
                       "reserved_increase_gb": (torch.cuda.memory_reserved() - reserved) / 1e9}}
    rec["graph"]["capture_s_default_algorithms"] = graph.multi.capture_s
    timed = [batches[i % (2 * SCAN_K)] for i in range(20)]
    replays = graph.multi.replays
    ms = []
    for mode in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, n, sec = scan_epoch(plain if mode == "eager" else graph, timed, sched)
        peak = torch.cuda.max_memory_allocated()
        ms.append([mode, sec / n * 1e3])
        mem[mode] = {"peak_gb": peak / 1e9, "above_resident_gb": (peak - before) / 1e9}
    rec["back_to_back_ms"] = ms
    rec["memory"] = mem
    prof_batches = batches[:SCAN_K]
    rec["profile"] = {"eager": scan_profile(plain, prof_batches, sched),
                      "graph": scan_profile(graph, prof_batches, sched)}
    eager_ev = rec["profile"]["eager"]["port_kernel_events_per_step"]
    graph_ev = rec["profile"]["graph"]["port_kernel_events_per_step"]
    if graph_ev != eager_ev or not any(graph_ev.values()):
        raise AssertionError(f"scan {method}: port kernels a replayed step {graph_ev}, "
                             f"an eager step {eager_ev}")
    if graph.multi.replays != replays + 2 * len(timed) + len(prof_batches):
        raise AssertionError(f"scan {method}: the timed steps did not all replay "
                             f"({graph.multi.replays - replays} replays)")
    for t in (graph, uncaptured, plain):
        t.multi = None
    return rec


def scan_small_run(label, method, model, crop, over, shallow) -> dict:
    """Phase 10, one method at phase 3's sizes: 2K steps (steps 0-2 eager,
    3 captured, 4-7 replayed) through the captured runner against the
    uncaptured one, bit for bit, under :func:`deterministic`."""
    import torch
    from slcl_torch.data import to_device
    from slcl_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = small_config(method)
    cfg.data.crop = crop
    for k, v in model.items():
        setattr(cfg.model, k, v)
    for section, kv in over.items():
        for k, v in kv.items():
            setattr(getattr(cfg, section), k, v)
    cfg.run.scan_steps = SCAN_K
    graph, uncaptured = Trainer(cfg, device="cuda"), Trainer(cfg, device="cuda")
    for t in (graph, uncaptured):
        if shallow:
            use_segmentor(t, small_segmentor(shallow, cfg, t.device))
    uncaptured.multi = uncaptured.build_multi_step(capture=False)
    plain = None
    if label in SCAN_VS_PLAIN:
        cfg_1 = copy.deepcopy(cfg)
        cfg_1.run.scan_steps = 1
        plain = Trainer(cfg_1, device="cuda")
    if method == "bcl":
        graph.bcl_update_plabels(cfg.run.bcl_prop)
        uncaptured.bcl_plabels = graph.bcl_plabels
    batches = [to_device(b, graph.device)
               for _, b in zip(range(2 * SCAN_K), graph._epoch_batches())]
    sched = graph._sched(0)
    with deterministic():
        acc_g, n, _ = scan_epoch(graph, batches, sched)
        acc_u, _, _ = scan_epoch(uncaptured, batches, sched)
        if plain is not None:
            acc_p, _, _ = scan_epoch(plain, batches, sched)
    m = graph.multi
    if m is None or (m.captured_step, m.replays) != (3, SCAN_K + 1):
        raise AssertionError(f"scan small {label}: not replayed "
                             f"({None if m is None else (m.captured_step, m.replays)})")
    scan_compare(acc_g, acc_u, f"scan small {label} metrics")
    scan_compare(scan_state(graph), scan_state(uncaptured), f"scan small {label} state")
    metrics = {k: float(v) / n for k, v in acc_g.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"scan small {label}: non-finite metrics")
    out = {"steps": n, "crop": crop, "capture_s": m.capture_s, "replays": m.replays,
           "sched": {k: v for k, v in sched.items()}, "metrics": metrics}
    if plain is not None:
        out["max_abs_diff_vs_scan_steps_1"] = {
            "metrics": scan_compare({k: v / n for k, v in acc_g.items()},
                                    {k: v / n for k, v in acc_p.items()},
                                    f"scan small {label} metrics vs scan_steps=1",
                                    SCAN_METRICS_RTOL, SCAN_ATOL),
            "state": scan_compare(scan_state(graph), scan_state(plain),
                                  f"scan small {label} state vs scan_steps=1", SCAN_RTOL,
                                  SCAN_ATOL)}
    out["seconds"] = time.perf_counter() - t0
    log(f"scan small {label}: replayed == uncaptured bit for bit over {n} steps"
        + (", within JAX's scan test's tolerances of scan_steps=1" if plain else ""))
    return out


def scan_steps_phase(work: Path) -> dict:
    """Phase 10 (see the module docstring)."""
    t0 = time.perf_counter()
    out = {"cells": {m: scan_cell(work, m) for m in ("slcl", "mccl")},
           "small": {run[0]: scan_small_run(*run) for run in SCAN_SMALL}}
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
    if sys.argv[1:2] == ["--spatial-cell"]:
        return spatial_cell(sys.argv[2])
    # no instantiation (any F, bf16 or f32, P, std or not) of the kernels
    # that hold rows or sums in registers may spill, not only the main path's
    for src in ("mpcl", "mpcl_pseudo", "pseudo_label", "soft_centroids"):
        for fn, regs, spill in build.ptxas_report(src):
            if spill and ("fwd_partial" in fn or "pseudo_label_kernel" in fn
                          or "_gen" in fn or src == "soft_centroids"):
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
        rows, read_only_ms, general_check = check_kernels(peaks)
        digest = centroid_digest()
        if digest != STD_FREE_DIGEST:
            raise AssertionError(f"the std-free centroid kernels' outputs changed: digest "
                                 f"{digest}, before the std variant {STD_FREE_DIGEST}")
        log("std-free centroid kernels: outputs bit-identical to commit 98d6b0e's")
        small = check_small_steps()
        small_rain = check_small_rain_steps()
        small_extra = check_small_extra_steps()
        log(f"{time.perf_counter() - t0:.1f} s: phases 1-3 done")
        (ROOT / "runs").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "runs"))
        try:
            train = train_full_width(work)
            train_mccl = train_full_width(work, "mccl")
            # the std kernels' path, in a short cell
            train_std = train_full_width(work, "mccl", stdmin=True, n_timed=10)
            # the general kernels' paths: C, P and F the templated kernels
            # do not take
            t4 = time.perf_counter()
            train_gen = {cell: train_full_width(work, method, n_timed=n, name=cell, over=over)
                         for cell, (method, over, n) in GEN_CELLS.items()}
            for cell in GEN_CELLS:
                train_gen[cell]["cli"] = general_cli(work, cell,
                                                     train_gen[cell]["steps_per_epoch"])
            general_check["phase4_seconds"] = time.perf_counter() - t4
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
            # DDFSeg, AdaptEvery and BCL (after one pseudo-label round)
            extra_cells = {m: train_full_width(work, m, n_timed=n, name=m)
                           for m, n in EXTRA_CELLS}
            log(f"{time.perf_counter() - t0:.1f} s: phase 4 done")
            # phase 9(b)'s pair of ranks (after its one-process runs) and
            # phase 7's export CLI (once phase 5 has trained its model) run
            # beside phase 5, which times nothing but its own wall time
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                ones_dp = {m: one_process(work, m) for m in ("slcl", "mccl") + SMOKE_DP}
                gloo = pool.submit(dp_two_ranks, work, list(ones_dp), ones_dp)
                protocol = protocol_full_width(work)
                export = start_export(work, protocol)
                protocol["rain"] = protocol_rain(work)
                extra_protocol = protocol_extra(work)
                gloo_dp = gloo.result()
            log(f"{time.perf_counter() - t0:.1f} s: phase 5 (and 9(b)) done")
            real = train_real(work)
            served = serve_phase(work, protocol, {"mscmrseg": work / "data" / "mscmrseg"},
                                 export)
            log(f"{time.perf_counter() - t0:.1f} s: phases 6-7 done")
            run_utils = run_utils_phase(work)
            parallel = parallel_phase(work, ones_dp["slcl"], gloo_dp)
            log(f"{time.perf_counter() - t0:.1f} s: phases 8-9 done")
            scan = scan_steps_phase(work)
            for k in ("slcl_args", "slcl_best"):
                protocol.pop(k)
        finally:
            for proc in STARTED:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(work, ignore_errors=True)

    cells = {"train": train, "train_mccl": train_mccl, "train_mccl_stdmin": train_std,
             **{"train_" + cell: rec for cell, rec in train_gen.items()}}
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
                 # DDFSeg, AdaptEvery, BCL: none on their paths
                 "launches_extra": {cell: extra_cells[cell]["launches"][kname]
                                    for cell in extra_cells},
                 # phase 3's two UNet steps at F = 64 (the 64-wide instantiations)
                 "launches_small_f64": small["unet slcl F=64"]["launches"][kname],
                 # phase 10's full-width cells through the scan_steps runner:
                 # its eager steps, the capture and the tail (a replay runs
                 # no wrapper)
                 "launches_scan_steps": {cell: scan["cells"][cell]["graph"]["launches"][kname]
                                         for cell in scan["cells"]},
                 # phase 4's cells on the general kernels, per step
                 "launches_per_step_general_cells": {
                     cell: rec["launches"][kname] / rec["steps_per_epoch"]
                     for cell, rec in train_gen.items()},
                 "max_abs_err": rec["max_abs_err"],
                 "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": rec["library_ms"]}
        for extra in ("near_tie_rows", "fused_route_ms", "two_op_route_ms", "partial_ms",
                      "final_ms", "p2_ms", "kernel_ms", "sel_ms", "sel_plain_ms",
                      "sel_bound_ms", "sel_partial_ms", "sel_final_ms", "sel_max_abs_err",
                      "mccl", "p1_ms", "p1_plain_ms", "p1_bound", "p1_partial_ms",
                      "p1_final_ms", "library_f32_ms", "p1_library_ms",
                      "p1_library_f32_ms", "copy_ms", "forced_ms", "templated_ms",
                      "max_abs_err_by_shape", "forced_vs_templated_max_abs_diff",
                      "mccl_p1_soft", "p4_library_pair_ms", "bwd_plan", "library_pair_ms",
                      "err_f64", "err_f64_std", "fwd_plan"):
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
    print(json.dumps({"train_general": {"cells": train_gen, "check": general_check,
                                        "small_steps": {k: small[k] for k in small
                                                        if k in ("slcl c5 f24",
                                                                 "mccl p4 c5 f48 std")}}}))
    print(json.dumps({"train_rain": {"cells": rain_cells, "small_steps": small_rain}}))
    print(json.dumps({"protocol": protocol}))
    print(json.dumps({"train_real": real}))
    print(json.dumps({"train_backbones": {"cells": backbones, "small_steps": small}}))
    print(json.dumps({"train_extra": {"cells": extra_cells, "small_steps": small_extra,
                                      "protocol": extra_protocol}}))
    print(json.dumps({"serve": served}))
    print(json.dumps({"run_utils": run_utils}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"scan_steps": scan}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
