"""Training orchestration (counterpart of ``slcl_tpu/train/trainer.py``) for
every ``method`` of the JAX package: ``baseline``/``adaptseg``/``advent``/
``mpscl``/``slcl``/``mccl``/``rain``/``pretrain_rain``/``ddfseg``/
``adaptevery``/``bcl``.

``Trainer(cfg, device=None)`` builds the segmentor (``model.backbone``:
DRUNet, UNet, DeepLabV2 or the ResNet-50 U-Net; with ``model.pretrained``
its ImageNet encoder from the local file ``model.pretrained_ckpt``), the
discriminators of the adversarial methods, the optimizers, the step and
the :class:`Evaluator`, and runs the epoch loop with per-epoch LR (poly by
default), per-epoch target validation with best-checkpointing, early stop
and a wall-clock budget, and a final test of the best checkpoint on
``test_t`` and ``test_s`` (``summary.json``, ``log.jsonl``). It runs on
CUDA unless the caller passes ``device="cpu"``; with no CUDA device and no
explicit device it raises.

Class centres: ``contrastive.init_centers`` names a (C, F) float32 ``.npy``
(``python -m slcl_torch.scripts.gen_class_centers``); with none, the
centres start at zero and the first step adopts the batch means.
Checkpoints: ``<run.out_dir>/<apdx>/ckpt_<tag>.pt``, a ``torch.save`` of
the modules', optimizers' and centres' state, the step counter and the
seed (which with the step fixes MCCL's rMC draws), loadable
with ``torch.load(..., weights_only=True)``. ``run.init_from`` warm-starts
the networks from any such file (weights and BatchNorm buffers only,
merged by name across methods); ``run.restore_from`` resumes the full state.

RAIN (``rain.enabled``, ``method=rain``): the frozen style net starts from
``run.seed + 7`` and loads each configured component file
(``rain.vgg_ckpt``, ``decoder_ckpt``, ``fc_encoder_ckpt``,
``fc_decoder_ckpt``: the reference's ``.pth``/``.pt`` or the JAX package's
``.npz``; a configured file that is missing raises). After warmup each
batch runs ``rain.eps_iters`` epsilon iterations, every one counted in the
epoch mean. ``method=pretrain_rain`` trains the style net itself with no
validation, keeps the checkpoint of the least summed loss, and exports
``rain_{encoder,decoder,fc_encoder,fc_decoder}.npz`` in the JAX layout.
``baseline`` on MMWHS also tests the other cross-validation fold.

DDFSeg, AdaptEvery and BCL build their own networks (JAX trainer.py:306-
484): DDFSeg a :class:`DDFSeg` (``cfg.ddfseg``; Adam at ``optim.lr``) and
three PatchGANs, evaluated as SegDecoder(content_s(x)); AdaptEvery a
:class:`ResNetUNetPoint` (``model.layers``/``model.base``;
``optim.optimizer``), three entropy-map discriminators and a PointNet, its
vertices dropped at evaluation (``data.vert`` is implied); BCL a
:class:`BCLDeepLab` (plain SGD, no 10x group) whose pseudo-labels are
renewed at the start of every epoch that ``run.bcl_round_epochs`` divides,
a target image without one taking an all-255 map. Every discriminator
takes Adam at ``optim.lr_dis`` with betas ``(adv.mmt1, adv.mmt)``.

``model.remat`` (``full`` / ``dots``) recomputes the segmentor's
activations in the backward (``train/steps.py::seg_forward``);
``run.profile_dir`` records epoch ``run.profile_epoch`` (clamped to the
last epoch that runs) as a ``torch.profiler`` trace under that directory;
``train()`` writes each epoch's record as TensorBoard scalars under
``<out_dir>/tb`` when ``tensorboardX`` is installed.

``run.scan_steps=K`` > 1 (JAX's ``make_multi_step``, used as JAX uses it:
only in epochs of one step a batch, ``rain.eps_iters`` iterations being
off) takes an epoch's batches K at a time through the multi-step runner
(``train/multistep.py``): on CUDA one CUDA graph of the step, captured after
step 0 and two warm-up steps and replayed once a step; on the CPU the same
runner uncaptured. The tail of fewer than K batches, and a batch whose
shapes differ from the runner's, take the plain step. Under a mesh of more
than one process the steps run eagerly, one a dispatch, as with K = 1 (a
line at construction says so). Restoring a checkpoint drops the graph; the
next epoch captures again.

Data parallelism (``slcl_torch/parallel/mesh.py``): under ``torchrun
--nproc_per_node=N`` (``WORLD_SIZE`` > 1), or inside ``parallel.mesh.use``,
the Trainer runs on ``cuda:LOCAL_RANK`` (or the CPU with ``device=cpu``,
over gloo) on a ``(data, model)`` mesh with ``mesh.model_axis`` model
ranks. Each rank's Loaders decode its ``data.bs / W_data`` rows of every
global batch, the steps give the one-process step on the global batch,
and with ``mesh.fsdp`` the networks' large modules are sharded over the
model ranks. Every rank runs the validation and the BCL pseudo-label
round; rank 0's score decides the best epoch and the early stop for all,
and rank 0 alone writes the checkpoints (gathered whole, in the
one-process format), logs and summary. ``pretrain_rain`` stays unsharded
(every rank steps on the whole batch). Where JAX would fall back to one
device, the Trainer raises ``ValueError``: processes not divisible by
``mesh.model_axis``, or ``data.bs`` not divisible by the data ranks.

Spatial partitioning (``mesh.spatial`` with model ranks, JAX's
``spatial_shard_batch``): each model rank of a data rank takes a band of
``H / model_axis`` rows of its data rank's images (``img_*``, ``lab_*``,
``plabel_*``; an ``H`` the model ranks do not divide raises ``ValueError``),
and the step still equals the one-process step on the global batch
(``parallel/spatial.py``: convolutions with halos, pools, transposed
convolutions and resizes that reshard uneven stages; the reductions over
every rank). It covers every method on every network: the segmentors
DRUNet, ResNetUNet (``resnet50``/``resnet50_unet``), UNet and DeepLabV2
(``deeplabv2``/``resnet101``) with the ``UncertaintyDiscriminator``,
RAIN's style net, and DDFSeg (with its PatchGANs), AdaptEvery's
ResNetUNetPoint (its vertex branch the same on every model rank; the
vertices are not split, as JAX's ``_is_spatial`` leaves them whole) and
BCLDeepLab, with ``model.remat`` off, ``full`` or ``dots`` (each rank
recomputes its forward's halo exchanges in the same order). Validation,
test and BCL's pseudo-label rounds run on whole images outside any mesh,
as JAX's evaluator does; each rank then splits its rows of the round's
``plabel_t`` into bands.
"""
from __future__ import annotations

import copy
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed import barrier, is_initialized as dist_initialized

from .. import DeviceLike, resolve_device
from ..config import Config, build_apdx
from ..data import Loader, device_prefetch, prepare_datasets, zip_domains
from ..eval.evaluator import Evaluator, mean_fg_dice
from ..models import UncertaintyDiscriminator, build_segmentor
from ..models.common import SegOutput
from ..models.ddfseg import DDFSeg
from ..models.deeplabv2 import BCLDeepLab
from ..models.discriminators import PatchGAN
from ..models.pointnet import PointNetCls
from ..models.rain import LATENT, RAIN
from ..models.resnet_unet import ResNetUNetPoint
from ..ops.centroids import gene_thres
from ..ops.cuda import check_shape
from ..parallel import mesh as dp
from ..utils.convert import read_rain_component, save_tree_npz, state_dict_to_flax
from ..utils.pretrained import load_pretrained_encoder
from ..utils.callbacks import EarlyStopCallback, ModelCheckPointCallback
from ..utils.tb import TBWriter
from ..utils.timer import profile_trace
from . import schedules
from .state import (TrainState, capturable, create_pretrain_rain_state,
                    create_train_state, make_optimizer, plain_form,
                    plain_optimizer_state, rain_sampling_rows)
from .multistep import MultiStep, StagedDraws, make_multi_step
from .steps import autocast, build_step, remat_mode

_PORTED = ("baseline", "adaptseg", "advent", "mpscl", "slcl", "mccl", "rain",
           "pretrain_rain", "ddfseg", "adaptevery", "bcl")
_ADVERSARIAL = ("adaptseg", "advent", "mpscl", "slcl")
_CONTRASTIVE = ("mpscl", "slcl", "mccl")
_OWN_NETS = ("ddfseg", "adaptevery", "bcl")     # built by _build_<method>
# the batch keys whose rows a spatial mesh splits (JAX's _is_spatial)
_SPATIAL_KEYS = ("img", "lab", "plabel")
_NETS = ("seg", "d_main", "d_aux", "d_seg", "d_ent", "d_point", "rain")
_OPTS = ("opt_seg", "opt_d_main", "opt_d_aux", "opt_d_seg", "opt_d_ent", "opt_d_point")
# RAIN's component files: (the net's part, its config key)
RAIN_PARTS = (("encoder", "vgg_ckpt"), ("decoder", "decoder_ckpt"),
              ("fc_encoder", "fc_encoder_ckpt"), ("fc_decoder", "fc_decoder_ckpt"))
PRETRAIN_LOSSES = ("loss_c", "loss_s", "loss_l", "loss_r")


def check_ported_keys(cfg: Config) -> None:
    """Raise ``ValueError`` on a ``model.remat`` mode the port does not
    know (``steps.remat_mode``)."""
    remat_mode(cfg.model.remat)


def build_rain(cfg: Config, device: torch.device) -> RAIN:
    """The RAIN net from ``run.seed + 7`` on ``device``, each component that
    ``cfg.rain`` names loaded from its file (JAX trainer.py:114-163): the
    reference's Sequential ``.pth``/``.pt`` or the JAX package's ``.npz``
    tree. A configured file that is missing raises ``FileNotFoundError``."""
    gen = torch.Generator().manual_seed(cfg.run.seed + 7)
    rain = RAIN(gen).to(device, memory_format=torch.channels_last)
    for name, key in RAIN_PARTS:
        path = getattr(cfg.rain, key)
        if not path:
            continue
        if not os.path.exists(path):
            # a random style net would silently invalidate the run
            raise FileNotFoundError(f"rain.{key}={path!r}: the {name} checkpoint "
                                    "does not exist")
        part = getattr(rain, name)
        entries, unmatched = read_rain_component(path, name, part)
        part.load_state_dict(entries, strict=False)
        print(f"[rain] loaded {len(entries)} tensors into {name} from {path}"
              + (f"; unmatched: {unmatched}" if unmatched else ""))
    return rain


def stylized_branch_triggers(history, first_epochs: int = 6,
                             style_floor: float = 0.05,
                             src_ceiling: float = 0.85):
    """Warnings for the unlearnable-stylised-class signature of an MCCL +
    RAIN run (``slcl_tpu/train/trainer.py:34-69``): a class whose stylised-
    branch Dice stays under ``style_floor`` through epochs 1 to
    ``first_epochs - 1`` while its source Dice passes ``src_ceiling``.
    ``history`` is the trainer's per-epoch records; empty when healthy or
    when the diagnostics are absent."""
    early = [r for r in history if 0 < r.get("epoch", -1) < first_epochs]
    if len(early) < first_epochs - 1:
        return []
    out = []
    for c in (1, 2, 3):
        sty = [r.get(f"dice_style_c{c}") for r in early]
        src = [r.get(f"dice_src_c{c}") for r in early]
        if any(v is None for v in sty + src):
            continue
        if max(sty) < style_floor and max(src) > src_ceiling:
            out.append(
                f"stylized-branch warning: dice_style_c{c} never exceeded "
                f"{max(sty):.3f} over epochs 1-{first_epochs - 1} while "
                f"dice_src_c{c} reached {max(src):.3f} — the stylized view "
                "of this class is unlearnable at the current strength and "
                "the run is at risk of source-overfit collapse; set "
                "rain.style_alpha=0.5 (or lower) or fine-tune from a "
                "converged plain-MCCL checkpoint (examples/README.md, "
                "'Round-5 root cause').")
    return out


class SegView(nn.Module):
    """The evaluator's view of a network whose forward does not return a
    :class:`SegOutput`: ``fn(net, x)`` gives one."""

    def __init__(self, net: nn.Module, fn):
        super().__init__()
        self.net = net
        self.fn = fn

    def forward(self, x: torch.Tensor) -> SegOutput:
        return self.fn(self.net, x)


def check_kernel_shapes(cfg: Config) -> None:
    """Raise ``ValueError`` (naming C, P, F and the limit) when a contrastive
    method's shapes are beyond what the kernels take: ``model.num_classes``
    (C), ``model.filters`` (F, the contrastive tap) and, for ``mccl``,
    ``contrastive.part`` (P) with ``contrastive.stdmin``. Checked before
    anything is built, on any device, so that a config the card cannot run
    fails at once and a CPU run of it fails alike."""
    if cfg.method not in _CONTRASTIVE:
        return
    C, F = int(cfg.model.num_classes), int(cfg.model.filters)
    if cfg.method == "mccl":
        c = cfg.contrastive
        check_shape(C, F, max(int(c.part), 1), with_std=bool(c.stdmin),
                    kernels=("centroid_fwd", "centroid_final", "centroid_bwd"))
    else:   # MPCL and the fused target branch; slcl's CNR centroids at P = 1
        check_shape(C, F)


class Trainer:
    def __init__(self, cfg: Config, datasets: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        """``datasets``: dict with 'train_s', 'train_t', 'valid_t', 'test_t'
        (and optionally 'test_s'), objects with __len__/__getitem__; the
        synthetic set when None."""
        if cfg.method not in _PORTED:
            raise NotImplementedError(
                f"method {cfg.method!r}: slcl_torch ports {_PORTED} only")
        check_ported_keys(cfg)
        check_kernel_shapes(cfg)
        self.cfg = cfg
        # method-implied data: MCCL pairs each target image with a second
        # view (JAX trainer.py:89-90); before the datasets are built
        if cfg.method == "mccl":
            cfg.data.aug_counter = True
        if cfg.method == "adaptevery":
            cfg.data.vert = True        # the source vertices (JAX trainer.py:91)
        if device is None and dp.launched() and torch.cuda.is_available():
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(torch.device(device))
        self.device = resolve_device(device)
        self.mesh = self._setup_mesh()
        self.writer = dp.is_writer()
        self.apdx = build_apdx(cfg)
        # created on first write: eval-only users (gen_class_centers,
        # evaluate) leave no empty run directories
        self.out_dir = Path(cfg.run.out_dir) / self.apdx
        self.datasets = datasets or prepare_datasets(cfg)
        self._build()
        self._replicate()
        # run.scan_steps' runner, made at its first epoch (train_epoch)
        self.multi: Optional[MultiStep] = None
        self.scan_eager = (int(cfg.run.scan_steps) > 1 and self.mesh is not None
                           and self.mesh.world > 1)
        if self.scan_eager and self.writer:
            print(f"run.scan_steps={cfg.run.scan_steps}: {self.mesh.world} processes "
                  "(data ranks x model ranks); the steps run eagerly, one a dispatch "
                  "(a CUDA graph is captured on one process only)")
        self.history: list = []
        self.best_score = -np.inf
        self.best_epoch = -1
        self.start_time = time.time()
        self.longest_epoch = 0.0

    def _setup_mesh(self) -> Optional["dp.Mesh"]:
        """The active mesh (``parallel.mesh.use``), else under torchrun a new
        one, checked against the config; None for one process and for
        ``pretrain_rain``, which stays unsharded as in JAX."""
        cfg = self.cfg
        model_axis = max(cfg.mesh.model_axis, 1)
        spatial = bool(cfg.mesh.spatial) and model_axis > 1
        mesh = dp.current()
        if mesh is None and dp.launched():
            mesh = dp.make_mesh(model_axis, device=self.device, spatial=spatial)
        if mesh is None or cfg.method == "pretrain_rain":
            return None
        if mesh.model_size != model_axis:
            raise ValueError(f"mesh.model_axis={cfg.mesh.model_axis}, the mesh has "
                             f"{mesh.model_size} model ranks")
        if mesh.spatial != spatial:
            raise ValueError(f"mesh.spatial={cfg.mesh.spatial} with {model_axis} model "
                             f"ranks, the mesh {'splits' if mesh.spatial else 'does not split'}"
                             " image rows")
        if cfg.data.bs % mesh.data_size:
            raise ValueError(f"global batch data.bs={cfg.data.bs} is not divisible by "
                             f"{mesh.data_size} data ranks")
        if dp.is_writer():
            kind = "dp+fsdp" if cfg.mesh.fsdp and model_axis > 1 else "data-parallel"
            print(f"[mesh] {kind + ('+sp' if spatial else '')} over {mesh.world} processes "
                  f"(mesh {{'data': {mesh.data_size}, 'model': {mesh.model_size}}})")
        return mesh

    def _replicate(self):
        """Under a process group every network, the centres and the sampling
        from rank 0; then, with ``mesh.fsdp`` and model ranks, the networks'
        large modules sharded (their optimizers pointed at the shards)."""
        s = self.state
        dp.replicate(*(getattr(s, n) for n in _NETS), s.centroids, s.sampling)
        if self.mesh is not None and self.cfg.mesh.fsdp and self.mesh.model_size > 1:
            for net, opt in zip(_NETS, _OPTS):     # the frozen rain net has none
                module = getattr(s, net)
                if module is not None:
                    dp.fsdp_shard(module, [getattr(s, opt)], self.mesh,
                                  self.cfg.mesh.fsdp_min_size)
                    if getattr(s, opt) is not None:
                        plain_form(getattr(s, opt))

    def _build(self):
        cfg = self.cfg
        dev = self.device
        if cfg.method in _OWN_NETS:
            self.centroids_loaded = False
            getattr(self, f"_build_{cfg.method}")()
            return
        rain = None
        if cfg.rain.enabled or cfg.method in ("rain", "pretrain_rain"):
            rain = build_rain(cfg, self.device)
        if cfg.method == "pretrain_rain":
            # the style net itself is the trained network; no evaluator
            self.centroids_loaded = False
            self.state = create_pretrain_rain_state(cfg, rain)
            self.step_fn = build_step(cfg)
            self.evaluator = None
            return
        gen = torch.Generator().manual_seed(cfg.run.seed)
        seg = self._on_device(build_segmentor(cfg.model, generator=gen))
        if cfg.method in _CONTRASTIVE and seg.feat_dim != cfg.model.filters:
            raise ValueError(
                f"method {cfg.method!r} on backbone {cfg.model.backbone!r}: its decoder "
                f"features (dcdr_ft) are {seg.feat_dim} wide, the class centres "
                f"model.filters={cfg.model.filters} (set model.filters={seg.feat_dim})")
        if cfg.model.pretrained:
            # the ImageNet encoder, before the optimizers see the weights
            # (JAX trainer.py:235-270; a missing file raises)
            load_pretrained_encoder(seg, cfg.model.pretrained_ckpt, cfg.model.backbone)
        disc = disc_aux = None
        if cfg.method in _ADVERSARIAL:
            disc = self._on_device(UncertaintyDiscriminator(cfg.model.num_classes,
                                                            generator=gen))
            if cfg.model.multilvl:
                disc_aux = self._on_device(UncertaintyDiscriminator(cfg.model.num_classes,
                                                                    generator=gen))
        centroids = None
        self.centroids_loaded = False
        if cfg.method in ("mpscl", "slcl", "mccl"):
            centroids = self._initial_centroids()
        self.state = create_train_state(cfg, seg, disc=disc, disc_aux=disc_aux,
                                        centroids=centroids)
        if rain is not None:
            self.state.rain = rain.requires_grad_(False).eval()
            self.state.sampling = torch.zeros(rain_sampling_rows(cfg), LATENT,
                                              device=dev)
        self.step_fn = build_step(cfg, centroids_loaded=self.centroids_loaded)
        self.evaluator = self._evaluator(seg)

    def _on_device(self, net: nn.Module) -> nn.Module:
        return net.to(self.device, memory_format=torch.channels_last)

    def _adam_d(self, net: nn.Module) -> torch.optim.Optimizer:
        cfg = self.cfg
        return make_optimizer("adam", net.parameters(), cfg.optim.lr_dis,
                              betas=(cfg.adv.mmt1, cfg.adv.mmt))

    def _evaluator(self, model: nn.Module) -> Evaluator:
        cfg = self.cfg
        return Evaluator(model, self.device, eval_bs=cfg.data.eval_bs, klc=cfg.run.klc,
                         num_classes=cfg.model.num_classes,
                         autocast=lambda: autocast(cfg.model.dtype, self.device))

    def _build_ddfseg(self):
        """DDFNet + SegDecoder and three PatchGANs (Trainer_DDFSeg:55-112)."""
        cfg, d = self.cfg, self.cfg.ddfseg
        gen = torch.Generator().manual_seed(cfg.run.seed)
        seg = self._on_device(DDFSeg(cfg.model.num_classes, d.filters, d.style_filters,
                                     d.ngf, d.slim, generator=gen))
        d_t = self._on_device(PatchGAN(1, generator=gen))
        d_s = self._on_device(PatchGAN(1, aux=True, generator=gen))
        d_seg = self._on_device(PatchGAN(cfg.model.num_classes, generator=gen))
        self.state = TrainState(
            seg=seg, opt_seg=make_optimizer("adam", seg.parameters(), cfg.optim.lr),
            d_main=d_t, opt_d_main=self._adam_d(d_t), d_aux=d_s,
            opt_d_aux=self._adam_d(d_s), d_seg=d_seg, opt_d_seg=self._adam_d(d_seg),
            seed=cfg.run.seed)
        self.step_fn = build_step(cfg)
        self.evaluator = self._evaluator(seg)

    def _build_adaptevery(self):
        """ResNetUNetPoint and four discriminators (Trainer_AdaptEvery:51-110);
        ``model.base`` other than 64 scales the decoder too, as JAX does."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.run.seed)
        base = cfg.model.base
        kw = {} if base == 64 else {
            "base": base, "decoder_channels": tuple(max(2, base * 4 >> i) for i in range(5))}
        seg = self._on_device(ResNetUNetPoint(
            cfg.model.num_classes, layers=tuple(cfg.model.layers) or (3, 4, 6, 3),
            generator=gen, **kw))
        d_main, d_aux, d_ent = (self._on_device(UncertaintyDiscriminator(
            cfg.model.num_classes, base=base, generator=gen)) for _ in range(3))
        d_point = PointNetCls(k=1, base=base, generator=gen).to(self.device)
        self.state = TrainState(
            seg=seg, opt_seg=make_optimizer(cfg.optim.optimizer, seg.parameters(),
                                            cfg.optim.lr, momentum=cfg.optim.momentum,
                                            weight_decay=cfg.optim.weight_decay),
            d_main=d_main, opt_d_main=self._adam_d(d_main), d_aux=d_aux,
            opt_d_aux=self._adam_d(d_aux), d_ent=d_ent, opt_d_ent=self._adam_d(d_ent),
            d_point=d_point, opt_d_point=self._adam_d(d_point), seed=cfg.run.seed)
        self.step_fn = build_step(cfg)
        self.evaluator = self._evaluator(SegView(seg, lambda net, x: net(x)[0]))

    def _build_bcl(self):
        """BCLDeepLab with plain SGD (Trainer_BCL); pseudo-labels per round."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.run.seed)
        seg = self._on_device(BCLDeepLab(
            cfg.model.num_classes, layers=tuple(cfg.model.layers) or (3, 4, 23, 3),
            base=cfg.model.base, generator=gen))
        self.state = TrainState(
            seg=seg, opt_seg=make_optimizer("sgd", seg.parameters(), cfg.optim.lr,
                                            momentum=cfg.optim.momentum,
                                            weight_decay=cfg.optim.weight_decay),
            seed=cfg.run.seed)
        self.step_fn = build_step(cfg)
        self.bcl_plabels: Dict[str, np.ndarray] = {}

        def view(net, x):
            pred, feat = net(x, source=False)
            return SegOutput(pred=pred, aux=None, dcdr_ft=feat)
        self.evaluator = self._evaluator(SegView(seg, view))

    def bcl_update_plabels(self, prop: float) -> float:
        """The round's class-balanced pseudo-labels of every ``train_t`` image
        (Trainer_BCL.gene_thres + save_pred, :102-220; JAX trainer.py:486-
        517): the model in eval mode on the target stem, each pixel's max
        probability and argmax gathered on the host, per-class thresholds by
        :func:`gene_thres`, then the argmax where it reaches its class's
        threshold, else 255. Returns the share of pixels that keep a label."""
        cfg = self.cfg
        loader = Loader(self.datasets["train_t"], cfg.data.eval_bs, shuffle=False,
                        drop_last=False, num_threads=cfg.data.num_workers)
        confs, preds, names = [], [], []
        # whole images on every rank, outside any mesh, as the evaluator's
        with dp.use(None), self.evaluator.eval_mode():
            for img, _lab, batch_names in loader:
                with autocast(cfg.model.dtype, self.device):
                    logits, _ = self.state.seg(self.evaluator.to_device(img), source=False)
                conf, pred = torch.softmax(logits.float(), dim=-1).max(dim=-1)
                confs.append(conf.cpu().numpy())
                preds.append(pred.to(torch.uint8).cpu().numpy())
                names.extend(batch_names)
        conf, pred = np.concatenate(confs), np.concatenate(preds)
        th = gene_thres(conf.ravel(), pred.ravel(), prop, cfg.model.num_classes)
        plabels = np.where(conf >= th[pred], pred, 255).astype(np.int32)
        self.bcl_plabels = dict(zip(names, plabels))
        return float((plabels != 255).mean())

    def _initial_centroids(self) -> torch.Tensor:
        """The centre file when ``contrastive.init_centers`` names one (a
        configured but missing file raises rather than falling back to the
        zero-init bootstrap), else zeros that the first step replaces."""
        cfg = self.cfg
        shape = (cfg.model.num_classes, cfg.model.filters)
        path = cfg.contrastive.init_centers
        if not path:
            return torch.zeros(shape, dtype=torch.float32, device=self.device)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"contrastive.init_centers={path!r} does not exist (generate it "
                "with python -m slcl_torch.scripts.gen_class_centers)")
        arr = np.load(path)
        if arr.shape != shape:
            raise ValueError(f"centre file {path!r} has shape {arr.shape}, "
                             f"the model needs {shape}")
        self.centroids_loaded = True
        return torch.from_numpy(arr.astype(np.float32)).to(self.device)

    # ------------------------------------------------------------------
    def _sched(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        lr = schedules.get_lr(cfg.optim.lr_decay_method, cfg.optim.lr, epoch,
                              cfg.optim.epochs, cfg.optim.power,
                              cfg.optim.lr_end, cfg.optim.lr_decay)
        if 0 <= epoch < cfg.optim.lr_warmup_epochs:
            lr = lr * (epoch + 1) / cfg.optim.lr_warmup_epochs
        if cfg.optim.adjust_lr_dis:
            lr_dis = schedules.get_lr(cfg.optim.lr_decay_method, cfg.optim.lr_dis,
                                      epoch, cfg.optim.epochs, cfg.optim.power)
        else:
            lr_dis = cfg.optim.lr_dis
        warm = 1.0 if epoch >= cfg.contrastive.warmup_epochs else 0.0
        # RAIN: a fresh sampling at a batch's first epsilon iteration, the
        # ascent once warm
        eps_on = 1.0 if warm > 0 and cfg.rain.enabled and cfg.rain.update_eps else 0.0
        return {"lr": float(lr), "lr_dis": float(lr_dis), "warm": warm, "fresh": 1.0,
                "eps_on": eps_on}

    def _spatial_rows(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Under spatial partitioning, this model rank's band of the image
        rows of ``batch``'s ``img_*``, ``lab_*`` and ``plabel_*`` arrays."""
        if self.mesh is None or not self.mesh.spatial:
            return batch
        return {k: np.ascontiguousarray(dp.spatial_rows(v, k, self.mesh))
                if k.split("_")[0] in _SPATIAL_KEYS and isinstance(v, np.ndarray)
                and v.ndim >= 3 else v for k, v in batch.items()}

    def _epoch_batches(self) -> Iterable[Dict[str, Any]]:
        """This rank's rows of each global batch (all of it on one process;
        under spatial partitioning its band of their image rows)."""
        for batch in self._loader_batches():
            yield self._spatial_rows(batch)

    def _loader_batches(self) -> Iterable[Dict[str, Any]]:
        """This data rank's rows of each global batch."""
        cfg = self.cfg
        rows = (0, 1) if self.mesh is None else (self.mesh.data_rank, self.mesh.data_size)
        train_s = Loader(self.datasets["train_s"], cfg.data.bs, seed=cfg.data.seed,
                         num_threads=cfg.data.num_workers, rows=rows)
        train_t = Loader(self.datasets["train_t"], cfg.data.bs,
                         seed=cfg.data.seed + 17, num_threads=cfg.data.num_workers,
                         rows=rows)
        if cfg.method == "baseline":
            if cfg.data.train_with_t and not cfg.data.train_with_s:
                # supervised-target oracle (Trainer_baseline.py:221-227)
                for batch in train_t:
                    yield {"img_t": batch[0], "lab_t": batch[1]}
                return
            for batch in train_s:
                yield {"img_s": batch[0], "lab_s": batch[1]}
            return
        for batch in zip_domains(train_s, train_t, aug_counter=cfg.data.aug_counter):
            if cfg.method == "bcl":
                # the round's pseudo-labels; an image without one is ignored
                blank = np.full(batch["img_t"].shape[1:3], 255, np.int32)
                batch["plabel_t"] = np.stack([self.bcl_plabels.get(n, blank)
                                              for n in batch["names_t"]])
            yield batch

    def build_multi_step(self, capture: bool = True) -> MultiStep:
        """A ``run.scan_steps`` runner of this state: the method's step built
        with staged draws (``multistep.StagedDraws``); ``capture`` replays a
        CUDA graph on a CUDA device. On CUDA it puts the optimizers in their
        capturable form."""
        draws = StagedDraws()
        step = build_step(self.cfg, centroids_loaded=self.centroids_loaded, **draws.hooks())
        return make_multi_step(step, draws, self.state, self.device, capture=capture)

    def train_steps(self, batches: Iterable[Dict[str, torch.Tensor]],
                    sched: Dict[str, float]) -> tuple:
        """One step a batch of ``batches`` (on the device), ``rain.eps_iters``
        a batch under the ascent: ``(summed metrics, steps)``. With
        ``run.scan_steps=K`` > 1 and one iteration a batch, whole groups of K
        batches go through ``self.multi`` (made at first use), the rest
        through the plain step, in order."""
        cfg = self.cfg
        carried = {**sched, "fresh": 0.0}
        eps_iters = max(1, cfg.rain.eps_iters) if sched["eps_on"] else 1
        K = max(1, int(cfg.run.scan_steps))
        if K > 1 and eps_iters == 1 and not self.scan_eager and self.multi is None:
            self.multi = self.build_multi_step()
        multi = self.multi if K > 1 and eps_iters == 1 and not self.scan_eager else None
        acc: Dict[str, torch.Tensor] = {}
        n = 0

        def plain(group):
            nonlocal n
            for batch in group:
                for it in range(eps_iters):
                    metrics = self.step_fn(self.state, batch, carried if it else sched)
                    for k, v in metrics.items():
                        acc[k] = acc[k] + v if k in acc else v
                    n += 1

        group: list = []
        with dp.use(self.mesh):
            for batch in batches:
                if multi is None or not multi.fits(batch):
                    plain(group + [batch])
                    group = []
                    continue
                group.append(batch)
                if len(group) == K:
                    multi(self.state, group, sched, acc)
                    n += K
                    group = []
            plain(group)                  # the tail
        return acc, n

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch; returns the mean of each metric (one host sync). Under
        RAIN's ascent each batch runs ``rain.eps_iters`` iterations after
        warmup, a fresh sampling on the first (Trainer_MCCL.py:189-192);
        each counts in the mean. BCL renews its pseudo-labels first on a
        round's epoch; ``plabel_kept`` is then the share of target pixels
        that have one. ``run.scan_steps``: :meth:`train_steps`."""
        cfg = self.cfg
        kept = None
        if cfg.method == "bcl" and epoch % max(cfg.run.bcl_round_epochs, 1) == 0:
            kept = self.bcl_update_plabels(cfg.run.bcl_prop)
        acc, n = self.train_steps(device_prefetch(self._epoch_batches(), self.device,
                                                  size=self.cfg.data.prefetch),
                                  self._sched(epoch))
        out = {}
        if acc:
            values = torch.stack(list(acc.values())).cpu().tolist()
            out = {k: v / n for k, v in zip(acc, values)}
        if kept is not None:
            out["plabel_kept"] = kept
        return out

    def eval(self, split: str = "valid_t", toprint: bool = False, ifhd: bool = True,
             ifasd: bool = True, fast: bool = False) -> Dict[str, list]:
        loader = Loader(self.datasets[split], self.cfg.data.eval_bs, shuffle=False,
                        drop_last=False, num_threads=self.cfg.data.num_workers)
        # whole images on every rank, outside any mesh (JAX's evaluator)
        with dp.use(None):
            if fast:
                return self.evaluator.evaluate_fast(loader)
            return self.evaluator.evaluate_single_dataset(loader, ifhd=ifhd, ifasd=ifasd,
                                                          toprint=toprint)

    # ------------------------------------------------------------------
    def checkpoint_path(self, tag: str) -> Path:
        """``tag`` as a path when it names an existing file or is absolute,
        else ``<out_dir>/ckpt_<tag>.pt``."""
        p = Path(tag)
        if p.is_absolute() or p.is_file():
            return p
        return self.out_dir / f"ckpt_{tag}.pt"

    def save_checkpoint(self, tag: str = "last") -> Path:
        """Write ``ckpt_<tag>.pt``; sharded tensors are gathered whole (every
        rank takes part), rank 0 writes, and every rank waits for the file."""
        s = self.state
        ckpt = {name: dp.full_state_dict(getattr(s, name)) if getattr(s, name) is not None
                else None for name in _NETS + _OPTS}
        for name in _OPTS:
            if ckpt[name] is not None:
                ckpt[name] = plain_optimizer_state(ckpt[name])
        ckpt.update(centroids=s.centroids, sampling=s.sampling, step=s.step, seed=s.seed,
                    method=self.cfg.method)
        path = self.out_dir / f"ckpt_{tag}.pt"
        if self.writer:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(ckpt, tmp)
            os.replace(tmp, path)
        if dist_initialized():
            barrier()
        return path

    def restore_checkpoint(self, tag: str = "best", params_only: bool = False) -> None:
        """Restore the full state (modules, optimizers, centres, step, seed), or with
        ``params_only`` the networks' weights and BatchNorm buffers alone,
        merged by name: entries the checkpoint lacks keep their fresh init,
        entries the model lacks are ignored (both are reported), and a shape
        mismatch raises. So an AdvEnt checkpoint warm-starts ``slcl``. Either
        drops the ``run.scan_steps`` graph, which holds the replaced
        tensors' addresses; the next epoch captures again."""
        self.multi = None
        path = self.checkpoint_path(tag)
        if dist_initialized():
            # rank 0 reads (its host holds what it wrote) and sends the
            # whole checkpoint: the ranks need no shared filesystem
            ckpt = dp.from_writer(lambda: torch.load(path, map_location="cpu",
                                                     weights_only=True))
        else:
            ckpt = torch.load(path, map_location=self.device, weights_only=True)
        s = self.state
        if not params_only:
            for name in _NETS + _OPTS:
                obj = getattr(s, name)
                if obj is not None:
                    if ckpt.get(name) is None:
                        raise KeyError(f"checkpoint {path} has no {name!r}")
                    dp.load_full_state_dict(obj, ckpt[name])
                    if (name in _OPTS and self.device.type == "cuda"
                            and not any(dp.is_dtensor(p) for g in obj.param_groups
                                        for p in g["params"])):
                        capturable(obj)          # the checkpoint's form is plain
            if s.centroids is not None:
                if ckpt.get("centroids") is None:
                    raise KeyError(f"checkpoint {path} has no class centres")
                s.centroids = ckpt["centroids"].to(self.device, torch.float32)
            if s.sampling is not None:
                if ckpt.get("sampling") is None:
                    raise KeyError(f"checkpoint {path} has no RAIN sampling")
                s.sampling = ckpt["sampling"].to(self.device, torch.float32)
            s.step = int(ckpt["step"])
            s.seed = int(ckpt.get("seed", s.seed))
            return
        kept, dropped, loaded = [], [], 0
        for name in _NETS:
            module, saved = getattr(s, name), ckpt.get(name)
            if module is None or saved is None:
                continue
            fresh = dp.full_state_dict(module)
            merged = {}
            for k, v in fresh.items():
                if k not in saved:
                    merged[k] = v
                    kept.append(f"{name}.{k}")
                    continue
                if tuple(saved[k].shape) != tuple(v.shape):
                    raise ValueError(f"checkpoint entry {name}.{k} has shape "
                                     f"{tuple(saved[k].shape)}, the model expects "
                                     f"{tuple(v.shape)}")
                merged[k] = saved[k]
            dropped.extend(f"{name}.{k}" for k in saved if k not in fresh)
            dp.load_full_state_dict(module, merged)
            loaded += 1
        if not loaded:
            raise ValueError(f"no network state found in checkpoint {path}")
        if kept:
            print(f"warm start: kept fresh init for {len(kept)} entries absent from "
                  f"the checkpoint: {', '.join(kept[:8])}" + (" ..." if len(kept) > 8 else ""))
        if dropped:
            print(f"warm start: checkpoint entries without a model counterpart "
                  f"ignored: {', '.join(dropped[:8])}" + (" ..." if len(dropped) > 8 else ""))

    # ------------------------------------------------------------------
    def stop_training(self, epoch: int, epoch_time: float) -> bool:
        """Wall-clock budget + dice-plateau early stop (Trainer.py:209-224)."""
        cfg = self.cfg
        self.longest_epoch = max(self.longest_epoch, epoch_time)
        elapsed = time.time() - self.start_time
        if elapsed + self.longest_epoch + 30 * 60 > cfg.run.max_duration_s:
            return True
        if cfg.run.early_stop_patience and self.best_epoch >= 0:
            if epoch - self.best_epoch >= cfg.run.early_stop_patience:
                return True
        return False

    def _log(self, path: Path, record: Dict[str, Any]) -> None:
        self.history.append(record)
        if self.writer:
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _val_dice(self, split: str = "valid_t") -> float:
        """Mean foreground Dice of ``split``; rank 0's, on every rank."""
        return dp.broadcast_value(mean_fg_dice(self.eval(
            split, ifhd=False, ifasd=False, fast=self.cfg.run.fast_val)))

    def train(self) -> Dict[str, Any]:
        """Train ``optim.epochs`` epochs, validate, checkpoint, then test the
        best checkpoint; returns the summary written to ``summary.json``."""
        cfg = self.cfg
        if self.writer:
            self.out_dir.mkdir(parents=True, exist_ok=True)
        log_path = self.out_dir / "log.jsonl"
        mcp = ModelCheckPointCallback(
            str(self.out_dir), self.save_checkpoint, mode="max",
            save_every_epochs=cfg.run.save_every_epochs, n_epochs=cfg.optim.epochs,
            apdx=self.apdx[:60])
        early = EarlyStopCallback(cfg.run.early_stop_patience, mode="max")
        tb = TBWriter(str(self.out_dir / "tb"), enabled=self.writer)
        if cfg.run.init_from:
            # warm start of the networks; raises on failure, since random
            # weights would invalidate the recipe
            self.restore_checkpoint(cfg.run.init_from, params_only=True)
            print(f"warm-started networks from '{cfg.run.init_from}'")
        if cfg.run.init_from and cfg.method != "pretrain_rain":
            # the init's own validation ("epoch -1") seeds best-checkpoint
            # selection, so a fine-tune that never beats its init ships it
            dice = self._val_dice()
            if mcp.step(dice, -1):
                self.best_score = dice
            early.step(dice, -1)
            self._log(log_path, {"epoch": -1, "val_dice": dice})
            print(f"[{self.apdx}] init val_dice={dice:.4f}")
        if cfg.run.restore_from:
            try:
                self.restore_checkpoint(cfg.run.restore_from)
                print(f"resumed from checkpoint '{cfg.run.restore_from}'")
            except (OSError, KeyError, ValueError, RuntimeError) as e:
                print(f"restore failed ({e}); training from scratch")
        profile_epoch = cfg.run.profile_epoch
        if cfg.run.profile_dir and profile_epoch >= cfg.optim.epochs:
            # a run shorter than profile_epoch would write no trace: clamp to
            # the last epoch that runs (JAX trainer.py:825-831)
            profile_epoch = cfg.optim.epochs - 1
            print(f"run.profile_epoch clamped to {profile_epoch} "
                  f"(run has only {cfg.optim.epochs} epoch(s))")
        for epoch in range(cfg.optim.epochs):
            t0 = time.time()
            profiled = (cfg.run.profile_dir if epoch == profile_epoch and self.writer
                        else None)
            with profile_trace(profiled, cuda=self.device.type == "cuda"):
                train_metrics = self.train_epoch(epoch)
            record: Dict[str, Any] = {"epoch": epoch, **train_metrics}
            if cfg.method == "pretrain_rain":
                # no validation: the least summed loss is the best
                # (Pretrainer_RAIN.py:216-227)
                record["score"] = -sum(record.get(k, 0.0) for k in PRETRAIN_LOSSES)
                if mcp.step(record["score"], epoch):
                    self.best_score = record["score"]
                    self.best_epoch = epoch
            elif (epoch + 1) % cfg.run.eval_frequency == 0 or epoch == cfg.optim.epochs - 1:
                # per-epoch validation is Dice only; HD95/ASSD at the final test
                dice = self._val_dice()
                record["val_dice"] = dice
                if cfg.run.evalT and "test_t" in self.datasets:
                    record["test_dice"] = self._val_dice("test_t")
                if mcp.step(dice, epoch):
                    self.best_score = dice
                    self.best_epoch = epoch
                if early.step(dice, epoch):
                    record["early_stop"] = True
            epoch_time = time.time() - t0
            record["epoch_time_s"] = round(epoch_time, 3)
            tb.scalars(record, epoch + 1)
            self._log(log_path, record)
            if epoch == 5 and "dice_style_c1" in record and self.writer:
                # the early window is complete: the MCCL + RAIN collapse check
                for w in stylized_branch_triggers(self.history):
                    print(f"[{self.apdx}] {w}")
            if self.writer:
                print(f"[{self.apdx}] " + " ".join(
                    f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in record.items()), flush=True)
            if dp.broadcast_value(bool(record.get("early_stop"))
                                  or self.stop_training(epoch, epoch_time)):
                print("early stop / wall-clock budget reached")
                mcp.finalize()
                break
        tb.close()
        self.save_checkpoint("last")
        if cfg.method == "pretrain_rain":
            return self._export_rain()
        # final test with the best checkpoint, target and source domains
        if mcp.wrote_best:
            # the best may be the epoch -1 warm-start eval (init_from)
            self.restore_checkpoint("best")
        elif self.checkpoint_path("best").exists():
            # a ckpt_best this run did not write is a stale leftover of an
            # earlier run in the same out_dir: test the last state instead
            print("warning: ignoring stale ckpt_best not written by this run; "
                  "final test uses the last-state weights")
        test_results = self.eval("test_t", toprint=self.writer)
        test_s_results = (self.eval("test_s", toprint=self.writer)
                          if "test_s" in self.datasets else None)
        summary = {"best_epoch": self.best_epoch, "best_val_dice": self.best_score,
                   "test": test_results, "test_s": test_s_results,
                   "test_t_other_fold": self.test_other_fold(), "history": self.history}
        if self.writer:
            with open(self.out_dir / "summary.json", "w") as f:
                json.dump(summary, f, indent=2)
        return summary

    def test_other_fold(self) -> Optional[Dict[str, list]]:
        """``baseline`` on MMWHS: the test of the other cross-validation fold
        (Trainer_baseline.py:308-339; JAX trainer.py:925-934), or None, with
        a note, when its files are absent or it cannot be evaluated."""
        cfg = self.cfg
        if cfg.method != "baseline" or cfg.data.dataset != "mmwhs":
            return None
        other = copy.deepcopy(cfg)
        other.data.fold = 1 - cfg.data.fold
        try:
            self.datasets["test_t_other_fold"] = prepare_datasets(other)["test_t"]
            return self.eval("test_t_other_fold", toprint=True)
        except Exception as e:  # the JAX trainer's: any failure is a skip
            print(f"other-fold eval skipped ({e})")
            return None

    def _export_rain(self) -> Dict[str, Any]:
        """``pretrain_rain``'s end: each part of the trained net as the JAX
        package's ``.npz`` tree (what ``rain.*_ckpt`` load), and the summary."""
        params = state_dict_to_flax(self.state.seg)["params"]
        paths = {name: str(self.out_dir / f"rain_{name}.npz") for name, _ in RAIN_PARTS}
        summary = {"best_epoch": self.best_epoch, "best_score": self.best_score,
                   "history": self.history, "component_ckpts": paths}
        if self.writer:
            for name, path in paths.items():
                save_tree_npz(path, params=params[name])
            with open(self.out_dir / "summary.json", "w") as f:
                json.dump(summary, f, indent=2)
        return summary
