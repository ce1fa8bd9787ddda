"""Training orchestration, main-path subset (counterpart of
``slcl_tpu/train/trainer.py``).

``Trainer(cfg, device=None)`` builds DRUNet, the two entropy-map
discriminators, the optimizers and the ``slcl``/``mpscl`` step, and runs the
epoch loop with per-epoch LR (poly by default). It runs on CUDA unless the
caller passes ``device="cpu"``; with no CUDA device and no explicit device
it raises. Evaluation, checkpoints and centre files are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from .. import DeviceLike, resolve_device
from ..config import Config, build_apdx
from ..data import Loader, device_prefetch, prepare_datasets, zip_domains
from ..models import UncertaintyDiscriminator, build_segmentor
from . import schedules
from .state import create_train_state
from .steps import build_step

_PORTED = ("mpscl", "slcl")


class Trainer:
    def __init__(self, cfg: Config, datasets: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        """``datasets``: dict with 'train_s' and 'train_t' (objects with
        __len__/__getitem__); the synthetic set when None."""
        if cfg.method not in _PORTED:
            raise NotImplementedError(
                f"method {cfg.method!r}: slcl_torch ports {_PORTED} only")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.apdx = build_apdx(cfg)
        self.datasets = datasets or prepare_datasets(cfg)
        self.history: list = []
        self._build()

    def _build(self):
        cfg = self.cfg
        dev = self.device
        gen = torch.Generator().manual_seed(cfg.run.seed)
        seg = build_segmentor(cfg.model, generator=gen)
        disc = UncertaintyDiscriminator(cfg.model.num_classes, generator=gen)
        disc_aux = (UncertaintyDiscriminator(cfg.model.num_classes, generator=gen)
                    if cfg.model.multilvl else None)
        fmt = torch.channels_last
        seg = seg.to(dev, memory_format=fmt)
        disc = disc.to(dev, memory_format=fmt)
        if disc_aux is not None:
            disc_aux = disc_aux.to(dev, memory_format=fmt)
        # zero-init centres; the step adopts the first batch means outright
        # (centre files are not ported yet)
        centroids = torch.zeros((cfg.model.num_classes, cfg.model.filters),
                                dtype=torch.float32, device=dev)
        self.state = create_train_state(cfg, seg, disc=disc, disc_aux=disc_aux,
                                        centroids=centroids)
        self.step_fn = build_step(cfg, centroids_loaded=False)

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
        return {"lr": float(lr), "lr_dis": float(lr_dis), "warm": warm}

    def _epoch_batches(self) -> Iterable[Dict[str, Any]]:
        cfg = self.cfg
        train_s = Loader(self.datasets["train_s"], cfg.data.bs, seed=cfg.data.seed,
                         num_threads=cfg.data.num_workers)
        train_t = Loader(self.datasets["train_t"], cfg.data.bs,
                         seed=cfg.data.seed + 17, num_threads=cfg.data.num_workers)
        yield from zip_domains(train_s, train_t, aug_counter=cfg.data.aug_counter)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch; returns the mean of each metric (one host sync)."""
        sched = self._sched(epoch)
        acc: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in device_prefetch(self._epoch_batches(), self.device,
                                     size=self.cfg.data.prefetch):
            metrics = self.step_fn(self.state, batch, sched)
            for k, v in metrics.items():
                acc[k] = acc[k] + v if k in acc else v
            n += 1
        if not acc:
            return {}
        values = torch.stack(list(acc.values())).cpu().tolist()
        return {k: v / n for k, v in zip(acc, values)}

    def train(self) -> Dict[str, float]:
        """Run ``optim.epochs`` epochs; returns the last epoch's mean metrics
        (every epoch's are in ``self.history``)."""
        means: Dict[str, float] = {}
        for epoch in range(self.cfg.optim.epochs):
            means = self.train_epoch(epoch)
            self.history.append({"epoch": epoch, **means})
        return means
