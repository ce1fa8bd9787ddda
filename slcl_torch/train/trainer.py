"""Training orchestration (counterpart of ``slcl_tpu/train/trainer.py``) for
``method`` in ``baseline``/``adaptseg``/``advent``/``mpscl``/``slcl``/``mccl``/
``rain``/``pretrain_rain``.

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

Config keys the port does not honour yet raise at construction:
``run.scan_steps`` other than 1, ``model.remat`` and ``run.profile_dir``.
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

from .. import DeviceLike, resolve_device
from ..config import Config, build_apdx
from ..data import Loader, device_prefetch, prepare_datasets, zip_domains
from ..eval.evaluator import Evaluator, mean_fg_dice
from ..models import UncertaintyDiscriminator, build_segmentor
from ..models.rain import LATENT, RAIN
from ..utils.convert import read_rain_component, save_tree_npz, state_dict_to_flax
from ..utils.pretrained import load_pretrained_encoder
from ..utils.callbacks import EarlyStopCallback, ModelCheckPointCallback
from . import schedules
from .state import create_pretrain_rain_state, create_train_state, rain_sampling_rows
from .steps import autocast, build_step

_PORTED = ("baseline", "adaptseg", "advent", "mpscl", "slcl", "mccl", "rain",
           "pretrain_rain")
_ADVERSARIAL = ("adaptseg", "advent", "mpscl", "slcl")
_CONTRASTIVE = ("mpscl", "slcl", "mccl")
_NETS = ("seg", "d_main", "d_aux", "rain")
_OPTS = ("opt_seg", "opt_d_main", "opt_d_aux")
# RAIN's component files: (the net's part, its config key)
RAIN_PARTS = (("encoder", "vgg_ckpt"), ("decoder", "decoder_ckpt"),
              ("fc_encoder", "fc_encoder_ckpt"), ("fc_decoder", "fc_decoder_ckpt"))
PRETRAIN_LOSSES = ("loss_c", "loss_s", "loss_l", "loss_r")


def check_ported_keys(cfg: Config) -> None:
    """Raise on a config key the port would accept and then ignore (the JAX
    package honours each): the scan over several steps, rematerialisation
    and the profiler trace. Each names the ROADMAP item that ports it."""
    if int(cfg.run.scan_steps) != 1:
        raise NotImplementedError(
            f"run.scan_steps={cfg.run.scan_steps}: slcl_torch runs one step per "
            "dispatch (CUDA-graph replay of the step: ROADMAP queue 1, the "
            "host-bound step)")
    if str(cfg.model.remat).lower() not in ("", "0", "false", "off"):
        raise NotImplementedError(
            f"model.remat={cfg.model.remat!r}: slcl_torch has no rematerialisation "
            "yet (torch.utils.checkpoint: ROADMAP queue 1, small utilities)")
    if cfg.run.profile_dir:
        raise NotImplementedError(
            f"run.profile_dir={cfg.run.profile_dir!r}: slcl_torch writes no "
            "profiler trace yet (torch.profiler: ROADMAP queue 1, small utilities)")


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
        self.cfg = cfg
        # method-implied data: MCCL pairs each target image with a second
        # view (JAX trainer.py:89-90); before the datasets are built
        if cfg.method == "mccl":
            cfg.data.aug_counter = True
        self.device = resolve_device(device)
        self.apdx = build_apdx(cfg)
        # created on first write: eval-only users (gen_class_centers,
        # evaluate) leave no empty run directories
        self.out_dir = Path(cfg.run.out_dir) / self.apdx
        self.datasets = datasets or prepare_datasets(cfg)
        self._build()
        self.history: list = []
        self.best_score = -np.inf
        self.best_epoch = -1
        self.start_time = time.time()
        self.longest_epoch = 0.0

    def _build(self):
        cfg = self.cfg
        dev = self.device
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
        fmt = torch.channels_last
        seg = build_segmentor(cfg.model, generator=gen).to(dev, memory_format=fmt)
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
            disc = UncertaintyDiscriminator(cfg.model.num_classes, generator=gen).to(
                dev, memory_format=fmt)
            if cfg.model.multilvl:
                disc_aux = UncertaintyDiscriminator(cfg.model.num_classes,
                                                    generator=gen).to(dev, memory_format=fmt)
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
        self.evaluator = Evaluator(seg, dev, eval_bs=cfg.data.eval_bs, klc=cfg.run.klc,
                                   num_classes=cfg.model.num_classes,
                                   autocast=lambda: autocast(cfg.model.dtype, dev))

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

    def _epoch_batches(self) -> Iterable[Dict[str, Any]]:
        cfg = self.cfg
        train_s = Loader(self.datasets["train_s"], cfg.data.bs, seed=cfg.data.seed,
                         num_threads=cfg.data.num_workers)
        train_t = Loader(self.datasets["train_t"], cfg.data.bs,
                         seed=cfg.data.seed + 17, num_threads=cfg.data.num_workers)
        if cfg.method == "baseline":
            if cfg.data.train_with_t and not cfg.data.train_with_s:
                # supervised-target oracle (Trainer_baseline.py:221-227)
                for batch in train_t:
                    yield {"img_t": batch[0], "lab_t": batch[1]}
                return
            for batch in train_s:
                yield {"img_s": batch[0], "lab_s": batch[1]}
            return
        yield from zip_domains(train_s, train_t, aug_counter=cfg.data.aug_counter)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch; returns the mean of each metric (one host sync). Under
        RAIN's ascent each batch runs ``rain.eps_iters`` iterations after
        warmup, a fresh sampling on the first (Trainer_MCCL.py:189-192);
        each counts in the mean."""
        cfg = self.cfg
        sched = self._sched(epoch)
        carried = {**sched, "fresh": 0.0}
        eps_iters = max(1, cfg.rain.eps_iters) if sched["eps_on"] else 1
        acc: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in device_prefetch(self._epoch_batches(), self.device,
                                     size=self.cfg.data.prefetch):
            for it in range(eps_iters):
                metrics = self.step_fn(self.state, batch, carried if it else sched)
                for k, v in metrics.items():
                    acc[k] = acc[k] + v if k in acc else v
                n += 1
        if not acc:
            return {}
        values = torch.stack(list(acc.values())).cpu().tolist()
        return {k: v / n for k, v in zip(acc, values)}

    def eval(self, split: str = "valid_t", toprint: bool = False, ifhd: bool = True,
             ifasd: bool = True, fast: bool = False) -> Dict[str, list]:
        loader = Loader(self.datasets[split], self.cfg.data.eval_bs, shuffle=False,
                        drop_last=False, num_threads=self.cfg.data.num_workers)
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
        s = self.state
        ckpt = {name: getattr(s, name).state_dict() if getattr(s, name) is not None
                else None for name in _NETS + _OPTS}
        ckpt.update(centroids=s.centroids, sampling=s.sampling, step=s.step, seed=s.seed,
                    method=self.cfg.method)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"ckpt_{tag}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
        return path

    def restore_checkpoint(self, tag: str = "best", params_only: bool = False) -> None:
        """Restore the full state (modules, optimizers, centres, step, seed), or with
        ``params_only`` the networks' weights and BatchNorm buffers alone,
        merged by name: entries the checkpoint lacks keep their fresh init,
        entries the model lacks are ignored (both are reported), and a shape
        mismatch raises. So an AdvEnt checkpoint warm-starts ``slcl``."""
        path = self.checkpoint_path(tag)
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        s = self.state
        if not params_only:
            for name in _NETS + _OPTS:
                obj = getattr(s, name)
                if obj is not None:
                    if ckpt.get(name) is None:
                        raise KeyError(f"checkpoint {path} has no {name!r}")
                    obj.load_state_dict(ckpt[name])
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
            fresh = module.state_dict()
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
            module.load_state_dict(merged)
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
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def train(self) -> Dict[str, Any]:
        """Train ``optim.epochs`` epochs, validate, checkpoint, then test the
        best checkpoint; returns the summary written to ``summary.json``."""
        cfg = self.cfg
        self.out_dir.mkdir(parents=True, exist_ok=True)
        log_path = self.out_dir / "log.jsonl"
        mcp = ModelCheckPointCallback(
            str(self.out_dir), self.save_checkpoint, mode="max",
            save_every_epochs=cfg.run.save_every_epochs, n_epochs=cfg.optim.epochs,
            apdx=self.apdx[:60])
        early = EarlyStopCallback(cfg.run.early_stop_patience, mode="max")
        if cfg.run.init_from:
            # warm start of the networks; raises on failure, since random
            # weights would invalidate the recipe
            self.restore_checkpoint(cfg.run.init_from, params_only=True)
            print(f"warm-started networks from '{cfg.run.init_from}'")
        if cfg.run.init_from and cfg.method != "pretrain_rain":
            # the init's own validation ("epoch -1") seeds best-checkpoint
            # selection, so a fine-tune that never beats its init ships it
            dice = mean_fg_dice(self.eval("valid_t", ifhd=False, ifasd=False,
                                          fast=cfg.run.fast_val))
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
        for epoch in range(cfg.optim.epochs):
            t0 = time.time()
            record: Dict[str, Any] = {"epoch": epoch, **self.train_epoch(epoch)}
            if cfg.method == "pretrain_rain":
                # no validation: the least summed loss is the best
                # (Pretrainer_RAIN.py:216-227)
                record["score"] = -sum(record.get(k, 0.0) for k in PRETRAIN_LOSSES)
                if mcp.step(record["score"], epoch):
                    self.best_score = record["score"]
                    self.best_epoch = epoch
            elif (epoch + 1) % cfg.run.eval_frequency == 0 or epoch == cfg.optim.epochs - 1:
                # per-epoch validation is Dice only; HD95/ASSD at the final test
                dice = mean_fg_dice(self.eval("valid_t", ifhd=False, ifasd=False,
                                              fast=cfg.run.fast_val))
                record["val_dice"] = dice
                if cfg.run.evalT and "test_t" in self.datasets:
                    record["test_dice"] = mean_fg_dice(self.eval(
                        "test_t", ifhd=False, ifasd=False, fast=cfg.run.fast_val))
                if mcp.step(dice, epoch):
                    self.best_score = dice
                    self.best_epoch = epoch
                if early.step(dice, epoch):
                    record["early_stop"] = True
            epoch_time = time.time() - t0
            record["epoch_time_s"] = round(epoch_time, 3)
            self._log(log_path, record)
            if epoch == 5 and "dice_style_c1" in record:
                # the early window is complete: the MCCL + RAIN collapse check
                for w in stylized_branch_triggers(self.history):
                    print(f"[{self.apdx}] {w}")
            print(f"[{self.apdx}] " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()), flush=True)
            if record.get("early_stop") or self.stop_training(epoch, epoch_time):
                print("early stop / wall-clock budget reached")
                mcp.finalize()
                break
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
        test_results = self.eval("test_t", toprint=True)
        test_s_results = (self.eval("test_s", toprint=True)
                          if "test_s" in self.datasets else None)
        summary = {"best_epoch": self.best_epoch, "best_val_dice": self.best_score,
                   "test": test_results, "test_s": test_s_results,
                   "test_t_other_fold": self.test_other_fold(), "history": self.history}
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
        for name, path in paths.items():
            save_tree_npz(path, params=params[name])
        summary = {"best_epoch": self.best_epoch, "best_score": self.best_score,
                   "history": self.history, "component_ckpts": paths}
        with open(self.out_dir / "summary.json", "w") as f:
            json.dump(summary, f, indent=2)
        return summary
