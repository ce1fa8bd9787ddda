"""Evaluator: per-epoch validation and final test metrics.

Counterpart of ``slcl_tpu/eval/evaluator.py``: batched inference on the
device in eval mode (argmax on the device, one pinned non-blocking copy per
batch to the host, one wait at the end), then keep-largest-connected-
component and the surface metrics (HD95/ASSD) on the host in a thread
pool. ``evaluate_fast`` keeps the Dice on the device too and reads it back
once per evaluation.

Returns ``{'dc': [m1, s1, m2, s2, m3, s3], 'hd': ..., 'asd': ...}``: mean
and std interleaved per foreground class (MYO, LV, RV).
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops import metrics as M


_THREADS = 8


def evaluate_arrays(preds: np.ndarray, gts: np.ndarray, *, ifhd: bool = True,
                    ifasd: bool = True, klc: bool = True,
                    num_classes: int = 4) -> Dict[str, list]:
    """Aggregate per-slice per-class metrics over stacked label maps (HD95,
    unit spacing). The surface metrics (scipy EDT, which releases the GIL)
    run in a thread pool when there are enough slices."""
    class_ids = tuple(range(1, num_classes))
    per_class = {c: {"dc": [], "hd": [], "asd": []} for c in class_ids}

    def one(args):
        pred, gt = args
        if klc:
            pred = M.keep_largest_connected_components(pred, class_ids)
        return M.metrics_per_class(gt, pred, apply_hd=ifhd, apply_asd=ifasd,
                                   class_ids=class_ids)

    if len(preds) > 4 and (ifhd or ifasd):
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(_THREADS) as pool:
            all_res = list(pool.map(one, zip(preds, gts)))
    else:
        all_res = [one(pg) for pg in zip(preds, gts)]
    for res in all_res:
        for c in class_ids:
            d, h, a = res[c]
            per_class[c]["dc"].append(d)
            per_class[c]["hd"].append(h)
            per_class[c]["asd"].append(a)
    out = {"dc": [], "hd": [], "asd": []}
    for c in class_ids:
        for k in ("dc", "hd", "asd"):
            vals = np.asarray(per_class[c][k], np.float64)
            out[k].extend([float(np.mean(vals)), float(np.std(vals))])
    return out


class Evaluator:
    """Batched on-device inference of ``model`` + host metric aggregation.
    ``autocast`` returns the context the forward runs in (the step's)."""

    def __init__(self, model: nn.Module, device: torch.device, *, eval_bs: int = 32,
                 klc: bool = True, num_classes: int = 4,
                 autocast: Optional[Callable[[], ContextManager]] = None):
        self.model = model
        self.device = torch.device(device)
        self.eval_bs = eval_bs
        self.klc = klc
        self.num_classes = num_classes
        self.autocast = autocast or contextlib.nullcontext

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the evaluator's device (pinned, non-blocking); a
        floating one in torch's default dtype, as the Loader's batches."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        dtype = torch.get_default_dtype() if t.is_floating_point() else None
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, dtype=dtype, non_blocking=True)
        return t.to(self.device, dtype=dtype)

    @contextlib.contextmanager
    def eval_mode(self):
        """The model in eval mode without autograd; its mode is restored."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            self.model.train(was_training)

    def _argmax(self, img: np.ndarray) -> torch.Tensor:
        with self.autocast():
            out = self.model(self.to_device(img))
        return torch.argmax(out.pred.float(), dim=-1)

    def predict(self, loader) -> tuple:
        """Label maps for a loader of (img, mask, name) batches: argmax on the
        device, one non-blocking copy per batch into pinned host memory, one
        wait for all of them at the end."""
        preds, gts = [], []
        cuda = self.device.type == "cuda"
        with self.eval_mode():
            for img, mask, _names in loader:
                pred = self._argmax(img).to(torch.uint8)
                host = torch.empty(pred.shape, dtype=pred.dtype, pin_memory=cuda)
                host.copy_(pred, non_blocking=cuda)
                preds.append(host)
                gts.append(np.asarray(mask))
        if cuda:
            torch.cuda.synchronize(self.device)
        return (np.concatenate([p.numpy().astype(np.int64) for p in preds]),
                np.concatenate(gts))

    def evaluate_fast(self, loader) -> Dict[str, list]:
        """Dice-only validation computed on the device: one readback per
        evaluation. No KLC: for per-epoch checkpoint selection only, never
        the final table."""
        chunks = []
        with self.eval_mode():
            for img, mask, _names in loader:
                gt = self.to_device(mask.astype(np.int64))
                chunks.append(M.dice_per_image(self._argmax(img), gt, self.num_classes))
        all_dice = torch.cat(chunks).cpu().numpy()   # (N, C)
        out = {"dc": [], "hd": [], "asd": []}
        for c in range(1, self.num_classes):
            vals = all_dice[:, c]
            out["dc"].extend([float(vals.mean()), float(vals.std())])
            out["hd"].extend([0.0, 0.0])
            out["asd"].extend([0.0, 0.0])
        return out

    def evaluate_single_dataset(self, loader, *, ifhd: bool = True, ifasd: bool = True,
                                toprint: bool = False) -> Dict[str, list]:
        preds, gts = self.predict(loader)
        results = evaluate_arrays(preds, gts, ifhd=ifhd, ifasd=ifasd, klc=self.klc,
                                  num_classes=self.num_classes)
        if toprint:
            names = ["myo", "lv", "rv"][: self.num_classes - 1]
            for i, n in enumerate(names):
                print(f"{n}: dc {results['dc'][2 * i]:.4f}({results['dc'][2 * i + 1]:.4f}) "
                      f"hd {results['hd'][2 * i]:.3f}({results['hd'][2 * i + 1]:.3f}) "
                      f"asd {results['asd'][2 * i]:.3f}({results['asd'][2 * i + 1]:.3f})")
        return results


def mean_fg_dice(results: Dict[str, list]) -> float:
    """Interleaved-mean foreground dice: (dc[0] + dc[2] + dc[4]) / 3, the
    Advent/AdaptSeg/MCCL convention (Trainer_Advent.py:221)."""
    return float(np.mean(results["dc"][0::2]))
