"""Host-side batching: shuffled epochs, drop_last, source/target zip.

A copy of ``Loader``/``zip_domains`` from ``slcl_tpu/data/loader.py`` (numpy
and threads only) plus the torch host->device copy: pinned host memory and
``non_blocking=True`` copies, a few batches ahead of the consumer. Epoch
pairing of the two domains follows the reference's ``zip(content_loader,
style_loader)`` semantics — epoch length = min of the two loaders.

Under data parallelism each rank's Loader takes ``rows=(rank, n)``: it
draws the global batches of the one-process Loader (the same shuffle) and
decodes only its ``batch_size / n`` rows of each; with the per-sample RNG
of (seed, epoch, index) those rows are the one-process batch's.
"""
from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch


def _collate(samples: Sequence[tuple]) -> tuple:
    cols = list(zip(*samples))
    out = []
    for col in cols:
        if isinstance(col[0], np.ndarray):
            out.append(np.stack(col))
        else:
            out.append(list(col))
    return tuple(out)


class Loader:
    """Minimal epoch-based loader: shuffle, batch, drop_last, prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_threads: int = 4,
                 prefetch: int = 4, rows: Tuple[int, int] = (0, 1)):
        self.ds = dataset
        self.bs = batch_size
        self.rows = rows
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def _indices(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[tuple]:
        idx = self._indices()
        # propagate the epoch to the dataset so per-sample augmentation RNG
        # can be derived deterministically from (seed, epoch, index)
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(self.epoch)
        self.epoch += 1
        n_batches = len(self)
        batches = [idx[i * self.bs:(i + 1) * self.bs] for i in range(n_batches)]
        rank, n = self.rows
        if n > 1:
            if self.bs % n:
                raise ValueError(f"batch size {self.bs} not divisible by {n} ranks")
            per = self.bs // n
            batches = [b[rank * per:(rank + 1) * per] for b in batches]

        if self.num_threads == 1:
            for b in batches:
                yield _collate([self.ds[int(i)] for i in b])
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.num_threads) as pool:
                for b in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(lambda i: self.ds[int(i)], b))
                    q.put(_collate(samples))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Copy the numpy arrays of ``batch`` to ``device``. Integer label maps
    become int32 (the kernels' label type), floating arrays take torch's
    default dtype (float32 unless a caller, such as the float64 dry run,
    sets another); on CUDA the copy goes through pinned host memory and
    does not block the host."""
    cuda = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        if v.dtype.kind in "iu":
            v = v.astype(np.int32)
        t = torch.from_numpy(np.ascontiguousarray(v))
        if cuda:
            t = t.pin_memory()
        dtype = torch.get_default_dtype() if t.is_floating_point() else None
        out[k] = t.to(device, dtype=dtype, non_blocking=cuda)
    return out


def device_prefetch(batch_iter, device: torch.device, size: int = 2):
    """Keep ``size`` batches' host->device copies in flight ahead of the
    consumer, so the next batch's copy overlaps the current step."""
    pending: collections.deque = collections.deque()
    for batch in batch_iter:
        pending.append(to_device(batch, device))
        if len(pending) > size:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def zip_domains(content_loader: Loader, style_loader: Loader,
                aug_counter: bool = False) -> Iterator[Dict[str, Any]]:
    """Yield UDA batches: ``{'img_s', 'lab_s', 'img_t'[, 'img_t_aug']}``."""
    for bc, bs in zip(content_loader, style_loader):
        if len(bc) == 4:  # vert=True source (AdaptEvery)
            batch = {"img_s": bc[0], "lab_s": bc[1], "vert_s": bc[2],
                     "names_s": bc[3]}
        else:
            batch = {"img_s": bc[0], "lab_s": bc[1], "names_s": bc[2]}
        if aug_counter:
            batch["img_t"] = bs[0]
            batch["img_t_aug"] = bs[1]
        else:
            batch["img_t"] = bs[0]
            batch["lab_t"] = bs[1]
        batch["names_t"] = bs[-1]
        yield batch
