"""The gloo dry run: one data-parallel step of each configuration of the JAX
package's multichip matrix (``__graft_entry__.py::dryrun_multichip``), in N
CPU processes over gloo, each held to the one-process step on the same
global batch.

Usage:
  python -m slcl_torch.parallel.dryrun N [config ...]

``config`` defaults to every entry of :data:`CONFIGS` (JAX's matrix). Each
runs one epoch of one global batch of ``N`` rows (``mpscl_dp_fsdp``:
``max(2, N / 2)`` rows on a ``(N / 2, 2)`` mesh with FSDP;
``mpscl_dp_fsdp_sp`` the same with each image's rows split over the two
model ranks, ``mesh.spatial``) through the :class:`Trainer`, at JAX's dry-run
sizes, once in N processes and once in this one, in float64 (the losses
keep their float32): the networks' parameters and buffers, the centres, the
RAIN sampling and the epoch's metrics must agree (rtol 1e-4 / atol 1e-6;
metrics rel 1e-5, abs 1e-6). In float32 the one-process and the N-process
step round differently, and Adam's first steps (``ddfseg``, every
discriminator) turn the rounding of a gradient that is exactly zero, as a
conv bias before BatchNorm has, into a step of +-lr; float64 leaves those
gradients far below Adam's eps. It prints one JSON line per config and a
last JSON line with ``ok``, and exits non-zero when a config differs or a
rank fails.

:func:`spawn` is the machinery, also used by the tests: it starts N
processes (``spawn`` start method) that import only torch and slcl_torch,
each joining a gloo group through a ``file://`` store, runs a function of
a module in each under the mesh, and returns their results.
"""
from __future__ import annotations

import importlib
import json
import multiprocessing as mp
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import mesh as dp

CONFIGS = ("mpscl", "mccl", "mccl_rain", "mpscl_dp_fsdp", "mpscl_dp_fsdp_sp", "bcl",
           "ddfseg", "adaptevery")


def dryrun_config(name: str, n: int):
    """The port's Config of dry-run entry ``name`` for ``n`` processes, at
    the sizes of ``__graft_entry__.py:109-230``; the global batch is ``n``
    rows (``mpscl_dp_fsdp`` and ``mpscl_dp_fsdp_sp``: ``max(2, n // 2)`` on
    two model ranks)."""
    from ..config import Config
    cfg = Config()
    cfg.method = "mccl" if name == "mccl_rain" else name
    cfg.data.dataset = "synthetic"
    cfg.data.crop = 32
    cfg.data.bs = cfg.data.eval_bs = n
    cfg.data.num_workers = 1
    cfg.model.dtype = "float32"
    cfg.optim.epochs = 1
    if name in ("mpscl", "mpscl_dp_fsdp", "mpscl_dp_fsdp_sp"):
        cfg.method = "mpscl"
        cfg.data.crop = 16
        cfg.model.filters, cfg.model.n_block, cfg.model.bottleneck_depth = 8, 2, 2
        cfg.contrastive.CNR = True
        cfg.contrastive.CNR_w = 4e-5
        cfg.model.multilvl = name == "mpscl"
    if name in ("mpscl_dp_fsdp", "mpscl_dp_fsdp_sp"):
        cfg.mesh.model_axis = 2 if n % 2 == 0 else 1
        cfg.mesh.fsdp = True
        cfg.mesh.fsdp_min_size = 1024
        cfg.mesh.spatial = name == "mpscl_dp_fsdp_sp"
        cfg.data.bs = cfg.data.eval_bs = max(2, n // cfg.mesh.model_axis)
    if name in ("mccl", "mccl_rain"):
        cfg.data.crop = 16
        cfg.model.filters, cfg.model.n_block, cfg.model.bottleneck_depth = 8, 2, 2
        cfg.model.phead = True
        cfg.contrastive.part = 2
        cfg.contrastive.wtd_ave = True
        cfg.contrastive.CNR = True
        cfg.data.aug_counter = True
    if name == "mccl_rain":
        cfg.rain.enabled = True
        cfg.rain.update_eps = True
        cfg.rain.eps_iters = 2
        cfg.rain.eps_clip = 3.0
        cfg.contrastive.warmup_epochs = 0
    if name in ("bcl", "adaptevery"):
        cfg.model.layers = (1, 1, 1, 1)
        cfg.model.base = 8
    if name == "adaptevery":
        cfg.data.vert = True
    if name == "ddfseg":
        cfg.ddfseg.filters = cfg.ddfseg.style_filters = 4
        cfg.ddfseg.ngf = 8
        cfg.ddfseg.slim = True
    return cfg


def synthetic_datasets(cfg, n: int) -> Dict[str, Any]:
    """Synthetic splits of ``n`` slices each (one global batch an epoch)."""
    from ..data import SyntheticCardiacDataset as S
    c = cfg.data.crop
    return {"train_s": S(n, c, "ct", 1, vert=cfg.data.vert),
            "train_t": S(n, c, "mr", 2, aug_counter=cfg.data.aug_counter),
            "valid_t": S(n, c, "mr", 3), "test_t": S(n, c, "mr", 4)}


def make_trainer(cfg, workdir: str):
    """A CPU Trainer of ``cfg`` on synthetic splits of one global batch,
    writing under ``workdir``."""
    from ..train.trainer import Trainer
    cfg.run.out_dir = str(Path(workdir) / "runs")
    return Trainer(cfg, datasets=synthetic_datasets(cfg, cfg.data.bs), device="cpu")


def state_arrays(trainer) -> Dict[str, np.ndarray]:
    """Every network's whole state (gathered when sharded), the centres and
    the sampling, as numpy arrays keyed ``net/entry``."""
    from ..train.trainer import _NETS
    s, out = trainer.state, {}
    for name in _NETS:
        net = getattr(s, name)
        if net is not None:
            for k, v in dp.full_state_dict(net).items():
                out[f"{name}/{k}"] = v.detach().cpu().numpy().copy()
    for name in ("centroids", "sampling"):
        t = getattr(s, name)
        if t is not None:
            out[name] = t.detach().cpu().numpy().copy()
    return out


def epoch_entry(mesh: Optional[dp.Mesh], name: str, n: int, workdir: str,
                dtype: torch.dtype = torch.float64) -> dict:
    """One epoch (one global batch) of dry-run config ``name`` with ``dtype``
    as torch's default (the networks, centres and batches; the losses keep
    their float32): the epoch's metrics, the state after it, and how many
    of the segmentor's parameters FSDP sharded."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with dp.use(mesh):
            trainer = make_trainer(dryrun_config(name, n), workdir)
            if trainer.state.centroids is not None:
                trainer.state.centroids = trainer.state.centroids.to(dtype)
            metrics = trainer.train_epoch(0)
            sharded = sum(1 for p in trainer.state.seg.parameters() if dp.is_dtensor(p))
            return {"metrics": metrics, "state": state_arrays(trainer),
                    "sharded_params": sharded}
    finally:
        torch.set_default_dtype(before)


def _rank_main(rank: int, world: int, store: str, model_axis: int, entry: str,
               module: str, args: tuple, out: str, device: str, spatial: bool) -> None:
    torch.set_num_threads(1)
    if device != "cpu":
        torch.cuda.set_device(torch.device(device))
    fn = getattr(importlib.import_module(module), entry)
    mesh = dp.make_mesh(model_axis, backend="gloo", device=torch.device(device),
                        init_method=f"file://{store}", rank=rank, world_size=world,
                        spatial=spatial)
    done = False
    try:
        torch.save(fn(mesh, *args), Path(out) / f"rank{rank}.pt")
        done = True
    finally:
        dp.release(synced=done)


def spawn(world: int, entry: str, args: tuple = (), model_axis: int = 1,
          module: str = __name__, timeout: float = 600.0,
          device: str = "cpu", spatial: bool = False) -> List[Any]:
    """Run the function ``entry`` of ``module`` (one that imports no JAX) as
    ``fn(mesh, *args)`` in ``world`` new processes over gloo, each on
    ``device`` (the CPU, or one card that the ranks share: gloo carries the
    all-reduces and broadcasts of CUDA tensors), on a ``(data, model)`` mesh
    of ``model_axis`` model ranks (``spatial``: image rows split over them);
    returns each rank's result.
    Raises if a rank fails or outlasts ``timeout`` seconds (every rank is
    then terminated)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world, store, model_axis, entry,
                                                      module, args, tmp, device, spatial))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.time()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"{entry}: ranks failed (rank, exit code): {bad}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def compare(got: dict, want: dict) -> List[str]:
    """The differences of a rank's epoch result from the one-process one,
    beyond the dry run's tolerances; empty when they agree."""
    errs = []
    for k, w in want["state"].items():
        g = got["state"].get(k)
        if g is None or g.shape != w.shape:
            errs.append(f"{k}: missing or shape {None if g is None else g.shape}")
            continue
        if not np.allclose(g, w, rtol=1e-4, atol=1e-6):
            errs.append(f"{k}: max |diff| {float(np.abs(g - w).max()):.3g}")
    for k, w in want["metrics"].items():
        g = got["metrics"].get(k)
        if g is None or not abs(g - w) <= max(1e-5 * abs(w), 1e-6):
            errs.append(f"metric {k}: {g} vs {w}")
    return errs


def main(argv) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    n = int(argv[0])
    names = argv[1:] or list(CONFIGS)
    ok = True
    for name in names:
        t0 = time.time()
        mesh_cfg = dryrun_config(name, n).mesh
        axis = mesh_cfg.model_axis
        with tempfile.TemporaryDirectory() as work:
            try:
                ranks = spawn(n, "epoch_entry", (name, n, work), model_axis=axis,
                              spatial=mesh_cfg.spatial and axis > 1)
                want = epoch_entry(None, name, n, work)
                errs = [f"rank {r}: {e}" for r, got in enumerate(ranks)
                        for e in compare(got, want)]
                if mesh_cfg.fsdp and axis > 1 and not ranks[0]["sharded_params"]:
                    errs.append("no parameter sharded")
            except Exception as e:      # a rank that failed fails the config
                errs = [f"{type(e).__name__}: {e}"]
        ok = ok and not errs
        print(json.dumps({"config": name, "processes": n, "ok": not errs,
                          "errors": errs[:8], "seconds": round(time.time() - t0, 1)}),
              flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
