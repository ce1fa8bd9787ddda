#!/usr/bin/env python
"""How far sound runs of the RAIN cells part on the card, and where
``model.remat=dots`` holds its memory with the epsilon ascent: the figures
behind ``chip_smoke.py``'s ``RAIN_TOL``, ``FLOOR_HELD`` and phase 8's
deterministic comparison.

    python3 tools/rain_card_spread.py [stages] [remat] [floors]

(on the card, from the checkout's root; all three by default, ~4 min with
the kernels' build.)

- ``stages``: one carried ``mccl_rain`` iteration at full width (the MCCL
  preset with the ascent, bs16 + 16 + 16 at 224²) with ``model.remat`` off,
  ``full`` and ``dots``: GB allocated and the peak before the ascent, over
  its backward, after it, and over the update's backward.
- ``remat``: two ``mccl_rain`` iterations with each mode under cuDNN's
  default algorithms: each mode's largest error against off over phase
  8's DRUNet tolerance (rtol 1e-3 / atol 1e-5) among the segmentor's
  state, the centres and the sampling, and where it lies.
- ``floors``: phase 9's ``mccl_rain`` on the ``(1, 2)`` spatial mesh and
  ``mccl_rain_mulstyle`` on two data ranks, each against one process, beside
  the one process on the reversed images and (``mccl_rain``) on the images
  one float32 ulp up (``chip_smoke.two_rank_entry``): per step the twelve
  largest metric ratios and state ratios over (b)'s tolerance.

Prints one JSON line per part and writes them to
``chiprun_out/rain_card_spread.json``.
"""
import contextlib
import gc
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def detail(got: dict, want: dict, i: int) -> dict:
    """Step ``i`` of a ``two_rank_entry`` record against the one process's:
    the largest metric ratios and state ratios over (b)'s tolerance."""
    import torch
    import chip_smoke as c
    g_state, w_state = ((got["first_state"], want["first_state"]) if i == 0
                        else (got["state"], want["state"]))
    met = sorted(((c.metric_ratio(got["metrics"][i][k], w), k)
                  for k, w in want["metrics"][i].items()), reverse=True)
    ent = sorted(((c.tol_ratio(g_state[k], w, 1e-4, 1e-6), k)
                  for k, w in w_state.items() if torch.is_floating_point(w)), reverse=True)
    return {"metrics": met[:12], "state": ent[:12]}


def mccl_rain_trainer(work: Path, mode: str):
    from slcl_torch.config import Config, apply_recipe
    from slcl_torch.testing import configure_cell
    from slcl_torch.train.trainer import Trainer
    cfg = configure_cell(apply_recipe(Config(method="mccl")), "mccl_rain")
    cfg.model.remat = mode
    cfg.data.dataset, cfg.run.out_dir = "synthetic", str(work)
    return Trainer(cfg)


def stages(work: Path) -> dict:
    import torch
    from slcl_torch.data import device_prefetch
    from slcl_torch.train import steps as S
    from slcl_torch.train import steps_rain as R
    out = {}
    for mode in ("", "full", "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        t = mccl_rain_trainer(work, mode)
        b = next(iter(device_prefetch(t._epoch_batches(), t.device)))
        sched = {**t._sched(0), "fresh": 1.0, "eps_on": 1.0}
        marks = {}
        ascent, update = R.epsilon_ascent, S.net_update

        def gb(key, peak=False):
            torch.cuda.synchronize()
            marks[key] = (torch.cuda.max_memory_allocated() if peak
                          else torch.cuda.memory_allocated()) / 1e9

        def timed_ascent(*a, **k):
            gb("before_ascent")
            gb("peak_forward", True)
            torch.cuda.reset_peak_memory_stats()
            r = ascent(*a, **k)
            gb("peak_ascent", True)
            gb("after_ascent")
            torch.cuda.reset_peak_memory_stats()
            return r

        def timed_update(*a, **k):
            r = update(*a, **k)
            gb("peak_update", True)
            return r
        R.epsilon_ascent, S.net_update = timed_ascent, timed_update
        try:
            t.step_fn(t.state, b, sched)
            gb("resident")
            torch.cuda.reset_peak_memory_stats()
            t.step_fn(t.state, b, {**sched, "fresh": 0.0})
        finally:
            R.epsilon_ascent, S.net_update = ascent, update
        out[mode or "off"] = marks
        del t, b
    return out


def remat(work: Path) -> dict:
    import torch
    from slcl_torch.data import device_prefetch
    runs = {}
    for mode in ("", "full", "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        t = mccl_rain_trainer(work, mode)
        batches = [b for _, b in zip(range(2), device_prefetch(t._epoch_batches(), t.device))]
        s = {**t._sched(0), "eps_on": 1.0}
        for b, sched in zip(batches, ({**s, "fresh": 1.0}, {**s, "fresh": 0.0})):
            t.step_fn(t.state, b, sched)
        runs[mode or "off"] = {**{f"seg.{k}": v.detach().double().cpu()
                                  for k, v in t.state.seg.state_dict().items()
                                  if torch.is_floating_point(v)},
                               "centroids": t.state.centroids.double().cpu(),
                               "sampling": t.state.sampling.double().cpu()}
        del t, batches
    import chip_smoke as c
    out = {}
    for mode in ("full", "dots"):
        worst = max((c.tol_ratio(runs[mode][k], w, 1e-3, 1e-5), k)
                    for k, w in runs["off"].items())
        out[mode] = {"ratio_over_remat_tolerance": worst[0], "at": worst[1],
                     "abs_diff": float((runs[mode][worst[1]] - runs["off"][worst[1]]).abs().max())}
    return out


def floors(work: Path) -> dict:
    import chip_smoke as c
    from slcl_torch.parallel.dryrun import spawn
    out = {}
    for cell, spatial in (("mccl_rain", True), ("mccl_rain_mulstyle", False)):
        want, files = c.one_process(work, cell)
        runs = {}
        if "floor" in want:
            runs["reversed"] = want["floor"]
        if cell in c.FLOOR_HELD:
            runs["ulp"] = want["ulp_floor"]
        ranks = spawn(2, "cells_entry", ([cell], str(work), {cell: files}, 0),
                      module="chip_smoke", device="cuda:0", timeout=600,
                      model_axis=2 if spatial else 1, spatial=spatial)
        runs.update({f"rank{r}": rk[cell] for r, rk in enumerate(ranks)})
        out[cell] = {f"step{i}": {name: detail(rec, want, i) for name, rec in runs.items()}
                     for i in range(2)}
    return out


def main() -> int:
    import torch
    import chip_smoke as c
    from slcl_torch.ops.cuda import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    parts = sys.argv[1:] or ["stages", "remat", "floors"]
    (ROOT / "runs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="rain_spread_", dir=ROOT / "runs"))
    out = {"card": c.card_line(), "torch": torch.__version__}
    try:
        with contextlib.redirect_stdout(sys.stderr):
            for part in parts:
                out[part] = {"stages": stages, "remat": remat, "floors": floors}[part](work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "rain_card_spread.json").write_text(json.dumps(out))
    for part in parts:
        print(json.dumps({part: out[part]}))
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
