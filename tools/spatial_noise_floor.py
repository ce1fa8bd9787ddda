#!/usr/bin/env python
"""How far two sound runs of a spatial cell's step part, on the CPU: the
figures behind the ResNetUNet sizes of ``tests/torch_parallel_common.py``
(``SPATIAL_SIZES``).

    python tools/spatial_noise_floor.py [cell] [bs ...]

For the spatial cell ``cell`` of ``slcl_torch.testing.SPATIAL_CELLS``
(default ``resnet50_slcl``) at the tests' size and each global batch
``bs`` (default 2 and 4), two steps in float64 (the losses keep their
float32), as the tests run them: one process; one process on the same
batches with the images in reverse order, which changes only the order of
every sum over the images (the BatchNorm moments, the losses' means, the
centroid and MPCL sums, the weight gradients); one process on images one
float32 ulp apart (each pixel moved to its upper or lower neighbour at
random, seed 0), a change of the size of the float32 losses' rounding;
and two ranks of a ``1 x 2`` spatial mesh over gloo, which change the
order of the sums over the rows.
Prints one JSON line per batch size with, per step, each run's largest
error over the tests' tolerances against the first (state rtol 1e-4 /
atol 1e-6, metrics rel 1e-5 / abs 1e-6: at most 1 within them) and the
state entry where it lies.
"""
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch_parallel_common as C  # noqa: E402

from slcl_torch.parallel.dryrun import spawn  # noqa: E402


def ratios(got: dict, want: dict) -> dict:
    """The largest error over tolerance of the metrics and of the state,
    and the state's worst entry (inf where a value is not finite)."""
    def finite(r):
        return r if np.isfinite(r) else np.inf
    m = max(finite(abs(got["metrics"][k] - w) / max(1e-5 * abs(w), 1e-6))
            for k, w in want["metrics"].items())
    per = {k: finite(float(np.max(np.abs(got["state"][k] - w) / (1e-6 + 1e-4 * np.abs(w)),
                                  initial=0.0)))
           for k, w in want["state"].items()}
    worst = max(per, key=per.get)
    return {"metrics": m, "state": per[worst], "worst": worst}


def main(argv) -> int:
    torch.set_num_threads(1)
    cell = argv[0] if argv else "resnet50_slcl"
    sizes = [int(a) for a in argv[1:]] or [2, 4]
    for bs in sizes:
        cfg, batches, shallow = C.spatial_run(cell, bs=bs)
        scheds = [C.sched(cfg.method), {**C.sched(cfg.method), "fresh": 0.0}]
        flipped = [{k: np.ascontiguousarray(v[::-1]) for k, v in b.items()} for b in batches]
        rng = np.random.default_rng(0)
        nudged = [{k: np.nextafter(v, np.where(rng.random(v.shape) < 0.5, -np.inf, np.inf)
                                   .astype(v.dtype)) if k.startswith("img") else v
                   for k, v in b.items()} for b in batches]
        with tempfile.TemporaryDirectory() as work:
            one = C.steps_entry(None, cfg, batches, scheds, f"{work}/one", torch.float64,
                                shallow=shallow)
            rev = C.steps_entry(None, cfg, flipped, scheds, f"{work}/rev", torch.float64,
                                shallow=shallow)
            ulp = C.steps_entry(None, cfg, nudged, scheds, f"{work}/ulp", torch.float64,
                                shallow=shallow)
            ranks = spawn(2, "methods_entry",
                          ([(cell, cfg, batches, scheds, torch.float64, None, shallow)],
                           f"{work}/ranks"), model_axis=2, module="torch_parallel_common",
                          spatial=True)
        out = {"cell": cell, "bs": bs, "crop": cfg.data.crop, "steps": []}
        for i, want in enumerate(one["steps"]):
            out["steps"].append({
                "reversed_images": ratios(rev["steps"][i], want),
                "images_one_ulp_apart": ratios(ulp["steps"][i], want),
                **{f"spatial_rank{r}": ratios(got[cell]["steps"][i], want)
                   for r, got in enumerate(ranks)}})
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
