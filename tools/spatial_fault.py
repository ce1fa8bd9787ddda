#!/usr/bin/env python
"""What phase 9(c) of ``chip_smoke.py`` reads for a floor-held cell when the
bands are wrong, beside what it reads when they are right, on the card.

    python3 tools/spatial_fault.py [cell ...]    (default: ddfseg bcl_small)

For each cell of ``chip_smoke.SMOKE_SPATIAL``: the one process and its
sound runs (``chip_smoke.one_process``: the images in reverse order, the
images one float32 ulp up), the two ranks of a ``(1, 2)`` spatial mesh as
phase 9(c) runs them, held by ``chip_smoke.hold_cell``, and the two ranks
again with a planted fault: the halos' gradients are not sent back (each
band's convolutions drop the cotangent of the rows they read from the
neighbour's band). Prints one JSON line per cell: the sound ranks' record
(or the failure ``hold_cell`` raised), and the faulty ranks' ratios over
(b)'s tolerance at each step (``chip_smoke.step_ratios``), their first-step
gradient ratios and their move cosines per network, and whether
``hold_cell`` failed them, with its message. Needs one card.
"""
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

FAULT = "SLCL_SPATIAL_HALO_FAULT"


def _plant() -> None:
    """``_Fetch``'s backward without the halo exchange: each rank keeps the
    cotangent of its own rows only."""
    from slcl_torch.parallel import spatial as sp

    def backward(ctx, grad):
        rows, reads, mesh, _, _, shape = ctx.plan
        r = mesh.model_rank
        b = sp.bounds(rows, mesh.model_size)
        lo, hi = reads[r]
        dx = sp._zeros(grad, shape)
        s, e = max(lo, b[r]), min(hi, b[r + 1])
        if s < e:
            dx[:, :, s - b[r]:e - b[r]] = grad[:, :, s - lo:e - lo]
        return dx, None, None, None, None
    sp._Fetch.backward = staticmethod(backward)


# the ranks re-import this file as their main module: the fault is planted
# in them when the parent set the variable before it spawned them
if os.environ.get(FAULT):
    _plant()


def ranks_of(work: Path, cell: str, files: dict) -> list:
    from slcl_torch.parallel.dryrun import spawn
    return [r[cell] for r in spawn(2, "cells_entry", ([cell], str(work), {cell: files}),
                                   module="chip_smoke", device="cuda:0", timeout=900,
                                   model_axis=2, spatial=True)]


def main(argv) -> int:
    import torch
    from slcl_torch.ops.cuda import build
    if not torch.cuda.is_available():
        print("no CUDA device: this tool runs only on a card", file=sys.stderr)
        return 2
    build.build_all()
    cells = argv or ["ddfseg", "bcl_small"]
    (ROOT / "runs").mkdir(exist_ok=True)
    for cell in cells:
        work = Path(tempfile.mkdtemp(prefix="spatial_fault_", dir=ROOT / "runs"))
        try:
            want, files = cs.one_process(work, cell)
            sound = ranks_of(work, cell, files)
            os.environ[FAULT] = "1"
            try:
                bad = ranks_of(work, cell, files)
            finally:
                del os.environ[FAULT]
            line = {"cell": cell, "card": cs.card_line()}
            try:
                line["sound"] = cs.hold_cell(cell, want, sound, True, 0.0)
            except AssertionError as e:
                line["sound_failed"] = str(e)
            line["fault"] = {"tol_ratio": [cs.step_ratios(bad[0], want, i)[0] for i in range(2)],
                             "grad_ratio": cs.grad_ratios(bad[0], want),
                             "move_cosine": cs.move_cosines(bad[0], want)}
            try:
                cs.hold_cell(cell, want, bad, True, 0.0)
                line["fault"]["held"] = "passed"
            except AssertionError as e:
                line["fault"]["held"] = f"failed: {e}"
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
