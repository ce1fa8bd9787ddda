#!/usr/bin/env python3
"""Time variants of the MPCL backward ring kernels on one CUDA card.

Run from the root of a checkout, on a machine with the card:

    python3 tools/bwd_ring_variants.py [variant ...]

Each variant is a text edit of ``slcl_torch/csrc/mpcl_bwd_tile.cuh``; the
script copies ``slcl_torch/csrc`` into ``slcl_torch/_build/variants/<name>``
(git-ignored), applies the edit, builds ``mpcl.cu`` and ``mpcl_pseudo.cu``
with the port's nvcc flags (all builds started together), and times
``mpcl_bwd`` and ``mpcl_pseudo_bwd`` of every variant at the main path's
shapes (M = 16*224*224, F = 32, C = 4, bf16) with ``chip_smoke.time_ms``,
three times each, then once more in reverse order. "base" is the source as
it stands; the others show what its parameters buy. One ``copy_`` of the
features into a tensor of their shape, timed the same way, is the
yardstick for what the card's memory allows for the same bytes. Prints
one JSON line per variant and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H = "mpcl_bwd_tile.cuh"
_STAGES = ("32768 / kFeatBytes < 2 ? 2 : (32768 / kFeatBytes > 4 ? 4 : 32768 / kFeatBytes);")
VARIANTS = {
    "base": [],
    # the ring alone: each row is scaled and written back, no MPCL math
    "memonly": [(H, "  // the cosines as row_cosines takes them\n",
                 "  if (true) {\n    for (int k = 0; k < F; k += 8) {\n      float x[8];\n"
                 "      load8(row + k, x);\n      for (int i = 0; i < 8; ++i) x[i] *= coef;\n"
                 "      store8(row + k, x);\n    }\n    return;\n  }\n")],
    # the cosine loop cut to its first chunk: what the cosine phase costs
    "nocos": [(H, "#pragma unroll 1\n  for (int k = 0; k < F; k += 8) {\n    float x[8];\n"
                  "    load8(row + k, x);\n#pragma unroll\n    for (int i = 0; i < 8; ++i) ss",
               "#pragma unroll 1\n  for (int k = 0; k < 8; k += 8) {\n    float x[8];\n"
               "    load8(row + k, x);\n#pragma unroll\n    for (int i = 0; i < 8; ++i) ss")],
    "stages3": [(H, _STAGES, "3;")],
    "stages4": [(H, _STAGES, "4;")],
    "blocks4": [(H, "constexpr int kRingBlocksPerSM = 3;", "constexpr int kRingBlocksPerSM = 4;")],
}


def ptxas_main(log: str) -> list:
    """[registers, spill-store bytes] of the main instantiation (bf16, F = 32)
    of each backward kernel in one nvcc log."""
    out, fn, spill = [], "", 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "_bwdI13__nv_bfloat16Li32E" in fn:
            out.append([int(line.split("Used")[1].split()[0]), spill])
    return out


def build_variants(names):
    from slcl_torch.ops.cuda import build
    out = build.BUILD_DIR / "variants"
    shutil.rmtree(out, ignore_errors=True)
    procs = []
    for name in names:
        d = out / name
        shutil.copytree(build.CSRC, d)
        for f, old, new in VARIANTS[name]:
            text = (d / f).read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: edit does not apply to {f}")
            (d / f).write_text(text.replace(old, new))
        for lib in ("mpcl", "mpcl_pseudo"):
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"),
                   str(d / f"{lib}.cu")]
            procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed for {lib}.cu\n{log}")
        (out / name / f"{lib}.log").write_text(log)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs only on a card", file=sys.stderr)
        return 2
    from chip_smoke import C, F, M, time_ms
    from slcl_torch.ops.cuda import build, ptr, stream_of
    from slcl_torch.ops.cuda import mpcl as K
    from slcl_torch.ops.cuda import mpcl_pseudo as KP

    names = sys.argv[1:] or list(VARIANTS)
    if names[0] != "base":
        names = ["base", *[n for n in names if n != "base"]]
    out = build_variants(names)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn(M, F, generator=g, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, C, (M,), generator=g, device=dev, dtype=torch.int32)
    sel = torch.randint(0, 2, (M,), generator=g, device=dev).float()
    centers = torch.randn(C, F, generator=g, device=dev)
    centers = centers / centers.norm(dim=1, keepdim=True)
    T, scale, margin, tm, th = 0.1, 0.1, 0.4, 0.2, 0.25
    grad = torch.ones(1, device=dev)
    stats = K.mpcl_fwd_cuda(feats, labels, centers, sel, T, margin, False, scale)
    pstats = KP.mpcl_pseudo_fwd_cuda(feats, centers, T, tm, False, scale, th)
    d1, d2 = torch.empty_like(feats), torch.empty_like(feats)
    args = K._args(feats, labels, centers, sel, T, margin, False, scale)
    pargs = KP._args(feats, centers, T, tm, False, scale, th)

    calls = {}
    for name in names:
        a = ctypes.CDLL(str(out / name / "mpcl.so"))
        b = ctypes.CDLL(str(out / name / "mpcl_pseudo.so"))
        for lib, sigs in ((a, K._SIGS), (b, KP._SIGS)):
            for fn, (restype, argtypes) in sigs.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)

        def bwd(a=a, name=name):
            rc = a.mpcl_bwd(*args, ptr(grad), ptr(stats), ptr(d1), stream_of(feats))
            if rc:
                raise RuntimeError(f"{name}: mpcl_bwd returned {rc}")

        def pbwd(b=b, name=name):
            rc = b.mpcl_pseudo_bwd(*pargs, ptr(grad), ptr(pstats), ptr(d2), stream_of(feats))
            if rc:
                raise RuntimeError(f"{name}: mpcl_pseudo_bwd returned {rc}")
        calls[name] = (bwd, pbwd)

    copy = [time_ms(lambda: d1.copy_(feats), iters=50) for _ in range(3)]
    print(json.dumps({"variant": "copy_ yardstick", "ms": copy}), flush=True)
    ref = None
    for name in names:
        bwd, pbwd = calls[name]
        bwd()
        pbwd()
        torch.cuda.synchronize()
        got = (d1.clone(), d2.clone())
        ref = ref or got
        rec = {"variant": name,
               "same_as_base": torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
               "mpcl_bwd_ms": [time_ms(bwd, iters=50) for _ in range(3)],
               "mpcl_pseudo_bwd_ms": [time_ms(pbwd, iters=50) for _ in range(3)],
               "registers_spills": [r for lib in ("mpcl", "mpcl_pseudo")
                                    for r in ptxas_main((out / name / f"{lib}.log").read_text())]}
        print(json.dumps(rec), flush=True)
    for name in reversed(names):
        bwd, pbwd = calls[name]
        print(json.dumps({"variant": name, "again_ms": [time_ms(bwd, iters=50),
                                                        time_ms(pbwd, iters=50)]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
