#!/usr/bin/env python3
"""Time variants of the port's ring kernels on one CUDA card.

Run from the root of a checkout, on a machine with the card:

    python3 tools/ring_variants.py [bwd | fwd | variant ...]

Each variant is a set of text edits of ``slcl_torch/csrc``; the script
copies the sources into ``slcl_torch/_build/variants/<name>`` (git-ignored),
applies the edits, builds the libraries the variant concerns with the port's
nvcc flags (all builds started together), and times its kernels at the main
path's shapes (M = 16*224*224, F = 32, C = 4, bf16) with
``chip_smoke.time_ms``, three times each, then once more in reverse order.
"base" is the source as it stands; the others show what its parameters buy.

- ``bwd`` variants edit ``mpcl_bwd_tile.cuh`` and time ``mpcl_bwd`` and
  ``mpcl_pseudo_bwd``;
- ``fwd_*`` variants edit ``mpcl_fwd_tile.cuh`` and ``soft_centroids.cu``
  and time ``mpcl_pseudo_fwd`` (on the ring) and ``soft_centroids_fwd``
  (direct loads; P = 1, hard weights: the step's call; and P = 2).

Yardsticks for what the card's memory allows, timed the same way: one
``copy_`` of the features into a tensor of their shape (read + write) and
one ``torch.sum`` over them (read only). Prints one JSON line per variant
and the card's name and power limit.
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

BWD, FWD, CEN = "mpcl_bwd_tile.cuh", "mpcl_fwd_tile.cuh", "soft_centroids.cu"
_STAGES = ("32768 / kFeatBytes < 2 ? 2 : (32768 / kFeatBytes > 4 ? 4 : 32768 / kFeatBytes);")
_FWD_BLOCKS = "constexpr int kFwdBlocksPerSM = 3;"
_CEN_ROWS = "constexpr int kRowsInFlight = P == 1 ? 4 : 2;"
_CEN_BLOCKS = "constexpr int kCentFwdBlocksPerSM = 2;"
_CEN_BLOCKS3 = (CEN, _CEN_BLOCKS, "constexpr int kCentFwdBlocksPerSM = 3;")
_CEN_MEMONLY = (CEN, "        acc.add(x[j], p, id[j], sub == 0, thd, use_thd, weighted);\n",
                "        for (int i = 0; i < 8; ++i) acc.sum[0][i] += x[j][i];\n"
                "        acc.cnt[0] += p[0] + id[j];\n")
_REFILL = """    if (threadIdx.x == 0) {
      const int next = tile + G::kStages * gridDim.x;
      if (next < ntiles) {
        mbar_wait(&empty[stage], parity);
        fill(stage, next);
      }
    }
"""
BWD_KERNELS = ("mpcl_bwd", "mpcl_pseudo_bwd")
FWD_KERNELS = ("mpcl_pseudo_fwd", "soft_centroids_fwd", "soft_centroids_fwd_p2")
LIB_OF = {"mpcl_bwd": "mpcl", "mpcl_pseudo_bwd": "mpcl_pseudo",
          "mpcl_pseudo_fwd": "mpcl_pseudo", "soft_centroids_fwd": "soft_centroids",
          "soft_centroids_fwd_p2": "soft_centroids"}
# ptxas entry-function name parts of each timed kernel's instantiation
SYMBOL_OF = {"mpcl_bwd": "mpcl_bwdI13__nv_bfloat16Li32E",
             "mpcl_pseudo_bwd": "mpcl_pseudo_bwdI13__nv_bfloat16Li32E",
             "mpcl_pseudo_fwd": "mpcl_pseudo_fwd_partialI13__nv_bfloat16Li32E",
             "soft_centroids_fwd": "centroids_fwd_partialI13__nv_bfloat16Li32ELi1E",
             "soft_centroids_fwd_p2": "centroids_fwd_partialI13__nv_bfloat16Li32ELi2E"}


# name -> (kernels it concerns, [(file, old text, new text)])
VARIANTS = {
    "base": (BWD_KERNELS + FWD_KERNELS, []),
    # the ring alone: each row is scaled and written back, no MPCL math
    "memonly": (BWD_KERNELS, [
        (BWD, "  // one chunk at a time, and the row and prototypes read again below: held\n",
         "  if (true) {\n    for (int k = 0; k < F; k += 8) {\n      float x[8];\n"
         "      load8(row + k, x);\n      for (int i = 0; i < 8; ++i) x[i] *= coef;\n"
         "      store8(row + k, x);\n    }\n    return;\n  }\n")]),
    # the cosine loop cut to its first chunk: what the cosine phase costs
    # (it is shared with the forward, so this variant concerns both)
    "nocos": (BWD_KERNELS + FWD_KERNELS[:1], [
        ("mpcl_row.cuh", "#pragma unroll 1\n  for (int k = 0; k < F; k += 8) {",
         "#pragma unroll 1\n  for (int k = 0; k < 8; k += 8) {")]),
    "stages3": (BWD_KERNELS, [(BWD, _STAGES, "3;")]),
    "stages4": (BWD_KERNELS, [(BWD, _STAGES, "4;")]),
    "blocks4": (BWD_KERNELS, [(BWD, "constexpr int kRingBlocksPerSM = 3;",
                               "constexpr int kRingBlocksPerSM = 4;")]),
    # the forwards' feeds alone: a row's chunks are read and one value of
    # each added up, no cosines, softmax or weights
    "fwd_memonly": (FWD_KERNELS, [
        (FWD, "    float cosv[kC], inv;\n    if (live)\n      stream_cosines<T, F>(",
         "    float cosv[kC] = {0.f, 0.f, 0.f, 0.f}, inv;\n    if (live)\n"
         "      for (int k = 0; k < F; k += 8) {\n        float x[8];\n"
         "        load8(reinterpret_cast<const T*>(smem + stage * G::kStageBytes) +\n"
         "                  threadIdx.x * F + k, x);\n        cosv[0] += x[0];\n      }\n"
         "    if (false)\n      stream_cosines<T, F>("),
        (FWD, "      if (s != 0.f) {  // rows that fail the gap test skip the softmax\n",
         "      num += cosv[0];\n      if (false) {\n"),
        _CEN_MEMONLY]),
    "fwd_stages3": (FWD_KERNELS[:1], [(FWD, _STAGES, "3;")]),
    "fwd_stages4": (FWD_KERNELS[:1], [(FWD, _STAGES, "4;")]),
    "fwd_blocks4": (FWD_KERNELS[:1], [(FWD, _FWD_BLOCKS, "constexpr int kFwdBlocksPerSM = 4;")]),
    "fwd_blocks6": (FWD_KERNELS[:1], [(FWD, _FWD_BLOCKS, "constexpr int kFwdBlocksPerSM = 6;")]),
    # the centroids' rows in flight a thread and blocks per SM: two rows at
    # P = 1 (at 3 blocks per SM, 80 registers), four rows at 3 blocks per SM,
    # and four rows at P = 2
    "fwd_rows2": (FWD_KERNELS[1:2], [(CEN, _CEN_ROWS, "constexpr int kRowsInFlight = 2;"),
                                     _CEN_BLOCKS3]),
    "fwd_cen_blocks3": (FWD_KERNELS[1:2], [_CEN_BLOCKS3]),
    "fwd_rows4_p2": (FWD_KERNELS[2:], [(CEN, _CEN_ROWS, "constexpr int kRowsInFlight = 4;")]),
    # the fused forward refills a stage before its softmax, not after
    "fwd_earlyfill": (FWD_KERNELS[:1], [
        (FWD, _REFILL, ""), (FWD, "    if (live) {\n      float s;\n",
                             _REFILL + "    if (live) {\n      float s;\n")]),
}


def ptxas_of(log: str, symbol: str) -> list:
    """[registers, spill-store bytes] of the entry function whose name holds
    ``symbol`` in one nvcc log."""
    fn, spill = "", 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and symbol in fn:
            return [int(line.split("Used")[1].split()[0]), spill]
    return []


def build_variants(names):
    from slcl_torch.ops.cuda import build
    out = build.BUILD_DIR / "variants"
    shutil.rmtree(out, ignore_errors=True)
    procs = []
    for name in names:
        kernels, edits = VARIANTS[name]
        d = out / name
        shutil.copytree(build.CSRC, d)
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: edit does not apply to {f}")
            (d / f).write_text(text.replace(old, new))
        for lib in sorted({LIB_OF[k] for k in kernels}):
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
    from slcl_torch.ops.cuda import mpcl as K
    from slcl_torch.ops.cuda import mpcl_pseudo as KP
    from slcl_torch.ops.cuda import ptr, raise_on_error, stream_of
    from slcl_torch.ops.cuda import soft_centroids as KC

    names = []
    for arg in sys.argv[1:] or list(VARIANTS):
        if arg in ("bwd", "fwd"):
            names += [n for n in VARIANTS if n.startswith("fwd_") == (arg == "fwd")]
        else:
            names.append(arg)
    names = ["base", *dict.fromkeys(n for n in names if n != "base")]
    out = build_variants(names)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn(M, F, generator=g, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, C, (M,), generator=g, device=dev, dtype=torch.int32)
    sel = torch.randint(0, 2, (M,), generator=g, device=dev).float()
    centers = torch.randn(C, F, generator=g, device=dev)
    centers = centers / centers.norm(dim=1, keepdim=True)
    probs = torch.softmax(torch.randn(M, C, generator=g, device=dev), dim=-1)
    assign = torch.randint(0, 2, (M,), generator=g, device=dev, dtype=torch.int32)
    T, scale, margin, tm, th = 0.1, 0.1, 0.4, 0.2, 0.25
    grad = torch.ones(1, device=dev)
    stats = K.mpcl_fwd_cuda(feats, labels, centers, sel, T, margin, False, scale)
    pstats = KP.mpcl_pseudo_fwd_cuda(feats, centers, T, tm, False, scale, th)
    d1, d2 = torch.empty_like(feats), torch.empty_like(feats)
    args = K._args(feats, labels, centers, sel, T, margin, False, scale)
    pargs = KP._args(feats, centers, T, tm, False, scale, th)
    stream = stream_of(feats)
    fstats = torch.empty(3, device=dev)
    cen_out = {P: (torch.empty(P, C, F, device=dev), torch.empty(P * C, device=dev),
                   torch.empty((), device=dev)) for P in (1, 2)}
    # what each kernel leaves behind, to hold a variant against base
    result = {"mpcl_bwd": lambda: d1, "mpcl_pseudo_bwd": lambda: d2,
              "mpcl_pseudo_fwd": lambda: fstats, "soft_centroids_fwd": lambda: cen_out[1][0],
              "soft_centroids_fwd_p2": lambda: cen_out[2][0]}

    def loaded(path, sigs):
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in sigs.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
        return lib

    def checked(name, kernel, call):
        def run():
            rc = call()
            if rc:
                raise RuntimeError(f"{name}: {kernel} returned {rc}")
        return run

    calls = {}
    for name in names:
        libs = {lib: loaded(out / name / f"{lib}.so", mod._SIGS)
                for lib, mod in (("mpcl", K), ("mpcl_pseudo", KP), ("soft_centroids", KC))
                if (out / name / f"{lib}.so").exists()}
        calls[name] = {}
        for kernel in VARIANTS[name][0]:
            lib = libs[LIB_OF[kernel]]
            if kernel == "mpcl_bwd":
                call = lambda lib=lib: lib.mpcl_bwd(  # noqa: E731
                    *args, ptr(grad), ptr(stats), ptr(d1), stream)
            elif kernel == "mpcl_pseudo_bwd":
                call = lambda lib=lib: lib.mpcl_pseudo_bwd(  # noqa: E731
                    *pargs, ptr(grad), ptr(pstats), ptr(d2), stream)
            elif kernel == "mpcl_pseudo_fwd":
                n = ctypes.c_int()
                raise_on_error(lib.mpcl_pseudo_num_partials(1, M, F, ctypes.byref(n)), name)
                parts = torch.empty(2 * n.value, device=dev)
                call = lambda lib=lib, parts=parts: lib.mpcl_pseudo_fwd(  # noqa: E731
                    *pargs, ptr(parts), ptr(fstats), stream)
            else:
                P = 2 if kernel.endswith("_p2") else 1
                n = ctypes.c_int()
                raise_on_error(lib.soft_centroids_partials_size(1, M, F, P, C,
                                                                ctypes.byref(n)), name)
                parts = torch.empty(n.value, device=dev)
                call = lambda lib=lib, parts=parts, P=P: lib.soft_centroids_fwd(  # noqa: E731
                    ptr(feats), 1, ptr(probs), ptr(assign) if P > 1 else None, M, F, C, P,
                    0.0, 0, ptr(parts), *(ptr(t) for t in cen_out[P]), stream)
            calls[name][kernel] = checked(name, kernel, call)

    print(json.dumps({"variant": "copy_ yardstick (read + write)",
                      "ms": [time_ms(lambda: d1.copy_(feats), iters=50) for _ in range(3)]}),
          flush=True)
    print(json.dumps({"variant": "torch.sum yardstick (read only)",
                      "ms": [time_ms(lambda: torch.sum(feats, dtype=torch.float32), iters=50)
                             for _ in range(3)]}), flush=True)
    ref = {}
    for name in names:
        rec = {"variant": name}
        for kernel, run in calls[name].items():
            run()
            torch.cuda.synchronize()
            got = result[kernel]().clone()
            ref.setdefault(kernel, got)
            log = (out / name / f"{LIB_OF[kernel]}.log").read_text()
            rec[kernel] = {
                "ms": [time_ms(run, iters=50) for _ in range(3)],
                "max_diff_from_base": float((got.float() - ref[kernel].float()).abs().max()),
                "registers_spills": ptxas_of(log, SYMBOL_OF[kernel])}
        print(json.dumps(rec), flush=True)
    for name in reversed(names):
        print(json.dumps({"variant": name, "again_ms": {
            kernel: time_ms(run, iters=50) for kernel, run in calls[name].items()}}),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
