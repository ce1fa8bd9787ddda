"""Build and load the port's CUDA kernels.

Each ``slcl_torch/csrc/<name>.cu`` has a plain C interface and is compiled
by one ``nvcc`` call for ``sm_90a`` into ``slcl_torch/_build/<name>-<hash>.so``
(a directory git ignores), then loaded with ``ctypes``. The file name
carries a hash of the source and flags, so an edited source rebuilds and an
unchanged one loads at once. :func:`build_all` starts one ``nvcc`` per
source together and waits for all of them.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Sequence, Tuple

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
# -Xptxas -v: ptxas reports registers and spills per kernel into the log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]
SOURCES = ("mpcl", "mpcl_pseudo", "pseudo_label", "soft_centroids")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "slcl_torch's kernels (set CUDA_HOME or PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build_all(names: Iterable[str] = SOURCES) -> List[Path]:
    """Compile every missing library, one ``nvcc`` per source, in parallel.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    outs = []
    for name in names:
        out = _target(name)
        outs.append(out)
        if not out.exists():
            jobs.append((out, _start(name, out)))
    errors = []
    for out, proc in jobs:
        log, _ = proc.communicate()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            errors.append(f"{out.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return outs


def ptxas_report(name: str) -> List[Tuple[str, int, int]]:
    """(kernel symbol, registers, spill-store bytes) per kernel of the built
    ``csrc/<name>.cu``, from the ptxas log kept beside the library."""
    log = _target(name).with_suffix(".log").read_text()
    rows, fn, spill = [], "", 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append((fn, int(m.group(1)), spill))
    return rows


def load(name: str, signatures: Dict[str, Tuple[Any, Sequence[Any]]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use.
    ``signatures`` maps each C function to ``(restype, argtypes)``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _libs[name] = lib
        return lib
