"""The C++ SLIC library of ``superpixels`` (``slcl_torch/csrc/slic.cpp``).

Built with ``g++ -O3 -std=c++17 -shared -fPIC`` at first use into the
git-ignored ``slcl_torch/_build/`` (the file name carries a hash of the
source and flags, as the CUDA libraries' do) and loaded with ``ctypes``. A
failed build raises: there is no silent fall back to the numpy k-means,
which segments differently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops.cuda.build import BUILD_DIR, CSRC

SRC = CSRC / "slic.cpp"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _target():
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"slic-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The loaded library, compiled first if this source has no build yet."""
    global _lib
    with _lock:
        if _lib is None:
            out = _target()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                                      capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            lib.slcl_slic_assign.restype = ctypes.c_int
            lib.slcl_slic_assign.argtypes = [_F32P, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_float, _I32P]
            lib.slcl_segment_replace.restype = None
            lib.slcl_segment_replace.argtypes = [
                _F32P, _I32P, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, _F32P]
            _lib = lib
        return _lib


def assign(gray: np.ndarray, grid: int, iters: int,
           compactness: float = 1.0) -> np.ndarray:
    """SLIC superpixel assignment map (h, w) int32 in [0, grid*grid)."""
    gray = np.ascontiguousarray(gray, dtype=np.float32)
    if gray.ndim != 2:
        raise ValueError(f"slic.assign takes an (h, w) image, got {gray.shape}")
    h, w = gray.shape
    out = np.empty((h, w), dtype=np.int32)
    rc = load().slcl_slic_assign(gray.ctypes.data_as(_F32P), h, w, int(grid),
                                 int(iters), float(compactness),
                                 out.ctypes.data_as(_I32P))
    if rc < 0:
        raise ValueError(f"slcl_slic_assign: bad arguments {gray.shape}, grid "
                         f"{grid}, iters {iters}")
    return out


def segment_replace(img: np.ndarray, assignment: np.ndarray,
                    replace: np.ndarray) -> np.ndarray:
    """Replace the pixels of the segments flagged in ``replace`` (one flag a
    segment) by their segment mean. img (h, w) or (h, w, ch) float32."""
    squeeze = img.ndim == 2
    img3 = np.ascontiguousarray(img[..., None] if squeeze else img, dtype=np.float32)
    assignment = np.ascontiguousarray(assignment, dtype=np.int32)
    rep = np.ascontiguousarray(replace, dtype=np.uint8)
    if assignment.shape != img3.shape[:2] or assignment.size and (
            assignment.min() < 0 or assignment.max() >= rep.size):
        raise ValueError("segment_replace: the assignment does not fit the image "
                         "or the replace flags")
    out = np.empty_like(img3)
    load().slcl_segment_replace(
        img3.ctypes.data_as(_F32P), assignment.ctypes.data_as(_I32P),
        rep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), assignment.size,
        img3.shape[-1], rep.size, out.ctypes.data_as(_F32P))
    return out[..., 0] if squeeze else out
