"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper module holds a kernel's launch, its ``torch.autograd.Function``
where it needs a gradient, and its plain PyTorch version. A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises — it never falls back.

Every kernel has a :class:`Kernel` record with a plain integer launch
count, raised by one where its wrapper launches it and nowhere else, so a
run can show that the main path went through the kernels.

Each kernel comes in two families. The templated one is compiled for the
published shapes: C = 4 classes, P <= 2 rMC partitions, feature width F in
{8, 16, 32, 64}. The general one takes C, P and F at run time, any value
whose shared memory fits one block (:func:`general_smem`,
:data:`SMEM_LIMIT`). :func:`route` chooses between them by shape alone;
a shape beyond the limit raises ``ValueError`` (:func:`check_shape`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Optional, Tuple

import torch


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper has launched it."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


KERNELS: Dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS[name] = k
    return k


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def check(t: Optional[torch.Tensor], name: str, dtypes: Iterable[torch.dtype],
          shape: Optional[tuple] = None, device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte-aligned CUDA tensor of
    one of ``dtypes`` (and of ``shape`` / on ``device`` when given)."""
    if t is None:
        return
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    dtypes = tuple(dtypes)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# the feature widths the templated kernels are compiled for
TEMPLATED_F = (8, 16, 32, 64)
# dynamic shared memory a general kernel may take a block, bytes: an H100
# block's 227 KB (cudaDevAttrMaxSharedMemoryPerBlockOptin) less 1 KB for a
# kernel's static shared memory; the C entry points check the device's own
SMEM_LIMIT = 227 * 1024 - 1024
SMEM_FORMULAS = ("rows (MPCL, fused target, pseudo-labels): 4*(C*F + 256*(C|1)); "
                 "centroid forward: 4*G*(P*C*F + P*C + 1 + std*C*F), G = max(1, 256 // F); "
                 "centroid final pass: 4*(2*F + P); "
                 "centroid backward: 4*(P*C*F + P*C + std*2*C*F)")


def route(C: int, P: int, F: int, dtype: torch.dtype = torch.float32) -> str:
    """``"templated"`` when C = 4, P <= 2 and F is in :data:`TEMPLATED_F`
    (bf16 or f32 features), else ``"general"``: by shape alone, never on a
    failure."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"features of dtype {dtype}: the kernels take bf16 or f32")
    return "templated" if C == 4 and 1 <= P <= 2 and F in TEMPLATED_F else "general"


def general_smem(C: int, P: int, F: int, with_std: bool = False) -> Dict[str, int]:
    """Dynamic shared memory (bytes) of each general kernel at (C, P, F):
    the formulas of ``csrc/general.cuh`` and ``csrc/centroids_gen.cuh``."""
    s = int(bool(with_std))
    groups = 1 if F >= 256 else 256 // F
    return {"rows": 4 * (C * F + 256 * (C | 1)),
            "centroid_fwd": 4 * groups * (P * C * F + P * C + 1 + s * C * F),
            "centroid_final": 4 * (2 * F + P),
            "centroid_bwd": 4 * (P * C * F + P * C + s * 2 * C * F)}


def shape_limit(C: int, P: int = 1, F: int = 0, with_std: bool = False) -> str:
    """The general kernels' limit, for a message about (C, P, F)."""
    return (f"C={C}, P={P}, F={F}{' with stddevs' if with_std else ''}: the templated "
            f"kernels take C = 4, P <= 2, F in {TEMPLATED_F}; the general kernels any "
            f"C, P, F >= 1 whose shared memory fits {SMEM_LIMIT} bytes a block "
            f"({SMEM_FORMULAS})")


def check_shape(C: int, F: int, P: int = 1, with_std: bool = False,
                kernels: Iterable[str] = ("rows", "centroid_fwd", "centroid_final",
                                          "centroid_bwd")) -> None:
    """Raise ``ValueError`` naming C, P, F and the limit unless the general
    kernels in ``kernels`` (keys of :func:`general_smem`) fit a block."""
    if min(C, P, F) < 1:
        raise ValueError(f"C={C}, P={P}, F={F}: every one must be >= 1")
    need = general_smem(C, P, F, with_std)
    over = {k: need[k] for k in kernels if need[k] > SMEM_LIMIT}
    if over:
        raise ValueError(f"{shape_limit(C, P, F, with_std)}; this shape needs {over}")


def choose(route_arg: Optional[str], C: int, P: int, F: int, dtype: torch.dtype,
           kernels: Iterable[str], with_std: bool = False) -> Tuple[str, dict]:
    """The family of one wrapper call: ``route_arg`` when given (chip_smoke
    forces one), else :func:`route`'s by shape; a general shape beyond the
    limit of the ``kernels`` it runs raises here, before any launch. Returns
    the family and the shape that error messages name."""
    r = route_arg or route(C, P, F, dtype)
    if r == "general":
        check_shape(C, F, P, with_std, kernels)
    return r, dict(C=C, P=P, F=F, with_std=with_std)


def raise_on_error(rc: int, what: str, shape: Optional[dict] = None) -> None:
    """Raise if a C entry point returned non-zero (-1: a shape beyond the
    kernels' limit, named with ``shape`` = dict(C=, P=, F=, with_std=);
    otherwise the ``cudaError_t`` of ``cudaGetLastError``)."""
    if rc == 0:
        return
    if rc == -1:
        raise ValueError(f"{what}: {shape_limit(**(shape or {}))}")
    raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


VP, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
IP = ctypes.POINTER(ctypes.c_int)


def occupancy(fn, *args) -> Tuple[int, int]:
    """(blocks per SM, shared memory bytes per block) of one kernel from a
    library's ``<name>_occupancy(*args, int*, int*)`` query."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    raise_on_error(fn(*args, ctypes.byref(blocks), ctypes.byref(smem)), fn.__name__)
    return blocks.value, smem.value
