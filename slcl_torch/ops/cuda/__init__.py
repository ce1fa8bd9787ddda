"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper module holds a kernel's launch, its ``torch.autograd.Function``
where it needs a gradient, and its plain PyTorch version. A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises — it never falls back.

Every kernel has a :class:`Kernel` record with a plain integer launch
count, raised by one where its wrapper launches it and nowhere else, so a
run can show that the main path went through the kernels.
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


def raise_on_error(rc: int, what: str) -> None:
    """Raise if a C entry point returned non-zero (-1: unsupported shape;
    otherwise the ``cudaError_t`` of ``cudaGetLastError``)."""
    if rc == 0:
        return
    if rc == -1:
        raise ValueError(f"{what}: shape not supported by the kernel")
    raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


VP, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
IP = ctypes.POINTER(ctypes.c_int)


def occupancy(fn, *args) -> Tuple[int, int]:
    """(blocks per SM, shared memory bytes per block) of one kernel from a
    library's ``<name>_occupancy(*args, int*, int*)`` query."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    raise_on_error(fn(*args, ctypes.byref(blocks), ctypes.byref(smem)), fn.__name__)
    return blocks.value, smem.value
