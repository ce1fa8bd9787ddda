"""Minimal native NIfTI-1 reader/writer (replaces SimpleITK/nibabel).

A copy of ``slcl_tpu/data/nifti.py`` (numpy, gzip and struct only), so the
port reads the raw MMWHS slices without importing ``slcl_tpu``.

The reference reads per-slice ``.nii`` files with SimpleITK
(utils/utils_.py:1002-1020). The format is implemented directly: NIfTI-1,
single-file (``n+1``) and detached-header (``ni1``) magic, optional gzip,
scl_slope/inter scaling, the common integer/float datatypes.

``read_nii`` returns the array in SimpleITK axis order (z, y, x — reversed
Fortran dims) to match the reference's indexing expectations, plus the voxel
spacing (pixdim) in the same axis order.
"""
from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_nii(path) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Read a NIfTI-1 file -> (array[z, y, x, ...reversed dims], spacing)."""
    with _open(path) as f:
        hdr = f.read(352)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        endian = "<"
        if sizeof_hdr != 348:
            endian = ">"
            sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
            if sizeof_hdr != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
        dim = struct.unpack_from(endian + "8h", hdr, 40)
        ndim = int(dim[0])
        shape = tuple(int(d) for d in dim[1:1 + ndim])
        datatype = struct.unpack_from(endian + "h", hdr, 70)[0]
        pixdim = struct.unpack_from(endian + "8f", hdr, 76)
        vox_offset = int(struct.unpack_from(endian + "f", hdr, 108)[0])
        scl_slope = struct.unpack_from(endian + "f", hdr, 112)[0]
        scl_inter = struct.unpack_from(endian + "f", hdr, 116)[0]
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
        f.seek(vox_offset if vox_offset >= 348 else 352)
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                             count=count)
    arr = data.reshape(shape[::-1])  # Fortran order -> reversed C-order (z, y, x)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        arr = arr.astype(np.float32) * slope + scl_inter
    spacing = tuple(float(p) for p in pixdim[1:1 + ndim])[::-1]
    return np.ascontiguousarray(arr), spacing


def write_nii(path, array: np.ndarray, spacing: Optional[Tuple[float, ...]] = None):
    """Write an array (z, y, x order, like read_nii returns) as NIfTI-1."""
    path = str(path)
    arr = np.ascontiguousarray(array)
    shape = arr.shape[::-1]  # back to Fortran dims
    ndim = len(shape)
    if spacing is None:
        spacing = (1.0,) * ndim
    else:
        spacing = tuple(spacing)[::-1]
    dtype = arr.dtype
    if dtype not in _CODES:
        arr = arr.astype(np.float32)
        dtype = arr.dtype
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [ndim] + list(shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[dtype])
    struct.pack_into("<h", hdr, 72, dtype.itemsize * 8)
    pixdim = [1.0] + list(spacing) + [1.0] * (7 - ndim)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + arr.tobytes(order="C")
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
