"""8-bit grayscale PNG reader and writer (zlib and numpy only).

The port's counterpart of ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` and of
``cv2.imwrite`` for the PNGs the MMWHS and MS-CMRSeg trees hold: 8-bit
grayscale, not interlaced. Every other kind of PNG (colour, 16-bit, fewer
than 8 bits, interlaced) raises a ``ValueError`` that names the file, so
nothing is decoded wrong without a word.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, path) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + w) scanlines at one byte a pixel.
    None and Sub rows need no other row and are undone at once; Up, Average
    and Paeth rows then follow in order, each from the row above it."""
    ftypes, f = raw[:, 0], raw[:, 1:]
    bad = np.flatnonzero(ftypes > 4)
    if bad.size:
        raise ValueError(f"{path}: PNG row {bad[0]} has unknown filter type "
                         f"{ftypes[bad[0]]}")
    out = np.where((ftypes == 1)[:, None], np.cumsum(f, axis=1, dtype=np.uint8), f)
    zero = np.zeros(f.shape[1], np.uint8)
    for y in np.flatnonzero(ftypes > 1):
        up = out[y - 1] if y else zero
        if ftypes[y] == 2:                    # Up
            out[y] = f[y] + up
            continue
        left = 0                              # Average, Paeth: pixel by pixel
        for x in range(f.shape[1]):
            if ftypes[y] == 3:
                pred = (left + int(up[x])) >> 1
            else:
                pred = _paeth(left, int(up[x]), int(up[x - 1]) if x else 0)
            left = (int(f[y, x]) + pred) & 0xFF
            out[y, x] = left
    return out


def read_png_gray(path) -> np.ndarray:
    """Decode an 8-bit grayscale PNG into an (h, w) uint8 array."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    if depth != 8 or colour != 0 or interlace != 0:
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}; only 8-bit grayscale without interlace is read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, "
                         f"{h}x{w} needs {h * (w + 1)}")
    return _unfilter(raw.reshape(h, w + 1), path)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_png_gray(path, img: np.ndarray) -> None:
    """Write an (h, w) uint8 array as an 8-bit grayscale PNG, every row
    with the Sub filter (as ``cv2.imwrite`` writes such images)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"{path}: write_png_gray takes an (h, w) uint8 array, "
                         f"got {img.dtype} {img.shape}")
    h, w = img.shape
    sub = np.diff(img, axis=1, prepend=np.zeros((h, 1), np.uint8))
    rows = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    Path(path).write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b""))
