"""8-bit RGB PNG files, written and read with the stdlib (``zlib``,
``struct``) and numpy: no PIL."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image (row 0 on top) as a PNG: 8-bit
    truecolour, no interlace, every row with filter type 0."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("write_png takes an (H, W, 3) uint8 array")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB, non-interlaced PNG as (H, W, 3) uint8, row 0 on top
    (all five row filters).  Raises ``ValueError`` for another variant or a
    file that is not a PNG."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + data) & 0xFFFFFFFF != struct.unpack_from(">I", buf, pos + 8 + length)[0]:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNG is read (IHDR {header})")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int64)
    prev = np.zeros(3 * w, np.int64)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 255
        elif kind in (1, 3, 4):
            cur = line.copy()
            for x in range(3 * w):
                a = int(cur[x - 3]) if x >= 3 else 0
                c = int(prev[x - 3]) if x >= 3 else 0
                pred = a if kind == 1 else (a + int(prev[x])) // 2 if kind == 3 else _paeth(a, int(prev[x]), c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"{path}: unknown row filter {kind}")
        out[y] = prev = cur
    return out.astype(np.uint8).reshape(h, w, 3)
