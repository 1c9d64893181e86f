"""Uncompressed 24-bit BMP files, read and written with numpy alone."""

from __future__ import annotations

import struct

import numpy as np


class UnsupportedBmp(ValueError):
    """A well-formed BMP of a variant that ``read_bmp`` does not read."""


def read_bmp(path: str) -> np.ndarray:
    """An uncompressed 24-bit BMP as (H, W, 3) uint8 RGB, rows top-down as an
    image viewer shows them (a positive height in the header means the file
    stores them bottom-up).  Raises ``UnsupportedBmp`` for another variant
    and a plain ``ValueError`` for a file that is not a BMP or is cut short."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"BM":
        raise ValueError(f"not a BMP file: {path}")
    if len(buf) < 54:
        raise ValueError(f"{path}: BMP header cut short ({len(buf)} bytes)")
    (offset,) = struct.unpack_from("<I", buf, 10)
    width, height, _planes, bpp, compression = struct.unpack_from("<iiHHI", buf, 18)
    if bpp != 24 or compression != 0:
        raise UnsupportedBmp(f"{path}: only uncompressed 24-bit BMP is read (bits {bpp}, compression {compression})")
    stride = (width * 3 + 3) & ~3  # rows are padded to 4 bytes
    if width <= 0 or height == 0 or offset + stride * abs(height) > len(buf):
        raise ValueError(f"{path}: BMP pixel array cut short ({width} x {abs(height)} at offset {offset}, "
                         f"{len(buf)} bytes)")
    rows = np.frombuffer(buf, np.uint8, stride * abs(height), offset).reshape(abs(height), stride)
    img = rows[:, : width * 3].reshape(abs(height), width, 3)[..., ::-1]  # BGR -> RGB
    return np.ascontiguousarray(img[::-1] if height > 0 else img)


def write_bmp(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image (row 0 on top) as a bottom-up
    uncompressed 24-bit BMP."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("write_bmp takes an (H, W, 3) uint8 array")
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up, BGR
    header = struct.pack("<2sIHHI", b"BM", 54 + stride * h, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + rows.tobytes())
