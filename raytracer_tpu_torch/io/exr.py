"""Minimal OpenEXR codec: uncompressed scanline RGB float32/float16 (the
port's own copy of ``raytracer_tpu/io/exr.py``: numpy and ``struct`` only).

The subset the renderer needs, written from the file format's description:
single-part scanline images, ``NO_COMPRESSION``, R/G/B channels, HALF or
FLOAT.  Files written here load in OpenEXR/tev/blender; the reader
additionally accepts either pixel type and any channel order.

Format: magic 0x762f3101, a versioned header of name/type/size attributes, a
scanline offset table, per-scanline ``y, size, pixel data`` chunks, channels
stored planar and sorted by name.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_HALF = 1
_FLOAT = 2


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data


def _channel_list(names, pixel_type: int) -> bytes:
    out = b""
    for n in sorted(names):  # EXR requires alphabetical channel order
        out += n + b"\x00" + struct.pack("<iiii", pixel_type, 0, 1, 1)
    return out + b"\x00"


def write_exr(path: str, image: np.ndarray, half: bool = True) -> None:
    """Write an (H, W, 3) float array as scanline RGB EXR (uncompressed)."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    ptype = _HALF if half else _FLOAT
    dtype = np.float16 if half else np.float32
    psize = 2 if half else 4

    header = b""
    header += _attr(b"channels", b"chlist", _channel_list([b"B", b"G", b"R"], ptype))
    header += _attr(b"compression", b"compression", b"\x00")  # NO_COMPRESSION
    header += _attr(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"displayWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"lineOrder", b"lineOrder", b"\x00")  # INCREASING_Y
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"  # end of header

    preamble = struct.pack("<ii", _MAGIC, 2)  # version 2, single-part scanline
    offset_table_pos = len(preamble) + len(header)
    scan_bytes = 8 + 3 * w * psize  # y + size + B,G,R planes
    first_scan = offset_table_pos + 8 * h
    offsets = struct.pack("<%dQ" % h, *[first_scan + y * scan_bytes for y in range(h)])

    # channels sorted alphabetically: B, G, R
    planes = img[..., ::-1].astype(dtype)  # (H, W, 3) -> B,G,R order
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * w * psize))
            f.write(planes[y].T.tobytes())  # planar: all B, all G, all R


def _read_attrs(buf: bytes, pos: int):
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\x00", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\x00", pos)
        typ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos : pos + size])
        pos += size
    return attrs, pos + 1


def read_exr(path: str) -> np.ndarray:
    """Read a single-part uncompressed scanline EXR -> (H, W, 3) float32."""
    buf = open(path, "rb").read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    attrs, pos = _read_attrs(buf, 8)

    comp = attrs["compression"][1][0]
    if comp != 0:
        raise ValueError(f"only uncompressed EXR supported (compression={comp})")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    # channel list
    chan = []
    cbuf = attrs["channels"][1]
    cpos = 0
    while cbuf[cpos] != 0:
        e = cbuf.index(b"\x00", cpos)
        cname = cbuf[cpos:e].decode()
        ptype = struct.unpack_from("<i", cbuf, e + 1)[0]
        chan.append((cname, ptype))
        cpos = e + 17
    sizes = {_HALF: 2, _FLOAT: 4, 0: 4}  # 0 = UINT
    dtypes = {_HALF: np.float16, _FLOAT: np.float32, 0: np.uint32}

    offsets = struct.unpack_from("<%dQ" % h, buf, pos)
    out = {c: np.zeros((h, w), np.float32) for c, _ in chan}
    for yi, off in enumerate(offsets):
        y, size = struct.unpack_from("<ii", buf, off)
        p = off + 8
        for cname, ptype in chan:  # stored in channel-list (alphabetical) order
            n = w * sizes[ptype]
            row = np.frombuffer(buf[p : p + n], dtype=dtypes[ptype]).astype(np.float32)
            out[cname][y - y0] = row
            p += n

    rgb = np.zeros((h, w, 3), np.float32)
    for i, c in enumerate("RGB"):
        if c in out:
            rgb[..., i] = out[c]
        elif "Y" in out:  # luminance-only fallback
            rgb[..., i] = out["Y"]
    return rgb
