"""Packed data formats, elementwise (port of ``raytracer_tpu/math/packed.py``).

Octahedron-mapped unit vectors in 4 bytes, fp16, shared-exponent RGBE,
YCoCg and R11G11B10 floats.  Encoders return the reference's bit patterns
as ``torch.uint32`` (``torch.uint16`` for fp16) tensors; decoders take them
(or the same values in any integer dtype).  torch has no shift on
``uint32``, so the bit work runs in ``int64`` with masks, as
``sampler/sampler.py::_u32`` does.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import torch

from .vec import Vec3, sqrt_rn

_M32 = 0xFFFFFFFF


def _i64(p: torch.Tensor) -> torch.Tensor:
    """Code values as int64 (uint32 bit patterns in [0, 2^32))."""
    return p.to(torch.int64) & _M32


def _code(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint32)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division on every device: CUDA turns a division
    by a Python scalar into a multiplication by its reciprocal, which rounds
    differently from the reference's (and the CPU's) division."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _sign1(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with sign(0) = 1."""
    return torch.sign(torch.where(x == 0.0, 1.0, x))


# --- octahedral unit vectors (2 x 16-bit snorm) -----------------------------------
def oct_encode(v: Vec3) -> torch.Tensor:
    """Unit vector -> (N,) uint32 (16+16-bit octahedral snorm)."""
    norm = torch.abs(v.x) + torch.abs(v.y) + torch.abs(v.z)
    inv = 1.0 / torch.clamp_min(norm, 1e-20)
    px = v.x * inv
    py = v.y * inv
    # fold the lower hemisphere
    fx = (1.0 - torch.abs(py)) * _sign1(px)
    fy = (1.0 - torch.abs(px)) * _sign1(py)
    ox = torch.where(v.z < 0.0, fx, px)
    oy = torch.where(v.z < 0.0, fy, py)
    qx = torch.round((ox * 0.5 + 0.5) * 65535.0).to(torch.int64)
    qy = torch.round((oy * 0.5 + 0.5) * 65535.0).to(torch.int64)
    return _code(qx | (qy << 16))


def oct_decode(p: torch.Tensor) -> Vec3:
    """(N,) uint32 -> unit Vec3."""
    p = _i64(p)
    qx = _div((p & 0xFFFF).to(torch.float32), 65535.0) * 2.0 - 1.0
    qy = _div((p >> 16).to(torch.float32), 65535.0) * 2.0 - 1.0
    z = 1.0 - torch.abs(qx) - torch.abs(qy)
    t = torch.clamp_min(-z, 0.0)
    x = qx - _sign1(qx) * t
    y = qy - _sign1(qy) * t
    inv_len = 1.0 / sqrt_rn(torch.clamp_min(x * x + y * y + z * z, 1e-20))
    return Vec3(x * inv_len, y * inv_len, z * inv_len)


# --- fp16 -------------------------------------------------------------------------
def half_encode(x: torch.Tensor) -> torch.Tensor:
    """f32 -> uint16 bits (IEEE half, round to nearest even)."""
    return x.to(torch.float16).view(torch.uint16)


def half_decode(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.uint16).view(torch.float16).to(torch.float32)


# --- shared-exponent HDR RGB (RGBE, 4 bytes) -----------------------------------------
def rgbe_encode(c: Vec3) -> torch.Tensor:
    """HDR RGB -> (N,) uint32 RGBE (8-bit mantissas + shared 8-bit exponent)."""
    m = torch.maximum(torch.maximum(c.x, c.y), torch.clamp_min(c.z, 1e-32))
    e = torch.ceil(torch.log2(m)).to(torch.int32)
    scale = torch.exp2(-e.to(torch.float32)) * 255.0
    r, g, b = (torch.clamp(torch.round(ch * scale), 0, 255).to(torch.int64) for ch in c)
    eb = torch.clamp(e + 128, 0, 255).to(torch.int64)
    packed = r | (g << 8) | (b << 16) | (eb << 24)
    return _code(torch.where(m <= 1e-30, 0, packed))


def rgbe_decode(p: torch.Tensor) -> Vec3:
    p = _i64(p)
    r = (p & 0xFF).to(torch.float32)
    g = ((p >> 8) & 0xFF).to(torch.float32)
    b = ((p >> 16) & 0xFF).to(torch.float32)
    eb = (p >> 24).to(torch.int32)
    scale = _div(torch.exp2((eb - 128).to(torch.float32)), 255.0)
    scale = torch.where(p == 0, 0.0, scale)
    return Vec3(r * scale, g * scale, b * scale)


# --- YCoCg <-> RGB ---------------------------------------------------------------------
def rgb_to_ycocg(c: Vec3) -> Vec3:
    y = 0.25 * c.x + 0.5 * c.y + 0.25 * c.z
    co = 0.5 * c.x - 0.5 * c.z
    cg = -0.25 * c.x + 0.5 * c.y - 0.25 * c.z
    return Vec3(y, co, cg)


def ycocg_to_rgb(c: Vec3) -> Vec3:
    tmp = c.x - c.z
    return Vec3(tmp + c.y, c.x + c.z, tmp - c.y)


# --- R11G11B10 float ----------------------------------------------------------------------
def _to_small_float(x: torch.Tensor, mant_bits: int) -> torch.Tensor:
    """f32 -> unsigned small float with 5-bit exponent, ``mant_bits``
    mantissa, as int64 code values."""
    x = torch.clamp_min(x, 0.0)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    exp = ((bits >> 23) & 0xFF) - 127
    mant = (bits >> (23 - mant_bits)) & ((1 << mant_bits) - 1)
    out = ((torch.clamp(exp, -14, 15) + 15) << mant_bits) | mant
    # below the smallest normal (2^-14): flush to zero rather than clamp up
    return torch.where((x <= 0.0) | (exp < -14), 0, out)


def _from_small_float(p: torch.Tensor, mant_bits: int) -> torch.Tensor:
    exp = (p >> mant_bits).to(torch.int32) - 15
    mant = (p & ((1 << mant_bits) - 1)).to(torch.float32)
    val = (1.0 + _div(mant, 1 << mant_bits)) * torch.exp2(exp.to(torch.float32))
    return torch.where(p == 0, 0.0, val)


def r11g11b10_encode(c: Vec3) -> torch.Tensor:
    r = _to_small_float(c.x, 6)
    g = _to_small_float(c.y, 6)
    b = _to_small_float(c.z, 5)
    return _code(r | (g << 11) | (b << 22))


def r11g11b10_decode(p: torch.Tensor) -> Vec3:
    p = _i64(p)
    r = _from_small_float(p & 0x7FF, 6)
    g = _from_small_float((p >> 11) & 0x7FF, 6)
    b = _from_small_float(p >> 22, 5)
    return Vec3(r, g, b)
