"""Deterministic counter-based sample streams (port of
``raytracer_tpu/sampler/sampler.py``).

Every sample is a pure hash of (pixel id, pass, dimension, seed), so the
port reproduces the JAX package's streams bit for bit.  The hash works on
uint32 values held in int64 tensors: torch has no ``>>`` for uint32 on the
CPU, so every multiply and add is masked back to 32 bits, and the
multiplies are split into 16-bit halves so no int64 product overflows.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiler import host_sync

MAX_DIMS = 64
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for 0 <= a < 2^32 and a constant 0 <= c < 2^32."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u32(x, device=None) -> torch.Tensor:
    """A uint32 value as an int64 tensor (python ints are reduced mod 2^32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    if device is None:
        return torch.tensor(int(x) & _M32, dtype=torch.int64)
    with host_sync("sampler.u32"):  # a copy from host memory: the device drains first
        return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def hash_u32(x) -> torch.Tensor:
    """PCG output-function style finalizer on uint32 values."""
    x = _u32(x)
    x = (_mul32(x, 747796405) + 2891336453) & _M32
    word = _mul32(((x >> ((x >> 28) + 4)) ^ x), 277803737)
    return (word >> 22) ^ word


def hash_combine(a, b) -> torch.Tensor:
    return hash_u32(_u32(a) ^ _mul32(_u32(b), 0x9E3779B9))


def u32_to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) from the top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


# --- Halton (host-side per-pass vector) ---------------------------------------
_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
    157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
    239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311,
]


def radical_inverse(index: int, base: int) -> float:
    """Van der Corput radical inverse of ``index`` in ``base``."""
    inv_base = 1.0 / base
    reversed_digits = 0
    inv_base_n = 1.0
    while index:
        next_index = index // base
        digit = index - next_index * base
        reversed_digits = reversed_digits * base + digit
        inv_base_n *= inv_base
        index = next_index
    return min(reversed_digits * inv_base_n, 1.0 - 1e-7)


def halton_frame_vector(sample_index: int, n_dims: int = MAX_DIMS) -> np.ndarray:
    """Per-pass global Halton point (one value per dimension)."""
    return np.array(
        [radical_inverse(sample_index + 1, _PRIMES[d % len(_PRIMES)]) for d in range(n_dims)],
        dtype=np.float32,
    )


# --- blue noise ----------------------------------------------------------------
BLUE_NOISE_SIZE = 128
BLUE_NOISE_LAYERS = 4
_blue_noise_cache: Optional[np.ndarray] = None


def blue_noise_table() -> np.ndarray:
    """(128, 128, 4) float32 dither table, read from ``bluenoise128.npy``
    beside this module (the port's copy of the reference's table)."""
    global _blue_noise_cache
    if _blue_noise_cache is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bluenoise128.npy")
        _blue_noise_cache = (np.load(path).astype(np.float32) + 0.5) / 65536.0
    return _blue_noise_cache


def blue_noise_for_pixels(pixel_ids: torch.Tensor, width: int) -> torch.Tensor:
    """Each pixel's 4 blue-noise rotation values, tiled mod 128: (N, 4)."""
    with host_sync("sampler.blue_noise"):
        table = torch.as_tensor(blue_noise_table(), device=pixel_ids.device)
    px = (pixel_ids % width) % BLUE_NOISE_SIZE
    py = (pixel_ids // width) % BLUE_NOISE_SIZE
    return table[py, px]


# --- stream -------------------------------------------------------------------
class SampleStream(NamedTuple):
    """Per-ray sample stream state.  ``dim`` is a python int: the bounce
    loop is a python loop, so the dimension counter lives on the host."""

    pixel_hash: torch.Tensor  # (N,) uint32 values in int64
    pass_salt: torch.Tensor  # () uint32 value in int64
    dim: int
    halton: Optional[torch.Tensor]  # (MAX_DIMS,) f32 per-pass Halton vector
    blue: Optional[torch.Tensor]  # (N, 4) f32 per-pixel blue-noise rotations


def make_stream(pixel_ids, pass_index, seed: int = 0, halton=None, blue=None) -> SampleStream:
    dev = pixel_ids.device
    ph = hash_combine(_u32(pixel_ids), _u32(seed & _M32, dev))
    salt = hash_u32(_u32(pass_index, dev) ^ _u32((seed * 0x85EBCA6B) & _M32, dev))
    return SampleStream(ph, salt, 0, halton, blue)


def next_1d(s: SampleStream):
    d = _u32(s.dim, s.pixel_hash.device)
    if s.halton is not None and s.dim < MAX_DIMS:
        # low-discrepancy: the pass's Halton value rotated per pixel — by
        # blue noise for the first 4 dims, by a hash beyond
        if s.blue is not None and s.dim < BLUE_NOISE_LAYERS:
            rot = s.blue[:, s.dim]
        else:
            rot = u32_to_unit_float(hash_u32(s.pixel_hash ^ hash_combine(d, 0xB5297A4D)))
        u = torch.remainder(s.halton[s.dim] + rot, 1.0)
    else:
        u = u32_to_unit_float(hash_u32(s.pixel_hash ^ hash_combine(d, s.pass_salt)))
    return u, s._replace(dim=s.dim + 1)


def next_2d(s: SampleStream):
    u1, s = next_1d(s)
    u2, s = next_1d(s)
    return u1, u2, s


def next_3d(s: SampleStream):
    u1, s = next_1d(s)
    u2, s = next_1d(s)
    u3, s = next_1d(s)
    return u1, u2, u3, s
