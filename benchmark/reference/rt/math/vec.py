"""Structure-of-arrays 3-vector math (port of ``raytracer_tpu/math/vec.py``).

A ``Vec3`` holds three same-shaped tensors, one per component, so every op
is one elementwise kernel over the ray batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    """SoA 3-vector: three same-shaped tensors (or 0-d tensors)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def full(v) -> "Vec3":
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape, device) -> "Vec3":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def ones(shape, device) -> "Vec3":
        o = torch.ones(shape, dtype=torch.float32, device=device)
        return Vec3(o, o, o)

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_sq(a: Vec3) -> torch.Tensor:
    return dot(a, a)


class _SqrtRN(torch.autograd.Function):
    """``sqrt_rn`` on the CPU with JAX's gradient, ``g * (0.5 / sqrt(x))`` in
    float32 (autograd of torch's ``sqrt`` takes ``g / (2 sqrt(x))``, and
    through the float64 cast it would round once, in float64)."""

    @staticmethod
    def forward(ctx, x):
        r = torch.sqrt(x.double()).float()
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        return g * (torch.full_like(r, 0.5) / r)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device, the one
    every float32 root of the port takes.  torch's float32 ``sqrt`` on the
    CPU is an ulp off in ~0.6% of lanes, where CUDA's and XLA's are correctly
    rounded: on a CUDA tensor this is ``torch.sqrt`` with torch's own
    gradient (no cast, no extra launch), on the CPU the float64 root rounded
    to float32, whose gradient while a graph is recorded is JAX's
    (``_SqrtRN``).  Other dtypes (the float64 runs of the gradient checks)
    take ``torch.sqrt``."""
    if x.dtype != torch.float32 or x.is_cuda:
        return torch.sqrt(x)
    if x.requires_grad and torch.is_grad_enabled():
        return _SqrtRN.apply(x)
    return torch.sqrt(x.double()).float()


def length(a: Vec3) -> torch.Tensor:
    return sqrt_rn(length_sq(a))


def normalize(a: Vec3, eps: float = 0.0) -> Vec3:
    """Normalize; with eps > 0 guards against zero-length vectors."""
    n2 = length_sq(a)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    r = sqrt_rn(n2)
    return Vec3(a.x / r, a.y / r, a.z / r)


def rsqrt_normalize(a: Vec3) -> Vec3:
    """Normalize by a multiply with ``rsqrt`` of the squared length (the
    reference's ``FastNormalize3``).  ``torch.rsqrt`` and ``jax.lax.rsqrt``
    may round differently in the last bits."""
    return a * torch.rsqrt(length_sq(a))


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """Reflect direction ``i`` (pointing into the surface) about normal
    ``n``: ``i - 2 dot(i, n) n`` (``Vector4::Reflect3``)."""
    return i - n * (2.0 * dot(i, n))


def refract(i: Vec3, n: Vec3, eta) -> Vec3:
    """Refract ``i`` (pointing into the surface) through normal ``n``
    (``Vector4::Refract3``).  ``eta`` is the material IoR (n_inside /
    n_outside), inverted when the ray leaves the surface (dot(i, n) > 0).
    Returns the normalized transmitted direction; on total internal
    reflection the result is meaningless (the caller gates on the Fresnel
    term).  The 1e-12 floor keeps the square root differentiable at the
    TIR boundary."""
    cosi = dot(i, n)
    out = cosi > 0.0
    eta_eff = torch.where(out, eta, 1.0 / eta)
    n_eff = where(out, -n, n)
    c = torch.abs(cosi)
    k = torch.clamp_min(1.0 - eta_eff * eta_eff * (1.0 - c * c), 1e-12)
    t = i * eta_eff + n_eff * (eta_eff * c - sqrt_rn(k))
    return normalize(t, eps=1e-20)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Lane select."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y), torch.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y), torch.maximum(a.z, b.z))


def vabs(a: Vec3) -> Vec3:
    return Vec3(torch.abs(a.x), torch.abs(a.y), torch.abs(a.z))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the values of ``torch.clamp``, and the reference's
    gradient at a bound.  ``jnp.clip`` is a maximum then a minimum, and each
    passes half the gradient to each side of a tie, so x exactly on a bound
    gets half of it where ``torch.clamp`` passes all.  Use it where a
    differentiated table value can sit exactly on the bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def max_component(a: Vec3) -> torch.Tensor:
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def min_component(a: Vec3) -> torch.Tensor:
    return torch.minimum(a.x, torch.minimum(a.y, a.z))


def is_finite(a: Vec3) -> torch.Tensor:
    return torch.isfinite(a.x) & torch.isfinite(a.y) & torch.isfinite(a.z)
