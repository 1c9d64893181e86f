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



def normalize(a: Vec3, eps: float = 0.0) -> Vec3:
    """Normalize; with eps > 0 guards against zero-length vectors."""
    n2 = length_sq(a)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    r = torch.sqrt(n2)
    return Vec3(a.x / r, a.y / r, a.z / r)




def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Lane select."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )




def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the values of ``torch.clamp``, and the reference's
    gradient at a bound.  ``jnp.clip`` is a maximum then a minimum, and each
    passes half the gradient to each side of a tie, so x exactly on a bound
    gets half of it where ``torch.clamp`` passes all.  Use it where a
    differentiated table value can sit exactly on the bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def max_component(a: Vec3) -> torch.Tensor:
    return torch.maximum(a.x, torch.maximum(a.y, a.z))
