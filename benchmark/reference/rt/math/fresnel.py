"""Fresnel terms (port of ``raytracer_tpu/math/fresnel.py``)."""

from __future__ import annotations

import torch

from .vec import sqrt_rn


def fresnel_dielectric(n_dot_v: torch.Tensor, eta) -> torch.Tensor:
    """Dielectric Fresnel reflectance, bug-compatible with the C++ renderer.

    ``n_dot_v`` > 0 means the ray arrives from outside (eta flips to
    1/ior).  The reference uses ``g = cos(theta_t)`` inside the
    Cook-Torrance shell, which gives F = 0 at normal incidence instead of
    R0; the JAX package copies that on purpose to match the reference's
    goldens, and so does this port.  Returns 1.0 on total internal
    reflection.
    """
    eta_eff = torch.where(n_dot_v > 0.0, 1.0 / eta, eta)
    c = torch.abs(n_dot_v)
    g2 = 1.0 - eta_eff * eta_eff * (1.0 - c * c)
    tir = g2 <= 0.0
    g = sqrt_rn(torch.clamp_min(g2, 1e-12))
    a = (g - c) / torch.clamp_min(g + c, 1e-20)
    b = (c * (g + c) - 1.0) / (c * (g - c) + 1.0)
    f = 0.5 * a * a * (1.0 + b * b)
    return torch.where(tir, 1.0, f)


def fresnel_metal(n_dot_v: torch.Tensor, eta, k) -> torch.Tensor:
    """Conductor Fresnel reflectance."""
    c2 = n_dot_v * n_dot_v
    a = eta * eta + k * k
    b = a * c2
    rs = (b - 2.0 * eta * n_dot_v + 1.0) / (b + 2.0 * eta * n_dot_v + 1.0)
    rp = (a - 2.0 * eta * n_dot_v + c2) / (a + 2.0 * eta * n_dot_v + c2)
    return 0.5 * (rs + rp)
