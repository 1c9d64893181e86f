"""GGX (Trowbridge-Reitz) microfacet model (port of
``raytracer_tpu/math/microfacet.py``).  Directions are in local shading
space (+Z = normal)."""

from __future__ import annotations

import math

import torch

from .vec import Vec3, sqrt_rn

INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi


def ggx_d(alpha_sq, n_dot_h):
    """NDF D(m) in the overflow-free form ``a² / (π (c²a² + (1−c²))²)``."""
    a2 = torch.clamp_min(alpha_sq, 1e-10)
    c2 = n_dot_h * n_dot_h
    d = c2 * a2 + (1.0 - c2)  # in [a2, 1]
    return a2 * INV_PI / (d * d)


def ggx_pdf(alpha_sq, n_dot_h):
    """pdf of a sampled microfacet normal: D(m)*|m.z|."""
    return ggx_d(alpha_sq, n_dot_h) * torch.abs(n_dot_h)


def ggx_g1(alpha_sq, n_dot_x):
    """Smith G1 in the stable form ``2c / (c + sqrt(a² + (1−a²)c²))``."""
    c = torch.abs(n_dot_x)
    return 2.0 * c / torch.clamp_min(c + sqrt_rn(alpha_sq + (1.0 - alpha_sq) * c * c), 1e-20)


def ggx_g(alpha_sq, n_dot_v, n_dot_l):
    """Smith height-uncorrelated G = G1(v)·G1(l)."""
    return ggx_g1(alpha_sq, n_dot_v) * ggx_g1(alpha_sq, n_dot_l)


def ggx_sample(alpha_sq, u1, u2) -> Vec3:
    """Sample a microfacet normal from the GGX NDF; sin²θ is computed
    directly so small roughness keeps its sampled angle."""
    denom = torch.clamp_min((1.0 - u1) + alpha_sq * u1, 1e-20)
    cos_theta_sq = (1.0 - u1) / denom
    sin_theta_sq = alpha_sq * u1 / denom
    cos_theta = sqrt_rn(torch.clamp_min(cos_theta_sq, 1e-12))
    sin_theta = sqrt_rn(torch.clamp_min(sin_theta_sq, 1e-12))
    phi = TWO_PI * u2
    return Vec3(sin_theta * torch.sin(phi), sin_theta * torch.cos(phi), cos_theta)
