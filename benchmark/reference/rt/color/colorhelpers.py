"""Color space conversions and tonemapping on tensors of any shape (port of
``raytracer_tpu/color/colorhelpers.py``): sRGB <-> linear, the four
tonemappers (clamped / Reinhard / Hejl-Burgess-Dawson / ACES), Rec.709
luma and HSV -> RGB.
"""

from __future__ import annotations

import torch

from ..ops.bsdf import _select

TONEMAP_CLAMPED = 0
TONEMAP_REINHARD = 1
TONEMAP_HEJL = 2
TONEMAP_ACES = 3

TONEMAPPER_NAMES = {
    "clamped": TONEMAP_CLAMPED,
    "reinhard": TONEMAP_REINHARD,
    "hejl": TONEMAP_HEJL,
    "aces": TONEMAP_ACES,
}


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Exact sRGB OETF."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-7), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    lo = c / 12.92
    hi = torch.pow((c + 0.055) / 1.055, 2.4)
    return torch.where(c <= 0.04045, lo, hi)


def tonemap(color: torch.Tensor, tonemapper: int = TONEMAP_ACES) -> torch.Tensor:
    """Apply the tonemapping curve (the Hejl curve embeds its own gamma)."""
    color = torch.clamp_min(color, 0.0)
    if tonemapper == TONEMAP_CLAMPED:
        return linear_to_srgb(color)
    if tonemapper == TONEMAP_REINHARD:
        return linear_to_srgb(color / (1.0 + color))
    if tonemapper == TONEMAP_HEJL:
        t0 = color * (color * 6.2 + 0.5)
        t2 = color * (color * 6.2 + 1.7) + 0.06
        return t0 / torch.clamp_min(t2, 1e-20)
    if tonemapper == TONEMAP_ACES:
        t0 = color * (color * 2.51 + 0.03)
        t2 = color * (color * 2.43 + 0.59) + 0.14
        return linear_to_srgb(t0 / torch.clamp_min(t2, 1e-20))
    raise ValueError(f"invalid tonemapper {tonemapper}")


def luminance(r, g, b):
    """Rec.709 luma."""
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def hsv_to_rgb(h, s, v):
    """HSV -> linear RGB."""
    h = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6
    sector = [i == k for k in range(6)]
    r = _select(sector, [v, q, p, p, t, v], torch.zeros_like(v))
    g = _select(sector, [t, v, v, q, p, p], torch.zeros_like(v))
    b = _select(sector, [p, p, t, v, v, q], torch.zeros_like(v))
    return r, g, b
