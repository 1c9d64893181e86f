"""Spectral rendering support: wavelength sampling and the CIE -> RGB
resolve (port of ``raytracer_tpu/color/spectrum.py``).

Each path samples one hero wavelength.  A path that never meets a
dispersive material keeps its full RGB throughput; the first dispersive
scatter multiplies the throughput once by ``rgb_resolve(lambda)``, the
normalized CIE response of radiance carried at one wavelength drawn
uniformly from [LO, HI].  Its mean over the range is (1, 1, 1), so white
stays white.  The CIE 1931 matching functions are the multi-lobe Gaussian
fits of Wyman, Sloan and Shirley (2013).
"""

from __future__ import annotations

import numpy as np
import torch

# sampled wavelength range, nm
WAVELENGTH_LO = 380.0
WAVELENGTH_HI = 730.0

# strata of the hero wavelength over consecutive passes
NUM_STRATA = 8


def _g(x, alpha, mu, s1, s2):
    """Piecewise Gaussian of the Wyman et al. fits."""
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * torch.exp(-0.5 * t * t)


def cie_xyz(lam):
    """CIE 1931 2-degree matching functions at wavelength ``lam`` (nm)."""
    x = (_g(lam, 1.056, 599.8, 37.9, 31.0)
         + _g(lam, 0.362, 442.0, 16.0, 26.7)
         + _g(lam, -0.065, 501.1, 20.4, 26.2))
    y = _g(lam, 0.821, 568.8, 46.9, 40.5) + _g(lam, 0.286, 530.9, 16.3, 31.1)
    z = _g(lam, 1.217, 437.0, 11.8, 36.0) + _g(lam, 0.681, 459.0, 26.0, 13.8)
    return x, y, z


# XYZ -> linear sRGB
_XYZ_TO_RGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float32,
)

_norm_cache: np.ndarray | None = None


def _channel_norm() -> np.ndarray:
    """Mean RGB response over the range (float64, from a 2,048-point
    quadrature of the fits), so that a uniform wavelength resolves to
    E[rgb] = (1, 1, 1)."""
    global _norm_cache
    if _norm_cache is None:
        def g(x, alpha, mu, s1, s2):
            s = np.where(x < mu, s1, s2)
            return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)

        lam = np.linspace(WAVELENGTH_LO, WAVELENGTH_HI, 2048)
        x = (g(lam, 1.056, 599.8, 37.9, 31.0) + g(lam, 0.362, 442.0, 16.0, 26.7)
             + g(lam, -0.065, 501.1, 20.4, 26.2))
        y = g(lam, 0.821, 568.8, 46.9, 40.5) + g(lam, 0.286, 530.9, 16.3, 31.1)
        z = g(lam, 1.217, 437.0, 11.8, 36.0) + g(lam, 0.681, 459.0, 26.0, 13.8)
        _norm_cache = _XYZ_TO_RGB @ np.stack([x.mean(), y.mean(), z.mean()])
    return _norm_cache


def rgb_resolve(lam):
    """RGB weight of radiance carried at one wavelength ``lam`` (nm) drawn
    uniformly in [LO, HI]; its mean over the range is (1, 1, 1).  The
    matrix entries are float32 and the norm is divided as float32, as XLA
    does with the reference's float64 numpy norm."""
    x, y, z = cie_xyz(lam)
    norm = _channel_norm()
    m = [[float(v) for v in row] for row in _XYZ_TO_RGB]
    r = (m[0][0] * x + m[0][1] * y + m[0][2] * z) / float(np.float32(norm[0]))
    g = (m[1][0] * x + m[1][1] * y + m[1][2] * z) / float(np.float32(norm[1]))
    b = (m[2][0] * x + m[2][1] * y + m[2][2] * z) / float(np.float32(norm[2]))
    return r, g, b


def sample_wavelength(u):
    """Uniform hero wavelength in [LO, HI] from one unit sample."""
    return WAVELENGTH_LO + u * (WAVELENGTH_HI - WAVELENGTH_LO)


def sample_wavelength_stratified(u, pass_idx: int):
    """Hero wavelength in stratum ``pass_idx % NUM_STRATA``: any
    ``NUM_STRATA`` consecutive passes cover the range once per pixel."""
    j = float(pass_idx % NUM_STRATA)
    return WAVELENGTH_LO + ((j + u) / NUM_STRATA) * (WAVELENGTH_HI - WAVELENGTH_LO)


def cauchy_ior(n_d, abbe, lam):
    """Index of refraction at ``lam`` (nm) by Cauchy's equation n = A +
    B / lambda_um^2, with A and B chosen so that n(587.6 nm) = ``n_d`` and
    the Abbe number (n_d - 1) / (n_F - n_C) is ``abbe``."""
    lam_um = lam * 1e-3
    inv_f2 = 1.0 / (0.4861344 ** 2)
    inv_c2 = 1.0 / (0.6562725 ** 2)
    b = (n_d - 1.0) / (torch.clamp_min(abbe, 1e-3) * (inv_f2 - inv_c2))
    a = n_d - b / (0.5875618 ** 2)
    return a + b / torch.clamp_min(lam_um * lam_um, 1e-6)
