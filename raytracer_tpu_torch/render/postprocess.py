"""Postprocess pipeline: bloom, saturation / contrast / exposure, tonemap,
dither (port of ``raytracer_tpu/render/postprocess.py``).

    avg = sum / passes
    bloom:      avg = avg * (1 - bloomFactor) + bloomFactor * sum_i w_i * blur_i(avg)
    saturation: lerp(luma, c, saturation)
    contrast:   exp(log(c) * contrast)
    exposure:   c *= colorFilter * 2^exposure
    tonemap     (clamped / Reinhard / Hejl / ACES)
    dither:     + bipolar_uniform * ditheringStrength

The 5-level Gaussian bloom pyramid is separable convolutions with zero
padding through ``torch.nn.functional.conv2d``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..color.colorhelpers import TONEMAP_ACES, luminance, tonemap
from ..sampler.sampler import _M32, blue_noise_table, hash_u32, u32_to_unit_float
from ..utils.profiler import host_sync


@dataclass(frozen=True)
class PostprocessParams:
    color_filter: tuple = (1.0, 1.0, 1.0)
    exposure: float = 0.0  # log2 scale
    contrast: float = 0.8
    saturation: float = 0.98
    dithering_strength: float = 0.005
    blue_noise_dither: bool = True
    bloom_factor: float = 0.0
    bloom_levels: int = 5
    tonemapper: int = TONEMAP_ACES


# weights of the 5 blurred pyramid levels
_BLOOM_WEIGHTS = (0.35, 0.25, 0.15, 0.15, 0.1)


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W, 3) image, zero padding."""
    radius = max(1, int(3.0 * sigma))
    k = _gaussian_kernel1d(sigma, radius, img.device)
    x = torch.movedim(img, -1, 0)[:, None]  # (C, 1, H, W)
    x = F.conv2d(x, k.reshape(1, 1, 1, -1), padding=(0, radius))
    x = F.conv2d(x, k.reshape(1, 1, -1, 1), padding=(radius, 0))
    return torch.movedim(x[:, 0], 0, -1)


def apply_bloom(avg: torch.Tensor, params: PostprocessParams) -> torch.Tensor:
    """5-level blur-pyramid bloom."""
    if params.bloom_factor <= 0.0:
        return avg
    bloom = torch.zeros_like(avg)
    blurred = avg
    for i in range(params.bloom_levels):
        blurred = gaussian_blur(blurred, sigma=2.0 * (i + 1))
        bloom = bloom + _BLOOM_WEIGHTS[i] * blurred
    return avg * (1.0 - params.bloom_factor) + bloom * params.bloom_factor


def postprocess(avg: torch.Tensor, params: PostprocessParams, dither_seed: int = 0) -> torch.Tensor:
    """(H, W, 3) mean radiance -> display-ready sRGB in [0, 1]."""
    dev = avg.device
    c = apply_bloom(avg, params)

    # saturation: lerp from luma
    luma = luminance(c[..., 0], c[..., 1], c[..., 2])[..., None]
    c = torch.clamp_min(luma + (c - luma) * params.saturation, 0.0)

    # contrast in log space
    if params.contrast != 1.0:
        c = torch.exp(torch.log(torch.clamp_min(c, 1e-20)) * params.contrast)

    # exposure + color filter
    scale = np.asarray(params.color_filter, np.float32) * np.float32(2.0 ** params.exposure)
    with host_sync("postprocess.scale"):  # a copy from host memory: the device drains first
        scale = torch.as_tensor(scale, device=dev)
    c = c * scale

    out = tonemap(c, params.tonemapper)

    # dither: bipolar noise after the tonemap.  Blue noise (tiled 128x128
    # table, one layer per channel) pushes quantization error to high
    # frequencies; else a hash of the (row, column, channel) index.
    if params.dithering_strength > 0.0:
        h, w, _ = out.shape
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        if params.blue_noise_dither:
            with host_sync("postprocess.blue_noise"):
                table = torch.as_tensor(blue_noise_table(), device=dev)  # (128, 128, 4)
            # per-seed toroidal golden-ratio offset decorrelates frames
            shift = float(np.float32(dither_seed) * np.float32(0.618034))
            noise = torch.remainder(table[ys % 128, xs % 128][..., :3] + shift, 1.0) * 2.0 - 1.0
        else:
            ch = torch.arange(3, device=dev)
            idx = (ys[..., None] * (w * 3) + xs[..., None] * 3 + ch) & _M32
            noise = u32_to_unit_float(hash_u32(idx ^ (dither_seed & _M32))) * 2.0 - 1.0
        out = out + noise * params.dithering_strength

    return torch.clamp(out, 0.0, 1.0)


def to_u8(srgb: torch.Tensor) -> torch.Tensor:
    return torch.clamp(srgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
