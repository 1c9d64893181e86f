"""Trace any set of (pixel, pass) samples of a render in one wavefront.

A sample is a pure function of (pixel id, pass, seed), so the radiance the
program's pass ``p`` gives pixel ``i`` is the radiance of lane (i, p) here:
the same anti-aliasing jitter, Halton vector, blue-noise rotation and
sample stream, each taken per lane instead of per pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .integrators.path_tracer import RenderParams, trace_radiance
from .io.scene_loader import load_scene
from .math.sampling import sample_gaussian2
from .math.vec import Vec3
from .ops import traverse
from .color.colorhelpers import luminance, tonemap
from .render.postprocess import PostprocessParams, to_u8
from .sampler.sampler import (
    _M32,
    blue_noise_for_pixels,
    blue_noise_table,
    halton_frame_vector,
    hash_u32,
    make_stream,
    u32_to_unit_float,
)
from .scene.camera import generate_rays


def lower(tree):
    """Every float tensor of a scene or camera rounded to bfloat16 (the
    control); other leaves as they are."""
    if torch.is_tensor(tree):
        return tree.to(torch.bfloat16).to(torch.float32) if tree.dtype == torch.float32 else tree
    if isinstance(tree, tuple) and hasattr(tree, "_replace"):
        return type(tree)(*(lower(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(lower(x) for x in tree)
    return tree


def load(path: str, device, low_precision: bool = False, aspect: float = 1.0):
    """(scene, meta, camera) of a scene file, parsed by the reference."""
    traverse.LOW_PRECISION = low_precision
    scene, meta, cam = load_scene(path, aspect=aspect, device=device)
    if low_precision:
        scene, cam = lower(scene._replace(clusters=None)), lower(cam)
        if scene.tris is not None:
            host = lambda v: torch.stack(list(v), 1).cpu().numpy()
            t = scene.tris
            scene = scene._replace(clusters=traverse.build_accel(host(t.v0), host(t.e1), host(t.e2), device))
    return scene, meta, cam


def trace_samples(scene, meta, cam, pixel_ids: torch.Tensor, pass_ids: torch.Tensor, width: int, height: int,
                  seed: int, params: RenderParams, low_discrepancy: bool = True, spread: float = 0.5) -> Vec3:
    """Radiance of the sample that pass ``pass_ids[i]`` takes at pixel
    ``pixel_ids[i]`` (int64 tensors of one length) of a ``width`` x
    ``height`` render: with Halton and blue-noise sampling as
    ``Viewport.render`` draws, or, without ``low_discrepancy``, the hashed
    streams ``train_step`` draws."""
    dev = pixel_ids.device
    xs, ys = pixel_ids % width, pixel_ids // width
    cx = (xs.to(torch.float32) + 0.5) / width
    cy = 1.0 - (ys.to(torch.float32) + 0.5) / height
    u1 = u32_to_unit_float(hash_u32((pass_ids * 2654435761 + seed) & _M32))
    u2 = u32_to_unit_float(hash_u32((pass_ids * 0x9E3779B9 + seed + 7) & _M32))
    jx, jy = sample_gaussian2(torch.clamp_min(u1, 1e-6), u2)
    cx = cx + jx * (spread / width)
    cy = cy + jy * (spread / height)
    halton = blue = None
    if low_discrepancy:
        passes = torch.unique(pass_ids).tolist()
        table = torch.as_tensor(np.stack([halton_frame_vector(p) for p in passes]), device=dev)
        halton = table[torch.searchsorted(torch.as_tensor(passes, device=dev), pass_ids)]
        blue = blue_noise_for_pixels(pixel_ids, width)
    stream = make_stream(pixel_ids, pass_ids, seed=seed, halton=halton, blue=blue)
    rays, stream = generate_rays(cam, cx, cy, stream)
    radiance, _ = trace_radiance(scene, meta, rays, stream, params)
    return radiance


def film_mean(radiance: Vec3, n_pixels: int, n_passes: int) -> torch.Tensor:
    """(n_pixels, 3) mean radiance of lanes laid out pass-major
    (lane = pass * n_pixels + pixel): summed pass by pass in pass order, as
    the film accumulates, then divided as ``Viewport.radiance`` divides."""
    rgb = torch.stack([radiance.x, radiance.y, radiance.z], -1).reshape(n_passes, n_pixels, 3)
    acc = torch.zeros_like(rgb[0])
    for p in range(n_passes):
        acc = acc + rgb[p]
    return acc / float(max(n_passes, 1))


def display_pixels(mean_rgb: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, post: PostprocessParams,
                   n_passes: int) -> torch.Tensor:
    """u8 sRGB of the pixels (ys, xs) with mean radiance (S, 3), as
    ``Viewport.image`` makes them: ``postprocess`` pixel by pixel, which
    holds while bloom is off (its blur is the only step that reads other
    pixels), then ``to_u8``."""
    if post.bloom_factor > 0.0:
        raise ValueError("bloom reads other pixels: compare whole images")
    c = mean_rgb
    luma = luminance(c[..., 0], c[..., 1], c[..., 2])[..., None]
    c = torch.clamp_min(luma + (c - luma) * post.saturation, 0.0)
    if post.contrast != 1.0:
        c = torch.exp(torch.log(torch.clamp_min(c, 1e-20)) * post.contrast)
    scale = np.asarray(post.color_filter, np.float32) * np.float32(2.0 ** post.exposure)
    c = c * torch.as_tensor(scale, device=c.device)
    out = tonemap(c, post.tonemapper)
    if post.dithering_strength > 0.0:
        if post.blue_noise_dither:
            table = torch.as_tensor(blue_noise_table(), device=c.device)
            shift = float(np.float32(n_passes) * np.float32(0.618034))
            noise = torch.remainder(table[ys % 128, xs % 128][..., :3] + shift, 1.0) * 2.0 - 1.0
        else:
            raise ValueError("the hashed dither is not compared")
        out = out + noise * post.dithering_strength
    return to_u8(torch.clamp(out, 0.0, 1.0))
