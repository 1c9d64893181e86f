"""Film: HDR accumulation buffers (port of ``raytracer_tpu/render/film.py``).

A primary HDR sum plus a secondary sum fed every second pass (the adaptive
renderer's error estimate).  The film is a NamedTuple of (H, W, 3) float32
tensors; accumulation returns a new film, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math.vec import Vec3
from ..utils.profiler import span


class Film(NamedTuple):
    sum: torch.Tensor  # (H, W, 3) float32 accumulated radiance
    secondary_sum: torch.Tensor  # (H, W, 3) float32 every-2nd-pass sum
    num_passes: int
    num_secondary_passes: int


def make_film(width: int, height: int, device) -> Film:
    z = lambda: torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    return Film(sum=z(), secondary_sum=z(), num_passes=0, num_secondary_passes=0)


def accumulate_frame(film: Film, radiance: Vec3, use_secondary: bool) -> Film:
    """Accumulate a full-frame wavefront result (pixel-ordered, flattened);
    even passes also feed the secondary buffer."""
    h, w = film.sum.shape[:2]
    with span("film.accumulate"):
        frame = torch.stack([radiance.x.reshape(h, w), radiance.y.reshape(h, w), radiance.z.reshape(h, w)], -1)
        return Film(
            sum=film.sum + frame,
            secondary_sum=film.secondary_sum + frame if use_secondary else film.secondary_sum,
            num_passes=film.num_passes + 1,
            num_secondary_passes=film.num_secondary_passes + int(use_secondary),
        )


def average_radiance(film: Film) -> torch.Tensor:
    """(H, W, 3) mean radiance."""
    return film.sum / float(max(film.num_passes, 1))


def error_estimate(film: Film) -> torch.Tensor:
    """(H, W) per-pixel relative error of the mean against the secondary
    buffer's mean (the adaptive metric of ``Viewport.cpp:552-581``):
    |sum/N - sec/M| summed over the channels, over the mean's channel sum
    + 1e-4.  The divisors are tensors: CUDA turns a division by a Python
    scalar into a multiply by its reciprocal, which rounds otherwise."""
    n = film.sum.new_tensor(float(max(film.num_passes, 1)))
    m = film.sum.new_tensor(float(max(film.num_secondary_passes, 1)))
    a = film.sum / n
    d = torch.abs(a - film.secondary_sum / m)
    return (d[..., 0] + d[..., 1] + d[..., 2]) / (a[..., 0] + a[..., 1] + a[..., 2] + 0.0001)


def splat(film: Film, px: torch.Tensor, py: torch.Tensor, color: Vec3, mask) -> Film:
    """Scatter-add a batch of film-space samples (the light tracer's and
    VCM's camera connections).  ``px`` / ``py`` are integer pixel coords;
    lanes off the film or outside ``mask`` add zero to a clipped pixel.

    The sum is ``index_put_(accumulate=True)``, not ``index_add_``: on CUDA
    it sorts the pixel indices and adds each pixel's samples in that order,
    so a pass repeats bit for bit, where ``index_add_``'s atomics add them in
    whatever order the threads arrive.  On the CPU it adds them in lane
    order, as the reference's scatter-add does."""
    h, w = film.sum.shape[:2]
    inb = mask & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    fx = torch.clamp(px, 0, w - 1).long()
    fy = torch.clamp(py, 0, h - 1).long()
    m = inb.to(torch.float32)
    vals = torch.stack([color.x * m, color.y * m, color.z * m], dim=-1)
    return film._replace(sum=film.sum.index_put((fy, fx), vals, accumulate=True))
