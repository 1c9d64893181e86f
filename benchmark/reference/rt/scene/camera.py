"""Camera ray generation (port of ``raytracer_tpu/scene/camera.py``).

Film coords in [0,1)^2 map to bipolar [-1,1]; ``dir = forward +
tanHalfFoV * (right * bx * aspect + up * by)``, with optional barrel
distortion, thin-lens DoF through a circular, hexagonal, square or n-gon
aperture, and camera motion blur (the pose at each ray's shutter time).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math import sampling
from ..math.transform import RigidTransform
from ..math.vec import Vec3, cross, dot, normalize
from ..sampler.sampler import SampleStream, next_1d, next_3d
from .types import Camera

BOKEH_CIRCLE = 0
BOKEH_HEXAGON = 1
BOKEH_SQUARE = 2
BOKEH_NGON = 3


class Rays(NamedTuple):
    """A wavefront of rays (SoA). Direction is normalized."""

    origin: Vec3
    dir: Vec3


def make_camera(
    transform: RigidTransform,
    fov_deg: float = 60.0,
    aspect: float = 1.0,
    enable_dof: bool = False,
    aperture: float = 0.1,
    focal_distance: float = 2.0,
    bokeh_shape: int = BOKEH_CIRCLE,
    aperture_blades: int = 5,
    enable_distortion: bool = False,
    distortion_const: float = 0.01,
    distortion_variable: float = 0.0,
    transform_end: RigidTransform | None = None,
    *,
    device,
) -> Camera:
    """``transform_end`` is the camera pose at shutter close (time 1);
    giving it turns camera motion blur on."""
    f32 = lambda v: torch.tensor(np.float32(v), device=device)
    rows = transform.rot.astype(np.float32)
    mkvec = lambda r: Vec3(f32(r[0]), f32(r[1]), f32(r[2]))
    end = transform_end if transform_end is not None else transform
    rows_end = end.rot.astype(np.float32)
    return Camera(
        origin=mkvec(transform.translation.astype(np.float32)),
        right=mkvec(rows[0]), up=mkvec(rows[1]), forward=mkvec(rows[2]),
        tan_half_fov=f32(np.tan(np.deg2rad(fov_deg) * 0.5)),
        aspect=f32(aspect),
        aperture=f32(aperture),
        focal_distance=f32(focal_distance),
        distortion_const=f32(distortion_const),
        distortion_variable=f32(distortion_variable),
        origin_end=mkvec(end.translation.astype(np.float32)),
        right_end=mkvec(rows_end[0]), up_end=mkvec(rows_end[1]), forward_end=mkvec(rows_end[2]),
        enable_dof=enable_dof,
        bokeh_shape=bokeh_shape,
        aperture_blades=aperture_blades,
        enable_distortion=enable_distortion,
        enable_motion_blur=transform_end is not None,
    )


def _sample_bokeh(cam: Camera, stream: SampleStream):
    """A point of the lens aperture by its shape; three dimensions are
    drawn whatever the shape."""
    u1, u2, u3, stream = next_3d(stream)
    if cam.bokeh_shape == BOKEH_CIRCLE:
        bx, by = sampling.sample_circle(u1, u2)
    elif cam.bokeh_shape == BOKEH_HEXAGON:
        bx, by = sampling.sample_hexagon(u1, u2, u3)
    elif cam.bokeh_shape == BOKEH_SQUARE:
        bx, by = sampling.sample_square(u1, u2)
    else:
        bx, by = sampling.sample_regular_polygon(cam.aperture_blades, u1, u2, u3)
    return bx, by, stream


def _sample_transform(cam: Camera, time):
    """Per-ray camera basis at shutter ``time``: the lerp of the open and
    close poses, re-orthonormalized (Gram-Schmidt of right against
    forward; up = forward x right)."""
    lerp = lambda a, b: Vec3(*(x + (y - x) * time for x, y in zip(a, b)))
    origin = lerp(cam.origin, cam.origin_end)
    fwd = normalize(lerp(cam.forward, cam.forward_end), eps=1e-20)
    r_raw = lerp(cam.right, cam.right_end)
    right = normalize(r_raw - fwd * dot(r_raw, fwd), eps=1e-20)
    return origin, right, cross(fwd, right), fwd


def generate_rays(cam: Camera, coords_x, coords_y, stream: SampleStream, time=None):
    """coords in [0,1)^2 (x right, y up) -> world-space camera rays.
    ``time`` is each ray's shutter time in [0, 1], None for a static frame."""
    bx = 2.0 * coords_x - 1.0
    by = 2.0 * coords_y - 1.0

    if cam.enable_distortion:
        u, stream = next_1d(stream)
        r2 = bx * bx + by * by
        factor = r2 * (cam.distortion_const + cam.distortion_variable * u)
        bx = bx + bx * factor
        by = by + by * factor

    if cam.enable_motion_blur and time is not None:
        cam_origin, right, up, forward = _sample_transform(cam, time)
    else:
        cam_origin, right, up, forward = cam.origin, cam.right, cam.up, cam.forward
    origin = Vec3(*(c.expand(bx.shape) for c in cam_origin))
    direction = forward + (right * (bx * cam.aspect) + up * by) * cam.tan_half_fov

    if cam.enable_dof:
        focus = origin + direction * cam.focal_distance
        px, py, stream = _sample_bokeh(cam, stream)
        origin = origin + right * (px * cam.aperture) + up * (py * cam.aperture)
        direction = focus - origin

    return Rays(origin=origin, dir=normalize(direction, eps=1e-20)), stream


def world_to_film(cam: Camera, p: Vec3):
    """World point -> film coords in [0,1)^2 and whether it lies on the
    film in front of the camera (the light tracer's and VCM's camera
    connections; the shutter-open pose, as in the reference)."""
    rel = p - cam.origin
    # camera-space coordinates (the rows are orthonormal)
    cx = dot(rel, cam.right)
    cy = dot(rel, cam.up)
    cz = dot(rel, cam.forward)
    valid = cz > 1e-6
    inv = 1.0 / torch.where(valid, cz, 1.0)
    fx = cx * inv / (cam.tan_half_fov * cam.aspect)
    fy = cy * inv / cam.tan_half_fov
    u = 0.5 * (fx + 1.0)
    v = 0.5 * (fy + 1.0)
    valid = valid & (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
    return u, v, valid


def camera_pdf_w(cam: Camera, direction: Vec3) -> torch.Tensor:
    """Solid-angle pdf of the camera sampling ``direction``."""
    cos_at_camera = dot(cam.forward, direction)
    pdf = 0.25 / torch.clamp_min(cam.tan_half_fov ** 2 * cos_at_camera ** 3 * cam.aspect, 1e-20)
    return torch.where(cos_at_camera > 0.0, pdf, 0.0)
