"""Wavefront light sampling (NEE) and radiance evaluation (port of
``raytracer_tpu/ops/lights.py``).

Every light kind's Illuminate is computed masked and selected by the
per-light kind.  A background light with a lat-long bitmap is importance
sampled through its 2-D distribution (under tracing, its sample and pdf are
``lights.env`` spans); without one it samples the hemisphere about the
normal.  ``emit`` samples photon emission for the light tracer and VCM.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..math import sampling
from ..math.distribution import pdf_2d, sample_2d
from ..math.vec import Vec3, dot, normalize, sqrt_rn, where as vwhere
from ..scene.types import (
    LIGHT_AREA,
    LIGHT_BACKGROUND,
    LIGHT_DIRECTIONAL,
    LIGHT_SPOT,
    SHAPE_BOX,
    SHAPE_RECT,
    SHAPE_SPHERE,
    Lights,
    Rot3,
)
from ..utils.profiler import span
from .bsdf import _select

BIG = 3.0e38
SCENE_RADIUS = 30.0


class LightSlice(NamedTuple):
    """One light's params gathered per ray (after the random light pick)."""

    kind: torch.Tensor
    color: Vec3
    rot: Rot3
    trans: Vec3
    shape_kind: torch.Tensor
    shape_param: Vec3
    area: torch.Tensor
    cos_angle: torch.Tensor
    is_delta: torch.Tensor
    is_finite: torch.Tensor
    env_tex: torch.Tensor


def gather_light(lights: Lights, idx) -> LightSlice:
    """Every light column at ``idx`` (plain indexing; see ops/materials.py)."""
    idx = torch.as_tensor(idx).long()
    g = lambda v: Vec3(v.x[idx], v.y[idx], v.z[idx])
    return LightSlice(
        kind=lights.kind[idx],
        color=g(lights.color),
        rot=Rot3(g(lights.rot.r0), g(lights.rot.r1), g(lights.rot.r2)),
        trans=g(lights.trans),
        shape_kind=lights.shape_kind[idx],
        shape_param=g(lights.shape_param),
        area=lights.area[idx],
        cos_angle=lights.cos_angle[idx],
        is_delta=lights.is_delta[idx],
        is_finite=lights.is_finite[idx],
        env_tex=lights.env_tex[idx],
    )


class Illumination(NamedTuple):
    dir_to_light: Vec3
    distance: torch.Tensor
    direct_pdf_w: torch.Tensor
    emission_pdf_w: torch.Tensor  # pdf of emitting along this connection (VCM MIS)
    cos_at_light: torch.Tensor
    radiance: Vec3
    valid: torch.Tensor


def _sample_shape_surface(l: LightSlice, u1, u2, u3):
    """Uniform point + normal on the light's shape, in light-local space."""
    rx = l.shape_param.x * (2.0 * u1 - 1.0)
    ry = l.shape_param.y * (2.0 * u2 - 1.0)
    zero = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    rect_p = Vec3(rx, ry, zero)
    rect_n = Vec3(zero, zero, one)
    sph_n = sampling.sample_sphere(u1, u2)
    sph_p = sph_n * l.shape_param.x
    # box: area-weighted face pick by u3, then a uniform point on the face;
    # v < 0.5 selects the -axis face
    hx, hy, hz = l.shape_param.x, l.shape_param.y, l.shape_param.z
    ax_w = hy * hz
    ay_w = hz * hx
    az_w = hx * hy
    c1 = ax_w
    c2 = ax_w + ay_w
    c3 = torch.clamp_min(ax_w + ay_w + az_w, 1e-20)
    v = u3 * c3
    pick_x = v < c1
    pick_y = (~pick_x) & (v < c2)
    vr = torch.where(
        pick_x, v / torch.clamp_min(c1, 1e-20),
        torch.where(pick_y, (v - c1) / torch.clamp_min(ay_w, 1e-20), (v - c2) / torch.clamp_min(az_w, 1e-20)),
    )
    sgn = torch.where(vr < 0.5, -1.0, 1.0)
    a1 = 2.0 * u1 - 1.0
    a2 = 2.0 * u2 - 1.0
    box_p = vwhere(pick_x, Vec3(sgn * hx, a1 * hy, a2 * hz),
                   vwhere(pick_y, Vec3(a2 * hx, sgn * hy, a1 * hz), Vec3(a1 * hx, a2 * hy, sgn * hz)))
    box_n = vwhere(pick_x, Vec3(sgn, zero, zero),
                   vwhere(pick_y, Vec3(zero, sgn, zero), Vec3(zero, zero, sgn)))
    is_sphere = l.shape_kind == SHAPE_SPHERE
    is_box = l.shape_kind == SHAPE_BOX
    p = vwhere(is_sphere, sph_p, vwhere(is_box, box_p, rect_p))
    n = vwhere(is_sphere, sph_n, vwhere(is_box, box_n, rect_n))
    return p, n


def env_sample_direction(env, u1, u2) -> tuple[Vec3, torch.Tensor]:
    """Importance-sample a direction from a lat-long env-map distribution.
    Returns (world direction, solid-angle pdf).  The (u, v) mapping matches
    ``cartesian_to_spherical_uv``, so sampled texels line up with the
    radiance fetches.  Jacobian: pdf_w = pdf_uv / (2 pi^2 sin(theta))."""
    with span("lights.env"):
        u, v, pdf_uv = sample_2d(env, u1, u2)
        theta = v * math.pi
        phi = (u - 0.5) * (2.0 * math.pi)
        sin_t = torch.sin(theta)
        d = Vec3(sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi))
        pdf_w = pdf_uv / torch.clamp_min(2.0 * math.pi * math.pi * sin_t, 1e-6)
        return d, pdf_w


def env_direction_pdf(env, d: Vec3) -> torch.Tensor:
    """Solid-angle pdf :func:`env_sample_direction` assigns to direction
    ``d`` (the MIS counterpart used when a BSDF-sampled ray escapes)."""
    with span("lights.env"):
        u, v = sampling.cartesian_to_spherical_uv(d)
        sin_t = sqrt_rn(torch.clamp_min(1.0 - d.y * d.y, 1e-12))
        return pdf_2d(env, u, v) / torch.clamp_min(2.0 * math.pi * math.pi * sin_t, 1e-6)


def sphere_cone_cos_max(center: Vec3, radius, point: Vec3):
    """cos of the half-angle of the cone subtending a sphere from ``point``.
    Returns (cos_max, dist_to_center, outside)."""
    to_c = center - point
    dc2 = dot(to_c, to_c)
    dc = sqrt_rn(torch.clamp_min(dc2, 1e-12))
    ratio = torch.clamp(radius / torch.clamp_min(dc, 1e-6), 2e-3, 1.0)
    sin2_max = torch.clamp(ratio * ratio, 4e-6, 1.0 - 1e-7)
    cos_max = sqrt_rn(1.0 - sin2_max)
    return cos_max, dc, dc2 > radius * radius


def illuminate(l: LightSlice, shading_pos: Vec3, shading_frame_normal: Vec3, u1, u2, u3,
               env=None, sphere_cone: bool = False, scene_radius: float = SCENE_RADIUS) -> Illumination:
    """NEE sample toward one light, for every light kind.  ``env``: optional
    Distribution2D over the background light's lat-long env map; background
    lanes then importance-sample it instead of the uniform hemisphere.
    ``sphere_cone``: sphere lights sample their subtended cone and rect
    lights the Urena spherical quad (solid-angle sampling)."""
    one = torch.ones_like(u1)

    # point / spot
    to_l = l.trans - shading_pos
    sqr_d = dot(to_l, to_l)
    dist_p = sqrt_rn(torch.clamp_min(sqr_d, 1e-20))
    dir_p = to_l * (1.0 / dist_p)
    pdf_point = sqr_d
    spot_ok = dot(-dir_p, l.rot.r2) >= l.cos_angle

    # area: uniform surface point
    p_local, n_local = _sample_shape_surface(l, u1, u2, u3)
    p_world = l.rot.to_world(p_local) + l.trans
    n_world = l.rot.to_world(n_local)
    to_a = p_world - shading_pos
    sqr_da = dot(to_a, to_a)
    dist_a = sqrt_rn(torch.clamp_min(sqr_da, 1e-20))
    dir_a = to_a * (1.0 / dist_a)
    cos_at = dot(n_world, -dir_a)
    inv_area = 1.0 / torch.clamp_min(l.area, 1e-8)
    pdf_area = inv_area * sqr_da / torch.clamp_min(cos_at, 1e-4)
    area_ok = cos_at > 1e-7

    if sphere_cone:
        radius = l.shape_param.x
        cos_max, dc, outside = sphere_cone_cos_max(l.trans, radius, shading_pos)
        axis = (l.trans - shading_pos) * (1.0 / torch.clamp_min(dc, 1e-20))
        cone_local = sampling.sample_cone(cos_max, u1, u2)
        at, ab = sampling.build_onb(axis)
        dir_s = sampling.local_to_world(cone_local, at, ab, axis)
        cos_t = cone_local.z
        under = radius * radius - dc * dc * (1.0 - cos_t * cos_t)
        under_pos = under > 0.0
        sqrt_under = torch.where(under_pos, sqrt_rn(torch.where(under_pos, under, 1.0)), 0.0)
        t_s = dc * cos_t - sqrt_under
        hit = shading_pos + dir_s * t_s
        n_s = normalize(hit - l.trans, eps=1e-20)
        cos_at_s = dot(n_s, -dir_s)
        pdf_s = sampling.sphere_cap_pdf(cos_max)
        is_sph = l.shape_kind == SHAPE_SPHERE
        dir_a = vwhere(is_sph, dir_s, dir_a)
        dist_a = torch.where(is_sph, t_s, dist_a)
        cos_at = torch.where(is_sph, cos_at_s, cos_at)
        pdf_area = torch.where(is_sph, pdf_s, pdf_area)
        area_ok = torch.where(is_sph, outside & under_pos & (cos_at_s > 1e-7), area_ok)

        hx_r, hy_r = l.shape_param.x, l.shape_param.y
        corner = l.rot.to_world(Vec3(-hx_r, -hy_r, torch.zeros_like(hx_r))) + l.trans
        quad = sampling.spherical_quad_prepare(
            corner, l.rot.r0 * (2.0 * hx_r), l.rot.r1 * (2.0 * hy_r), shading_pos
        )
        p_q, pdf_q = sampling.spherical_quad_sample(quad, shading_pos, u1, u2)
        to_q = p_q - shading_pos
        d2_q = dot(to_q, to_q)
        dist_q = sqrt_rn(torch.clamp_min(d2_q, 1e-20))
        dir_q = to_q * (1.0 / dist_q)
        cos_at_q = dot(l.rot.r2, -dir_q)
        is_rect = l.shape_kind == SHAPE_RECT
        dir_a = vwhere(is_rect, dir_q, dir_a)
        dist_a = torch.where(is_rect, dist_q, dist_a)
        cos_at = torch.where(is_rect, cos_at_q, cos_at)
        pdf_area = torch.where(is_rect, pdf_q, pdf_area)
        area_ok = torch.where(is_rect, cos_at_q > 1e-7, area_ok)

    # background: the env-map distribution when there is one, else the
    # uniform hemisphere about the shading normal
    if env is not None:
        dir_bg, pdf_bg = env_sample_direction(env, u1, u2)
    else:
        h_local = sampling.sample_hemisphere(u1, u2)
        t, b = sampling.build_onb(shading_frame_normal)
        dir_bg = sampling.local_to_world(h_local, t, b, shading_frame_normal)
        pdf_bg = torch.full_like(u1, sampling.uniform_hemisphere_pdf())

    # directional: cone about local -Z
    cone = sampling.sample_cone(l.cos_angle, u1, u2)
    dir_dl_wide = -(l.rot.r0 * cone.x + l.rot.r1 * cone.y + l.rot.r2 * cone.z)
    is_delta_dl = l.cos_angle > 0.9999
    dir_dl = vwhere(is_delta_dl, -l.rot.r2, dir_dl_wide)
    pdf_dl = torch.where(is_delta_dl, 1.0,
                         sampling.sphere_cap_pdf(torch.clamp_max(l.cos_angle, 1.0 - 1e-6)))

    is_spot = l.kind == LIGHT_SPOT
    is_area = l.kind == LIGHT_AREA
    is_bg = l.kind == LIGHT_BACKGROUND
    is_dl = l.kind == LIGHT_DIRECTIONAL

    big = torch.full_like(u1, BIG)
    dir_to_light = vwhere(is_area, dir_a, vwhere(is_bg, dir_bg, vwhere(is_dl, dir_dl, dir_p)))
    distance = _select([is_area, is_bg, is_dl], [dist_a, big, big], dist_p)
    direct_pdf_w = _select([is_area, is_bg, is_dl], [pdf_area, pdf_bg, pdf_dl], pdf_point)
    cos_at_light = _select([is_area], [cos_at], one)
    valid = _select([is_area, is_spot], [area_ok, spot_ok], torch.ones_like(u1, dtype=torch.bool))
    circle_pdf = sampling.uniform_circle_pdf(scene_radius)
    cap = sampling.sphere_cap_pdf(torch.clamp_max(l.cos_angle, 1.0 - 1e-6))
    emission_pdf_w = _select(
        [is_area, is_bg, is_dl, is_spot],
        [
            inv_area * torch.clamp_min(cos_at, 1e-6) / math.pi,
            torch.full_like(u1, sampling.uniform_sphere_pdf() * circle_pdf),
            torch.where(l.cos_angle > 0.9999, 1.0, cap) * circle_pdf,
            cap,
        ],
        torch.full_like(u1, sampling.uniform_sphere_pdf()),
    )
    return Illumination(
        dir_to_light=dir_to_light,
        distance=distance,
        direct_pdf_w=direct_pdf_w,
        emission_pdf_w=emission_pdf_w,
        cos_at_light=cos_at_light,
        radiance=l.color,
        valid=valid,
    )


def area_light_radiance(l: LightSlice, ray_dir: Vec3, hit_normal: Vec3):
    """Area-light radiance for a camera/BSDF ray: (radiance, pdf_a, valid),
    pdf in area measure."""
    valid = dot(hit_normal, -ray_dir) > 1e-7
    return l.color, 1.0 / torch.clamp_min(l.area, 1e-8), valid


def background_radiance(lights: Lights, light_idx: int, ray_dir: Vec3):
    """Background light color for a ray direction."""
    l = gather_light(lights, torch.full_like(ray_dir.x, light_idx, dtype=torch.int64))
    return l.color


class Emission(NamedTuple):
    """One emitted photon per lane, with its pdfs (the throughput is not yet
    divided by the emission pdf)."""

    position: Vec3
    direction: Vec3
    emission_pdf_w: torch.Tensor
    direct_pdf_a: torch.Tensor
    cos_at_light: torch.Tensor
    radiance: Vec3  # color term, NOT yet divided by the emission pdf


def emit(l: LightSlice, u1, u2, u3, u4, u5, scene_radius: float = SCENE_RADIUS) -> Emission:
    """Photon emission sampling for every light kind: point (uniform sphere),
    spot (uniform cone), area (uniform surface point, cosine hemisphere
    about its normal), directional (from a disc on the scene's bounding
    sphere), background (inward from the bounding sphere)."""
    one = torch.ones_like(u1)

    # point: uniform sphere direction, pdf 1/4pi
    dir_point = sampling.sample_sphere(u1, u2)
    pdf_point = torch.full_like(u1, sampling.uniform_sphere_pdf())

    # spot: uniform cone about local +Z
    cone = sampling.sample_cone(l.cos_angle, u1, u2)
    dir_spot = l.rot.to_world(cone)
    pdf_spot = sampling.sphere_cap_pdf(torch.clamp_max(l.cos_angle, 1.0 - 1e-6))

    # area: uniform surface point + cosine hemisphere about the normal
    p_local, n_local = _sample_shape_surface(l, u3, u4, u5)
    p_area = l.rot.to_world(p_local) + l.trans
    n_world = l.rot.to_world(n_local)
    t, b = sampling.build_onb(n_world)
    h = sampling.sample_hemisphere_cos(u1, u2)
    dir_area = sampling.local_to_world(h, t, b, n_world)
    cos_area = h.z
    inv_area = 1.0 / torch.clamp_min(l.area, 1e-8)
    pdf_area_e = inv_area * torch.clamp_min(cos_area, 1e-6) / math.pi

    # directional: from a disc on the scene's bounding sphere
    cx, cy = sampling.sample_circle(u3, u4)
    dl_dir_local = sampling.sample_cone(l.cos_angle, u1, u2)
    dir_dl = -(l.rot.to_world(dl_dir_local))
    du, dv = sampling.build_onb(dir_dl)
    pos_dl = (du * cx + dv * cy - dir_dl) * scene_radius
    pdf_dl_dir = torch.where(l.cos_angle > 0.9999, 1.0,
                             sampling.sphere_cap_pdf(torch.clamp_max(l.cos_angle, 1.0 - 1e-6)))
    pdf_dl = pdf_dl_dir * sampling.uniform_circle_pdf(scene_radius)

    # background: inward from the bounding sphere
    dir_bg = sampling.sample_sphere(u1, u2)
    bu, bv = sampling.build_onb(dir_bg)
    pos_bg = (bu * cx + bv * cy - dir_bg) * scene_radius
    pdf_bg = sampling.uniform_sphere_pdf() * sampling.uniform_circle_pdf(scene_radius)

    is_area = l.kind == LIGHT_AREA
    is_bg = l.kind == LIGHT_BACKGROUND
    is_dl = l.kind == LIGHT_DIRECTIONAL
    is_spot = l.kind == LIGHT_SPOT

    position = vwhere(is_area, p_area, vwhere(is_bg, pos_bg, vwhere(is_dl, pos_dl, l.trans)))
    direction = vwhere(is_area, dir_area,
                       vwhere(is_bg, dir_bg, vwhere(is_dl, dir_dl, vwhere(is_spot, dir_spot, dir_point))))
    emission_pdf = _select([is_area, is_bg, is_dl, is_spot], [pdf_area_e, pdf_bg, pdf_dl, pdf_spot], pdf_point)
    direct_pdf_a = _select([is_area, is_bg], [inv_area, torch.full_like(u1, sampling.uniform_hemisphere_pdf())],
                           one)
    cos_at = torch.where(is_area, cos_area, 1.0)
    # area lights emit radiance * cos into the hemisphere
    radiance = l.color * torch.where(is_area, torch.clamp_min(cos_area, 0.0), 1.0)
    return Emission(
        position=position,
        direction=direction,
        emission_pdf_w=torch.clamp_min(emission_pdf, 1e-12),
        direct_pdf_a=direct_pdf_a,
        cos_at_light=cos_at,
        radiance=radiance,
    )
