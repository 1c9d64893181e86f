"""Wavefront path tracer, naive + MIS (port of
``raytracer_tpu/integrators/path_tracer.py``).

The bounce loop is a python loop over bounce index with per-lane alive
masks.  With MIS and one shadow ray per lane, each bounce's shadow query is
traced in ONE wavefront with the next bounce's closest-hit rays: the shadow
lanes carry a negative limit and keep any-hit semantics in the wave2
engine.  ``RenderParams.count_traversal`` adds each live ray's box and
triangle tests (``scene_traversal_cost``) to the counters.  A per-ray
shutter ``time`` (motion blur) holds along the whole path.  In spectral
mode each path draws one hero wavelength; dispersive materials refract by
it, and the first dispersive scatter of a path weights its throughput once
by the wavelength's CIE response (``color/spectrum.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..math.sampling import (
    cartesian_to_spherical_uv,
    local_to_world,
    pdf_area_to_solid_angle,
    sphere_cap_pdf,
    spherical_quad_prepare,
    world_to_local,
)
from ..color.spectrum import rgb_resolve, sample_wavelength, sample_wavelength_stratified
from ..math.vec import Vec3, clip, dot, max_component, where as vwhere
from ..ops import bsdf as bsdf_ops
from ..ops.intersect import BIG, Hits, PrimFrame
from ..ops.lights import env_direction_pdf, gather_light, illuminate, sphere_cone_cos_max
from ..ops.materials import apply_normal_map, resolve_material
from ..ops.textures import sample_texture_many
from ..ops.traverse import scene_hit_frame, scene_occluded, scene_traversal_cost, scene_traverse
from ..sampler.sampler import SampleStream, next_1d, next_3d
from ..scene.camera import Rays
from ..scene.types import (
    LIGHT_AREA,
    LIGHT_BACKGROUND,
    LIGHT_DIRECTIONAL,
    SHAPE_RECT,
    SHAPE_SPHERE,
    SceneData,
    SceneMeta,
)
from ..utils.profiler import span

RAY_OFFSET = 1e-3  # secondary ray epsilon
SHADOW_OFFSET = 1e-4  # shadow ray epsilon


@dataclass(frozen=True)
class RenderParams:
    """Static integrator config."""

    max_depth: int = 20
    min_rr_depth: int = 1
    mis: bool = True  # False => naive PathTracer semantics
    light_strategy: str = "single"  # "single" | "all"
    # hero-wavelength spectral rendering: each path samples one wavelength;
    # dispersive dielectrics refract by it and collapse the path to it
    spectral: bool = False
    # opt-in per-ray traversal-work counters: an extra slab pass a bounce
    count_traversal: bool = False


class Counters(NamedTuple):
    """Per-wavefront ray counters (0-d float32 tensors)."""

    num_rays: torch.Tensor  # primary + secondary rays actually traced
    num_shadow_rays: torch.Tensor
    num_overflow: torch.Tensor = None  # rays whose mesh traversal may have truncated
    # ray-box and ray-triangle tests of the live rays (count_traversal)
    num_box_tests: torch.Tensor = None
    num_tri_tests: torch.Tensor = None


def _combine_mis(sample_pdf, other_pdf):
    """Balance heuristic."""
    return sample_pdf / torch.clamp_min(sample_pdf + other_pdf, 1e-12)


def _light_pick_probability(meta: SceneMeta, params: RenderParams) -> float:
    if params.light_strategy == "all":
        return 1.0
    return 1.0 / max(meta.n_lights, 1)


def _light_color(scene: SceneData, li: int) -> Vec3:
    c = scene.lights.color
    return Vec3(c.x[li], c.y[li], c.z[li])


def _env_radiance(scene: SceneData, li: int, direction: Vec3) -> Vec3:
    """Background color along a direction, times the light's lat-long
    texture when the scene has textures (the ``lights.env`` span)."""
    with span("lights.env"):
        color = _light_color(scene, li)
        if scene.textures is not None:
            u, v = cartesian_to_spherical_uv(direction)
            ids = torch.zeros_like(direction.x, dtype=torch.int32) + scene.lights.env_tex[li]
            color = color * sample_texture_many(scene.textures, ids, u, v, site="env")
        return color


def _eval_global_lights(scene: SceneData, meta: SceneMeta, direction: Vec3, last_pdf, last_specular,
                        depth: int, pick_prob, use_mis_weights: bool) -> Vec3:
    """Radiance from infinite lights on ray miss, MIS-weighted (host
    unroll over the static light kinds)."""
    lights = scene.lights
    total = Vec3.full(torch.zeros_like(direction.x))
    use_mis = (~last_specular) if (use_mis_weights and depth > 0) else None
    for li, kind in enumerate(meta.light_kinds):
        if kind == LIGHT_BACKGROUND:
            radiance = _env_radiance(scene, li, direction)
            if scene.env_dist is not None:
                # must be the pdf NEE sampled with (env importance sampling)
                direct_pdf_w = env_direction_pdf(scene.env_dist, direction)
            else:
                direct_pdf_w = 1.0 / (2.0 * math.pi)
            visible = torch.ones_like(direction.x)
        elif kind == LIGHT_DIRECTIONAL and not meta.light_is_delta[li]:
            cos_angle = lights.cos_angle[li]
            axis = Vec3(lights.rot.r2.x[li], lights.rot.r2.y[li], lights.rot.r2.z[li])
            visible = (dot(direction, axis) < -cos_angle).to(torch.float32)
            radiance = _light_color(scene, li)
            direct_pdf_w = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cos_angle), 1e-20)
        else:
            continue
        if use_mis is None:
            w = 1.0
        else:
            w = torch.where(use_mis, _combine_mis(last_pdf, direct_pdf_w * pick_prob), 1.0)
        total = total + radiance * (w * visible)
    return total


def _sample_lights_nee(scene: SceneData, meta: SceneMeta, params: RenderParams, frame: PrimFrame,
                       mp, wo_local, pick_prob, is_last: bool, stream: SampleStream,
                       time=None, active=None, defer=False):
    """NEE: 'single' picks one light uniformly, 'all' loops every light.

    ``defer=False`` traces the shadow ray here and returns (contribution,
    n_shadow_rays, n_shadow_overflow, stream).  ``defer=True`` (one shadow
    ray per lane) skips the occlusion query and returns (unoccluded
    contribution, shadow Rays, shadow cap, n_shadow_rays, stream) so the
    caller can fuse the query with the next bounce."""
    n_lights = max(meta.n_lights, 1)
    u_pick, stream = next_1d(stream)
    if params.light_strategy == "all" and n_lights > 1:
        light_indices = [torch.full_like(frame.material_id, i) for i in range(n_lights)]
    elif n_lights == 1:
        light_indices = [torch.zeros_like(frame.material_id)]
    else:
        light_indices = [torch.clamp((u_pick * n_lights).to(torch.int32), 0, n_lights - 1)]
    assert not (defer and len(light_indices) > 1), "defer needs one shadow ray"

    total = Vec3.full(torch.zeros_like(wo_local.x))
    n_shadow = torch.zeros((), dtype=torch.float32, device=wo_local.x.device)
    n_overflow = torch.zeros_like(n_shadow)
    for light_idx in light_indices:
        l = gather_light(scene.lights, light_idx)
        u1, u2, u3, stream = next_3d(stream)
        ill = illuminate(l, frame.position, frame.normal, u1, u2, u3,
                         env=scene.env_dist, sphere_cone=True, scene_radius=meta.scene_radius)
        radiance = ill.radiance
        if meta.background_light_index >= 0 and scene.textures is not None:
            bg_rad = _env_radiance(scene, meta.background_light_index, ill.dir_to_light)
            radiance = vwhere(l.kind == LIGHT_BACKGROUND, bg_rad, radiance)
        wi_local = world_to_local(ill.dir_to_light, frame.tangent, frame.bitangent, frame.normal)
        f, bsdf_pdf = bsdf_ops.evaluate(mp, wo_local, wi_local)
        f_nonzero = max_component(f) > 0.0

        shadow_origin = frame.position + ill.dir_to_light * SHADOW_OFFSET
        max_t = torch.clamp_max(ill.distance * 0.999, BIG)
        # lanes whose NEE contribution is already zero shadow-trace with
        # t_max = 0: free in the wavefront engine (zero candidates)
        lit = ill.valid & f_nonzero
        needed = lit if active is None else lit & active
        n_shadow = n_shadow + lit.to(torch.float32).sum()

        mis_w = _combine_mis(ill.direct_pdf_w * pick_prob, bsdf_pdf)
        w = 1.0 if is_last else torch.where(~l.is_delta, mis_w, 1.0)
        scale = w / torch.clamp_min(pick_prob * ill.direct_pdf_w, 1e-12) * lit.to(torch.float32)
        contrib = radiance * f * scale
        cap = torch.where(needed, max_t, 0.0)

        if defer:
            return contrib, Rays(origin=shadow_origin, dir=ill.dir_to_light), cap, n_shadow, stream

        occluded, sh_ovf = scene_occluded(scene, shadow_origin, ill.dir_to_light, cap, time=time)
        n_overflow = n_overflow + (lit & sh_ovf).to(torch.float32).sum()
        total = total + contrib * (~occluded).to(torch.float32)
    return total, n_shadow, n_overflow, stream


def _take(hits: Hits, sl: slice) -> Hits:
    """The lanes ``sl`` of every field of a hit record."""
    return Hits(*(None if f is None else tuple(a[sl] for a in f) if isinstance(f, tuple) else f[sl]
                  for f in hits))


def trace_radiance(scene: SceneData, meta: SceneMeta, rays: Rays, stream: SampleStream,
                   params: RenderParams, time=None, pass_idx: int | None = None):
    """Trace a wavefront to completion. Returns (radiance per ray, counters).

    ``time`` (N,): each ray's shutter time, the same along its path (None =
    static).  ``pass_idx``: in spectral mode, the stratum of the hero
    wavelength (``sample_wavelength_stratified``); None draws it from the
    whole range."""
    with span("integrator"):
        n = rays.origin.x.shape
        dev = rays.origin.x.device
        pick_prob = _light_pick_probability(meta, params)
        fused_shadow = params.mis and not (params.light_strategy == "all" and meta.n_lights > 1)
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        wavelength = dispersed = None
        if params.spectral:
            u_l, stream = next_1d(stream)
            wavelength = sample_wavelength(u_l) if pass_idx is None else sample_wavelength_stratified(u_l, pass_idx)
            dispersed = torch.zeros(n, dtype=torch.bool, device=dev)

        origin, direction = rays.origin, rays.dir
        # camera segment traced up front; every later segment is traced fused
        # with the preceding bounce's shadow ray
        hits = scene_traverse(scene, origin, direction, time=time)
        throughput = Vec3.ones(n, dev)
        result = Vec3.zeros(n, dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        last_pdf = torch.ones(n, dtype=torch.float32, device=dev)
        last_specular = torch.ones(n, dtype=torch.bool, device=dev)
        num_rays = zero + float(n[0])
        num_shadow = zero
        num_overflow = zero
        num_box = zero
        num_tri = zero

        # the final step only resolves the last segment's miss / light hit
        for depth in range(params.max_depth + 1):
            with span("integrator.bounce", depth=depth):
                if params.count_traversal:
                    bt, tt = scene_traversal_cost(scene, origin, direction, time=time)
                    live = alive.to(torch.float32)
                    num_box = num_box + (bt * live).sum()
                    num_tri = num_tri + (tt * live).sum()
                num_overflow = num_overflow + (alive & hits.overflow).to(torch.float32).sum()
                with span("integrator.shading"):
                    miss = hits.t >= BIG * 0.5
                    hits = hits._replace(t=torch.clamp(hits.t, 0.0, 1e12))

                    # --- miss: global (infinite) lights
                    bg = _eval_global_lights(scene, meta, direction, last_pdf, last_specular, depth, pick_prob,
                                             use_mis_weights=params.mis)
                    result = result + throughput * bg * (alive & miss).to(torch.float32)

                    # --- shading frame at the hit
                    frame = apply_normal_map(scene, scene_hit_frame(scene, hits, origin, direction, time=time))

                    # --- direct light hit
                    hit_light = alive & (~miss) & (frame.light_id >= 0)
                    l_hit = gather_light(scene.lights, torch.clamp_min(frame.light_id, 0))
                    cos_at_light = dot(frame.normal, -direction)
                    l_visible = cos_at_light > 1e-7
                    direct_pdf_a = 1.0 / torch.clamp_min(l_hit.area, 1e-8)
                    direct_pdf_w = pdf_area_to_solid_angle(direct_pdf_a, hits.t, cos_at_light)
                    # sphere lights: NEE samples the subtended cone
                    cos_max, _, outside_s = sphere_cone_cos_max(l_hit.trans, l_hit.shape_param.x, origin)
                    is_sphere_area = (l_hit.kind == LIGHT_AREA) & (l_hit.shape_kind == SHAPE_SPHERE)
                    direct_pdf_w = torch.where(is_sphere_area & outside_s, sphere_cap_pdf(cos_max), direct_pdf_w)
                    # rect lights: NEE samples the spherical quad, pdf 1/S
                    hx_r, hy_r = l_hit.shape_param.x, l_hit.shape_param.y
                    corner = l_hit.rot.to_world(Vec3(-hx_r, -hy_r, torch.zeros_like(hx_r))) + l_hit.trans
                    quad = spherical_quad_prepare(corner, l_hit.rot.r0 * (2.0 * hx_r), l_hit.rot.r1 * (2.0 * hy_r),
                                                  origin)
                    is_rect_area = (l_hit.kind == LIGHT_AREA) & (l_hit.shape_kind == SHAPE_RECT)
                    direct_pdf_w = torch.where(is_rect_area, 1.0 / quad[-1], direct_pdf_w)
                    if params.mis and depth > 0:
                        w_light = torch.where(~last_specular, _combine_mis(last_pdf, direct_pdf_w * pick_prob), 1.0)
                    else:
                        w_light = 1.0
                    m_light = (hit_light & l_visible).to(torch.float32)
                    result = result + throughput * l_hit.color * (w_light * m_light)

                    # --- surviving shading lanes
                    survive = alive & (~miss) & (~hit_light)
                    mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v,
                                          wavelength=wavelength, position=frame.position)
                    result = result + throughput * mp.emission * survive.to(torch.float32)
                    wo_local = world_to_local(-direction, frame.tangent, frame.bitangent, frame.normal)

                    is_last = depth >= params.max_depth
                    # NEE applies with the PRE-RR throughput and mask
                    survive_pre, throughput_pre = survive, throughput
                    shadow = None
                    if fused_shadow:
                        nee_c, shadow_rays, shadow_cap, n_sh, stream = _sample_lights_nee(
                            scene, meta, params, frame, mp, wo_local, pick_prob, is_last, stream,
                            time=time, active=survive, defer=True)
                        shadow = (nee_c, shadow_rays, shadow_cap)
                        num_shadow = num_shadow + n_sh
                    elif params.mis:
                        nee, n_sh, n_sh_ovf, stream = _sample_lights_nee(
                            scene, meta, params, frame, mp, wo_local, pick_prob, is_last, stream, time=time,
                            active=survive)
                        num_shadow = num_shadow + n_sh
                        num_overflow = num_overflow + n_sh_ovf
                        result = result + throughput * nee * survive.to(torch.float32)

                    # --- depth cap
                    if depth >= params.max_depth:
                        survive = torch.zeros_like(survive)

                    # --- Russian roulette
                    u_rr, stream = next_1d(stream)
                    threshold = 0.125 + 0.875 * clip(max_component(mp.base_color), 0.0, 1.0)
                    if depth >= params.min_rr_depth:
                        survive = survive & ~(u_rr > threshold)
                        throughput = throughput * torch.where(survive, 1.0 / torch.clamp_min(threshold, 1e-6), 1.0)

                    # --- BSDF sampling
                    u1, u2, u3, stream = next_3d(stream)
                    smp = bsdf_ops.sample(mp, wo_local, u1, u2, u3)
                    survive = survive & smp.valid
                    wi_world = local_to_world(smp.wi, frame.tangent, frame.bitangent, frame.normal)
                    throughput = throughput * vwhere(survive, smp.weight, Vec3.ones(n, dev))
                    survive = survive & (max_component(throughput) > 1e-7)

                    # --- the hero wavelength collapses at the first dispersive scatter:
                    # the throughput takes its CIE -> RGB weight once
                    if params.spectral:
                        collapse = survive & mp.dispersive & (~dispersed)
                        throughput = vwhere(collapse, throughput * Vec3(*rgb_resolve(wavelength)), throughput)
                        dispersed = dispersed | (survive & mp.dispersive)

                    new_origin = vwhere(survive, frame.position + wi_world * RAY_OFFSET, origin)
                    new_dir = vwhere(survive, wi_world, direction)

                # --- next-segment traversal, FUSED with this bounce's shadow query;
                # dead lanes carry t_max = 0 -> zero candidates -> (almost) no cost
                next_cap = torch.where(survive, BIG, 0.0)
                num_rays = num_rays + survive.to(torch.float32).sum()
                if shadow is not None:
                    nee_c, shadow_rays, shadow_cap = shadow
                    cat = lambda a, b: torch.cat([a, b])
                    catv = lambda a, b: Vec3(cat(a.x, b.x), cat(a.y, b.y), cat(a.z, b.z))
                    nn = new_origin.x.shape[0]
                    ah_mask = torch.cat([torch.zeros(nn, dtype=torch.bool, device=dev),
                                         torch.ones(shadow_cap.shape[0], dtype=torch.bool, device=dev)])
                    mhits = scene_traverse(scene, catv(new_origin, shadow_rays.origin),
                                           catv(new_dir, shadow_rays.dir), t_max=cat(next_cap, shadow_cap),
                                           time=None if time is None else cat(time, time), any_hit=ah_mask)
                    hits_next = _take(mhits, slice(None, nn))
                    occluded = mhits.t[nn:] < shadow_cap
                    num_overflow = num_overflow + ((shadow_cap > 0.0) & mhits.overflow[nn:]).to(torch.float32).sum()
                    nee_w = ((shadow_cap > 0.0) & (~occluded)).to(torch.float32)
                    result = result + throughput_pre * nee_c * (nee_w * survive_pre.to(torch.float32))
                else:
                    hits_next = scene_traverse(scene, new_origin, new_dir, t_max=next_cap, time=time)

                last_pdf = torch.where(survive, smp.pdf, last_pdf)
                last_specular = torch.where(survive, smp.specular, last_specular)
                origin, direction, hits, alive = new_origin, new_dir, hits_next, survive

        return result, Counters(num_rays, num_shadow, num_overflow, num_box, num_tri)
