"""Wavefront light tracer: reverse path tracing with camera splats (port of
``raytracer_tpu/integrators/light_tracer.py``).

Light paths are emitted from randomly picked lights (``emit``), walked
through the scene, and at every surface vertex connected to the camera: BSDF
toward the camera x visibility x the camera's importance
``camera_pdf_w(-dir_to_camera) / d^2``, splatted onto the film at
``world_to_film(position)``.

One pass traces W*H light paths, so the film's ``sum / passes``
normalization is the path tracer's.  The bounce loop is a python loop whose
per-depth splats are stacked and scatter-added into the film in one shot.
Its shading passes no position to ``resolve_material``, so decals do not
apply, as in the reference (the path tracer and VCM apply them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math.sampling import local_to_world, world_to_local
from ..math.vec import Vec3, dot, max_component, sqrt_rn, where as vwhere
from ..ops import bsdf as bsdf_ops
from ..ops.intersect import BIG
from ..ops.lights import emit, gather_light
from ..ops.materials import apply_normal_map, resolve_material
from ..ops.traverse import scene_hit_frame, scene_occluded, scene_traverse
from ..render.film import splat as film_splat
from ..sampler.sampler import SampleStream, make_stream, next_1d, next_2d, next_3d
from ..scene.camera import camera_pdf_w, world_to_film
from ..scene.types import Camera, SceneData, SceneMeta
from .path_tracer import RAY_OFFSET, SHADOW_OFFSET, Counters, RenderParams

EMIT_OFFSET = 5e-4  # emitted rays start this far off the light


class SplatBatch(NamedTuple):
    """Camera-connection splats, (D, N) once stacked over the depths."""

    u: torch.Tensor  # film coords in [0,1)
    v: torch.Tensor
    color: Vec3
    mask: torch.Tensor


def stack_splats(splats) -> SplatBatch:
    """The per-depth splat batches stacked into one (D, N) batch."""
    st = lambda xs: torch.stack(list(xs))
    return SplatBatch(u=st(s.u for s in splats), v=st(s.v for s in splats),
                      color=Vec3(*(st(s.color[i] for s in splats) for i in range(3))),
                      mask=st(s.mask for s in splats))


def emit_paths(scene: SceneData, meta: SceneMeta, stream: SampleStream):
    """Pick a light per path uniformly and emit from it: (the light's row,
    the emission, the pick probability, stream)."""
    n_lights = max(meta.n_lights, 1)
    u_pick, stream = next_1d(stream)
    light_idx = torch.clamp((u_pick * n_lights).to(torch.int32), 0, n_lights - 1)
    l = gather_light(scene.lights, light_idx)
    u1, u2, stream = next_2d(stream)
    u3, u4, u5, stream = next_3d(stream)
    return l, emit(l, u1, u2, u3, u4, u5, scene_radius=meta.scene_radius), 1.0 / n_lights, stream


def trace_light_wavefront(scene: SceneData, meta: SceneMeta, cam: Camera, stream: SampleStream,
                          params: RenderParams, n_paths: int):
    """Trace ``n_paths`` light paths; returns the stacked splats (D, N) and
    the counters (rays traced; no shadow-ray count, as in the reference)."""
    dev = stream.pixel_hash.device
    _, em, pick_prob, stream = emit_paths(scene, meta, stream)
    emission_pdf = em.emission_pdf_w * pick_prob
    throughput = em.radiance * (1.0 / emission_pdf)
    alive = max_component(throughput) > 1e-9
    if meta.n_lights == 0:
        alive = torch.zeros_like(alive)

    origin = em.position + em.direction * EMIT_OFFSET
    direction = em.direction
    num_rays = torch.zeros((), dtype=torch.float32, device=dev)
    splats = []
    for depth in range(params.max_depth + 1):
        num_rays = num_rays + alive.to(torch.float32).sum()
        hits = scene_traverse(scene, origin, direction)
        miss = hits.t >= BIG * 0.5
        hits = hits._replace(t=torch.clamp(hits.t, 0.0, 1e12))
        frame = apply_normal_map(scene, scene_hit_frame(scene, hits, origin, direction))

        # stop on a miss or on hitting a light
        hit_surface = alive & (~miss) & (frame.light_id < 0)
        mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v)
        wo_local = world_to_local(-direction, frame.tangent, frame.bitangent, frame.normal)

        # camera connection
        to_cam = cam.origin - frame.position
        d2 = dot(to_cam, to_cam)
        dist = sqrt_rn(torch.clamp_min(d2, 1e-12))
        dir_to_cam = to_cam * (1.0 / dist)
        wi_local = world_to_local(dir_to_cam, frame.tangent, frame.bitangent, frame.normal)
        f_cam, _pdf = bsdf_ops.evaluate(mp, wo_local, wi_local)
        fu, fv, on_film = world_to_film(cam, frame.position)
        shadow_origin = frame.position + frame.normal * SHADOW_OFFSET
        # lanes that cannot splat query with limit 0 (free in every engine):
        # the lanes that splat get the reference's answers
        wanted = hit_surface & on_film & (max_component(f_cam) > 0.0)
        visible = ~scene_occluded(scene, shadow_origin, dir_to_cam, torch.where(wanted, dist * 0.999, 0.0))[0]
        cam_pdf_a = camera_pdf_w(cam, -dir_to_cam) / torch.clamp_min(d2, 1e-12)
        contrib = f_cam * throughput * cam_pdf_a
        splats.append(SplatBatch(u=fu, v=fv, color=contrib, mask=wanted & visible))

        # BSDF sampling continues the walk
        s1, s2, s3, stream = next_3d(stream)
        smp = bsdf_ops.sample(mp, wo_local, s1, s2, s3)
        wi_world = local_to_world(smp.wi, frame.tangent, frame.bitangent, frame.normal)
        survive = hit_surface & smp.valid & (depth < params.max_depth)
        new_throughput = throughput * smp.weight
        survive = survive & (max_component(new_throughput) > 1e-9)

        origin = vwhere(survive, frame.position + wi_world * RAY_OFFSET, origin)
        direction = vwhere(survive, wi_world, direction)
        throughput = vwhere(survive, new_throughput, throughput)
        alive = survive
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return stack_splats(splats), Counters(num_rays, zero)


def splat_to_film(film, splats: SplatBatch, width: int, height: int):
    """Scatter-add stacked splats into the film sum, each at the pixel its
    film coords fall in."""
    u = splats.u.reshape(-1)
    v = splats.v.reshape(-1)
    color = Vec3(splats.color.x.reshape(-1), splats.color.y.reshape(-1), splats.color.z.reshape(-1))
    mask = splats.mask.reshape(-1)
    px = torch.floor(u * width).to(torch.int32)
    # film v is up; image row 0 is the top
    py = torch.floor((1.0 - v) * height).to(torch.int32)
    return film_splat(film, px, py, color, mask)


@torch.no_grad()
def render_pass_light_tracer(scene: SceneData, meta: SceneMeta, cam: Camera, film, pass_idx: int, halton, vp,
                             params: RenderParams):
    """One light-tracing accumulation pass over W*H light paths, on its own
    sample streams (seed ``vp.seed + 0x517``).  Returns (film, counters)."""
    n_paths = vp.width * vp.height
    path_ids = torch.arange(n_paths, dtype=torch.int64, device=film.sum.device)
    stream = make_stream(path_ids, pass_idx, seed=vp.seed + 0x517, halton=halton)
    splats, counters = trace_light_wavefront(scene, meta, cam, stream, params, n_paths)
    film = splat_to_film(film, splats, vp.width, vp.height)
    return film._replace(num_passes=film.num_passes + 1), counters
