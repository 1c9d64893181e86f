"""Per-pixel path debugging (port of ``raytracer_tpu/render/path_debug.py``).

One pixel's path is re-traced on demand as a one-lane wavefront with the
render's own sample stream (samples are pure functions of (pixel, pass,
dim, seed), so the replay is the path the render took), recording each
bounce on the host: ray, hit, shading data, throughput, BSDF event and the
reason the path ended.  The stream is consumed in the integrator's order:
with MIS, the light pick and the 3 NEE dimensions, then Russian roulette,
then the BSDF sample.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..integrators.path_tracer import RAY_OFFSET, RenderParams
from ..math.sampling import local_to_world, world_to_local
from ..math.vec import Vec3, clip, max_component
from ..ops import bsdf as bsdf_ops
from ..ops.bvh_traverse import eval_tri_frame
from ..ops.intersect import BIG, eval_prim_frame, merge_frames
from ..ops.materials import resolve_material
from ..ops.traverse import scene_traverse
from ..sampler.sampler import blue_noise_for_pixels, halton_frame_vector, make_stream, next_1d, next_3d
from ..scene.camera import generate_rays
from ..scene.types import Camera, SceneData, SceneMeta
from .renderer import ViewportParams

# termination reasons
TERM_NONE = "none"
TERM_HIT_BACKGROUND = "hit_background"
TERM_HIT_LIGHT = "hit_light"
TERM_DEPTH_EXCEEDED = "depth_exceeded"
TERM_RUSSIAN_ROULETTE = "russian_roulette"
TERM_THROUGHPUT_ZERO = "throughput_zero"


@dataclass
class PathVertex:
    """One recorded bounce."""

    depth: int
    origin: tuple
    direction: tuple
    hit_distance: float
    prim_id: int
    tri_id: int
    position: tuple
    normal: tuple
    material_id: int
    base_color: tuple
    throughput: tuple
    bsdf_event_specular: bool
    bsdf_pdf: float


@dataclass
class PathDebugData:
    """The recorded path of one pixel."""

    pixel: tuple
    vertices: list = field(default_factory=list)
    termination: str = TERM_NONE
    radiance: tuple = (0.0, 0.0, 0.0)


@torch.no_grad()
def debug_pixel_path(scene: SceneData, meta: SceneMeta, cam: Camera, pixel_x: int, pixel_y: int,
                     vp: ViewportParams, params: RenderParams, pass_idx: int = 0) -> PathDebugData:
    """Replay and record one pixel's path for ``pass_idx``, on the device
    the scene and camera live on."""
    dev = cam.tan_half_fov.device
    pid = torch.tensor([pixel_y * vp.width + pixel_x], dtype=torch.int64, device=dev)
    cx = torch.tensor([(pixel_x + 0.5) / vp.width], dtype=torch.float32, device=dev)
    cy = torch.tensor([1.0 - (pixel_y + 0.5) / vp.height], dtype=torch.float32, device=dev)
    halton = torch.as_tensor(halton_frame_vector(pass_idx), device=dev) if vp.use_low_discrepancy else None
    blue = blue_noise_for_pixels(pid, vp.width) if halton is not None and vp.use_blue_noise else None
    stream = make_stream(pid, pass_idx, seed=vp.seed, halton=halton, blue=blue)
    rays, stream = generate_rays(cam, cx, cy, stream)

    data = PathDebugData(pixel=(pixel_x, pixel_y))
    origin, direction = rays.origin, rays.dir
    throughput = Vec3.ones((1,), dev)

    def v3(v: Vec3) -> tuple:
        return tuple(float(c[0]) for c in v)

    for depth in range(params.max_depth + 1):
        hits = scene_traverse(scene, origin, direction)
        if float(hits.t[0]) >= BIG * 0.5:
            data.termination = TERM_HIT_BACKGROUND
            break
        frame = eval_prim_frame(scene.prims, hits.prim_id, origin, direction, hits.t)
        if scene.tris is not None:
            tri_frame = eval_tri_frame(scene.tris, hits, origin, direction)
            frame = merge_frames(hits.tri_id >= 0, tri_frame, frame)
        mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v, position=frame.position)

        if int(frame.light_id[0]) >= 0:
            data.vertices.append(PathVertex(
                depth=depth, origin=v3(origin), direction=v3(direction),
                hit_distance=float(hits.t[0]), prim_id=int(hits.prim_id[0]),
                tri_id=int(hits.tri_id[0]), position=v3(frame.position),
                normal=v3(frame.normal), material_id=-1,
                base_color=(0, 0, 0), throughput=v3(throughput),
                bsdf_event_specular=False, bsdf_pdf=0.0,
            ))
            data.termination = TERM_HIT_LIGHT
            break

        wo_local = world_to_local(-direction, frame.tangent, frame.bitangent, frame.normal)
        # the integrator's stream order: NEE (pick + 3), RR, then the BSDF sample
        if params.mis:
            _, stream = next_1d(stream)
            _, _, _, stream = next_3d(stream)
        if depth >= params.max_depth:
            data.termination = TERM_DEPTH_EXCEEDED
            break
        u_rr, stream = next_1d(stream)
        threshold = 0.125 + 0.875 * float(clip(max_component(mp.base_color), 0.0, 1.0)[0])
        if depth >= params.min_rr_depth and float(u_rr[0]) > threshold:
            data.termination = TERM_RUSSIAN_ROULETTE
            break
        u1, u2, u3, stream = next_3d(stream)
        smp = bsdf_ops.sample(mp, wo_local, u1, u2, u3)
        wi_world = local_to_world(smp.wi, frame.tangent, frame.bitangent, frame.normal)

        data.vertices.append(PathVertex(
            depth=depth, origin=v3(origin), direction=v3(direction),
            hit_distance=float(hits.t[0]), prim_id=int(hits.prim_id[0]),
            tri_id=int(hits.tri_id[0]), position=v3(frame.position),
            normal=v3(frame.normal), material_id=int(frame.material_id[0]),
            base_color=v3(mp.base_color), throughput=v3(throughput),
            bsdf_event_specular=bool(smp.specular[0]), bsdf_pdf=float(smp.pdf[0]),
        ))

        throughput = throughput * smp.weight
        if float(max_component(throughput)[0]) <= 1e-7 or not bool(smp.valid[0]):
            data.termination = TERM_THROUGHPUT_ZERO
            break
        origin = frame.position + wi_world * RAY_OFFSET
        direction = wi_world

    return data
