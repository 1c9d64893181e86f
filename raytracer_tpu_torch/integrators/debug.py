"""Debug renderer: AOV visualization (port of
``raytracer_tpu/integrators/debug.py``).

One traversal and one shading-frame evaluation per pixel; the mode picks
which quantity becomes the pixel colour: headlight shading, hit id, depth,
position, normals / tangents / bitangents, texcoords, the resolved material
parameters, or the traversal work (box and triangle tests) per ray.
The material modes show the table's parameters without decals, as in the
reference.
"""

from __future__ import annotations

import math

import torch

from ..math.vec import Vec3, dot, where as vwhere
from ..ops.intersect import BIG
from ..ops.materials import apply_normal_map, resolve_material
from ..ops.traverse import scene_hit_frame, scene_traversal_cost, scene_traverse
from ..sampler.sampler import hash_u32, u32_to_unit_float
from ..scene.camera import Rays
from ..scene.types import SceneData, SceneMeta

MODE_CAMERA_LIGHT = "CameraLight"
MODE_TRIANGLE_ID = "TriangleID"
MODE_DEPTH = "Depth"
MODE_POSITION = "Position"
MODE_NORMALS = "Normals"
MODE_TANGENTS = "Tangents"
MODE_BITANGENTS = "Bitangents"
MODE_TEXCOORDS = "TexCoords"
MODE_BASE_COLOR = "BaseColor"
MODE_EMISSION = "Emission"
MODE_ROUGHNESS = "Roughness"
MODE_METALNESS = "Metalness"
MODE_IOR = "IoR"
# traversal-work heatmap (box and triangle tests a ray)
MODE_TRAVERSAL_COST = "TraversalCost"

ALL_MODES = (
    MODE_CAMERA_LIGHT, MODE_TRIANGLE_ID, MODE_DEPTH, MODE_POSITION,
    MODE_NORMALS, MODE_TANGENTS, MODE_BITANGENTS, MODE_TEXCOORDS,
    MODE_BASE_COLOR, MODE_EMISSION, MODE_ROUGHNESS, MODE_METALNESS, MODE_IOR,
    MODE_TRAVERSAL_COST,
)


def _dir_color(v: Vec3) -> Vec3:
    """[-1,1] direction -> [0,1] colour (the normal-map convention)."""
    return Vec3(0.5 * (v.x + 1.0), 0.5 * (v.y + 1.0), 0.5 * (v.z + 1.0))


def _id_color(ids: torch.Tensor) -> Vec3:
    h = hash_u32(ids)
    return Vec3(u32_to_unit_float(h), u32_to_unit_float(hash_u32(h)), u32_to_unit_float(hash_u32(h ^ 0xA511E9B3)))


@torch.no_grad()
def render_debug(scene: SceneData, meta: SceneMeta, rays: Rays, mode: str = MODE_CAMERA_LIGHT) -> Vec3:
    """Single-bounce AOV evaluation over the wavefront."""
    hits = scene_traverse(scene, rays.origin, rays.dir)
    miss = hits.t >= BIG * 0.5
    hits_safe = hits._replace(t=torch.clamp(hits.t, 0.0, 1e12))
    frame = apply_normal_map(scene, scene_hit_frame(scene, hits_safe, rays.origin, rays.dir))
    mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v)

    if mode == MODE_CAMERA_LIGHT:
        # headlight shading
        out = mp.base_color * torch.abs(dot(frame.normal, -rays.dir))
    elif mode == MODE_TRAVERSAL_COST:
        # green -> red by the tests a ray costs, log-scaled
        box_t, tri_t = scene_traversal_cost(scene, rays.origin, rays.dir)
        heat = torch.clamp(torch.log1p(box_t + tri_t) / math.log(50000.0), 0.0, 1.0)
        out = Vec3(heat, 1.0 - heat, torch.zeros_like(heat))
    elif mode == MODE_TRIANGLE_ID:
        out = _id_color(torch.where(hits.tri_id >= 0, hits.tri_id, hits.prim_id + 0x40000000))
    elif mode == MODE_DEPTH:
        out = Vec3.full(torch.log1p(hits_safe.t) / 8.0)  # log-scaled
    elif mode == MODE_POSITION:
        out = Vec3(*(torch.remainder(c, 1.0) for c in frame.position))
    elif mode == MODE_NORMALS:
        out = _dir_color(frame.normal)
    elif mode == MODE_TANGENTS:
        out = _dir_color(frame.tangent)
    elif mode == MODE_BITANGENTS:
        out = _dir_color(frame.bitangent)
    elif mode == MODE_TEXCOORDS:
        out = Vec3(torch.remainder(frame.tex_u, 1.0), torch.remainder(frame.tex_v, 1.0), torch.zeros_like(frame.tex_u))
    elif mode == MODE_BASE_COLOR:
        out = mp.base_color
    elif mode == MODE_EMISSION:
        out = mp.emission
    elif mode == MODE_ROUGHNESS:
        out = Vec3.full(mp.roughness)
    elif mode == MODE_METALNESS:
        out = Vec3.full(mp.metalness)
    elif mode == MODE_IOR:
        out = Vec3.full(mp.ior / 3.0)
    else:
        raise ValueError(f"unknown debug mode '{mode}' (available: {', '.join(ALL_MODES)})")
    return vwhere(miss, Vec3.zeros(miss.shape, miss.device), out)
