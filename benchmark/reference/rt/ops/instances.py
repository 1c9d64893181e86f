"""Two-level traversal for the reference: a scene's instances traced one at
a time, each in its own object space.

``ops/traverse.py`` traces prims and the baked mesh; these functions add the
instances with the program's semantics (``raytracer_tpu_torch/ops/
traverse.py``), each by a plain loop over the instance table in id order:

- the ray moved into the instance's object space by the same float
  operations as the program: the translation at the ray's shutter time
  (``trans + vel * time``) taken off the origin, then the inverse rotation;
- traced through the shared mesh by this reference's own exact intersection
  (``ops/traverse.py::mesh_closest``), a closest-hit lane capped by the best
  t so far (the prims', the baked mesh's and the instances' before it), an
  any-hit lane by the least of that and its ``t_max``, so that a shadow ray
  never meets an instance beyond its light;
- a hit replaces the best where it is strictly nearer, so a tie keeps the
  baked mesh, the prim or the lower instance id.

An instanced hit's frame is the interpolated object-space normal turned to
world, then normalized, as the program's attribute path gives it.
``instanced()`` puts these functions in the path tracer's place while it is
in force.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from ..integrators import path_tracer
from ..math.sampling import build_onb
from ..math.vec import Vec3, normalize
from ..scene.types import Rot3
from . import traverse
from .intersect import BIG, Hits, PrimFrame, merge_frames

_REPLACED = ("scene_traverse", "scene_hit_frame", "scene_occluded")


def _pose(scene, i: int):
    """Instance i's rotation (object -> world rows) and translation."""
    inst = scene.instances
    at = lambda v: Vec3(v.x[i], v.y[i], v.z[i])
    return Rot3(at(inst.rot.r0), at(inst.rot.r1), at(inst.rot.r2)), at(inst.trans), at(inst.vel)


def local_ray(scene, i: int, origin: Vec3, direction: Vec3, time=None):
    """A world ray in instance i's object space at each ray's shutter
    ``time`` (None = static)."""
    rot, trans, vel = _pose(scene, i)
    if time is not None:
        trans = trans + vel * time
    return rot.to_local(origin - trans), rot.to_local(direction)


def scene_traverse(scene, origin: Vec3, direction: Vec3, t_max=None, time=None, any_hit=None) -> Hits:
    hits = traverse.scene_traverse(scene, origin, direction, t_max, time, any_hit)
    if scene.instances is None:
        return hits
    n = origin.x.shape
    dev = origin.x.device
    if t_max is None:
        t_max = torch.full(n, BIG, dtype=torch.float32, device=dev)
    ah = any_hit if any_hit is not None else torch.zeros(n, dtype=torch.bool, device=dev)
    t, pid, tri, u, v, inst_id = hits.t, hits.prim_id, hits.tri_id, hits.u, hits.v, hits.inst_id
    for i, m in enumerate(scene.instances.mesh_ids):
        o_l, d_l = local_ray(scene, i, origin, direction, time)
        cap = torch.where(ah, torch.minimum(t, t_max), t)
        t_i, id_i, u_i, v_i = traverse.mesh_closest(scene.mesh_geoms[m].clusters, o_l, d_l, cap, any_hit)
        closer = (id_i >= 0) & (t_i < t)
        t = torch.where(closer, t_i, t)
        pid = torch.where(closer, -1, pid)
        tri = torch.where(closer, id_i.to(torch.int32), tri)
        u = torch.where(closer, u_i, u)
        v = torch.where(closer, v_i, v)
        inst_id = torch.where(closer, i, inst_id)
    return hits._replace(t=t, prim_id=pid, tri_id=tri, u=u, v=v, inst_id=inst_id)


def _instanced_frame(tris, rot: Rot3, hits: Hits, origin: Vec3, direction: Vec3) -> PrimFrame:
    """Frame at hits on one instance: the object-space vertex normal
    interpolated, turned to world and normalized; texture coordinates and
    material from the shared mesh's table."""
    idx = torch.clamp_min(hits.tri_id, 0).long()
    u, v = hits.u, hits.v
    w = 1.0 - u - v
    g3 = lambda vec: Vec3(vec.x[idx], vec.y[idx], vec.z[idx])
    n0, n1, n2 = g3(tris.n0), g3(tris.n1), g3(tris.n2)
    normal = normalize(rot.to_world(n0 * w + n1 * u + n2 * v), eps=1e-20)
    tangent, bitangent = build_onb(normal)
    return PrimFrame(
        position=origin + direction * torch.clamp(hits.t, 0.0, 1e12),
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        tex_u=tris.uv0_u[idx] * w + tris.uv1_u[idx] * u + tris.uv2_u[idx] * v,
        tex_v=tris.uv0_v[idx] * w + tris.uv1_v[idx] * u + tris.uv2_v[idx] * v,
        material_id=tris.material_id[idx],
        light_id=torch.full_like(hits.tri_id, -1),
    )


def scene_hit_frame(scene, hits: Hits, origin: Vec3, direction: Vec3, time=None) -> PrimFrame:
    if scene.instances is None:
        return traverse.scene_hit_frame(scene, hits, origin, direction, time)
    inst = hits.inst_id
    baked = hits._replace(tri_id=torch.where(inst < 0, hits.tri_id, -1))
    frame = traverse.scene_hit_frame(scene, baked, origin, direction, time)
    for i, m in enumerate(scene.instances.mesh_ids):
        mask = (hits.tri_id >= 0) & (inst == i)
        rot = _pose(scene, i)[0]
        own = hits._replace(tri_id=torch.where(mask, hits.tri_id, -1))
        frame = merge_frames(mask, _instanced_frame(scene.mesh_geoms[m].tris, rot, own, origin, direction), frame)
    return frame


def scene_occluded(scene, origin: Vec3, direction: Vec3, t_max, time=None):
    t_max = t_max * torch.ones_like(origin.x)
    hits = scene_traverse(scene, origin, direction, t_max, time, any_hit=torch.ones_like(origin.x, dtype=torch.bool))
    return hits.t < t_max, hits.overflow


@contextmanager
def instanced():
    """The path tracer traces instances through this module while in force."""
    saved = {name: getattr(path_tracer, name) for name in _REPLACED}
    try:
        for name in _REPLACED:
            setattr(path_tracer, name, globals()[name])
        yield
    finally:
        for name, fn in saved.items():
            setattr(path_tracer, name, fn)
