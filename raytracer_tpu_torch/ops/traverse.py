"""Unified scene traversal: analytic prims + the triangle mesh (port of
``raytracer_tpu/ops/traverse.py``).

Closest hit across all geometry kinds, and an any-hit occlusion query for
shadow rays.  The mesh always goes through the wave2 engine in the port;
the reference's other backends (``bvh``, ``wave``, ``cluster``,
``sorted-pallas``) and two-level instancing wait (ROADMAP).
"""

from __future__ import annotations

import torch

from ..math.sampling import build_onb
from ..math.vec import Vec3, normalize
from ..scene.types import SceneData
from .intersect import BIG, Hits, PrimFrame, eval_prim_frame, intersect_prims, merge_frames
from .wave2_traverse import wave2_any_hit, wave2_closest_hit


def scene_traverse(scene: SceneData, origin: Vec3, direction: Vec3, t_max=None, any_hit=None) -> Hits:
    """Closest hit.  ``any_hit`` (N,) bool, optional: lanes that only need
    an occlusion answer (shadow rays in a fused wavefront) — their mesh
    query keeps any-hit early exit (t collapses to 0 on the first hit)."""
    n = origin.x.shape
    dev = origin.x.device
    if t_max is None:
        t_max = torch.full(n, BIG, dtype=torch.float32, device=dev)
    best_t, best_prim = intersect_prims(scene.prims, origin, direction, t_max)
    best_tri = torch.full(n, -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    attr = None

    if scene.tris is not None and scene.clusters is not None:
        cap = torch.minimum(best_t, t_max)
        if any_hit is not None:
            cap = torch.where(any_hit, -cap, cap)
        t_t, tid, tu, tv, ovf, attr_t = wave2_closest_hit(scene.clusters, origin, direction, cap,
                                                          with_attrs=True)
        overflow = overflow | ovf
        closer = (t_t < best_t) & (tid >= 0)
        best_t = torch.where(closer, t_t, best_t)
        best_prim = torch.where(closer, -1, best_prim)
        best_tri = torch.where(closer, tid, best_tri)
        best_u = torch.where(closer, tu, best_u)
        best_v = torch.where(closer, tv, best_v)
        if attr_t is not None:
            z = torch.zeros_like(best_u)
            attr = tuple(torch.where(closer, a, z) for a in attr_t)

    return Hits(t=best_t, prim_id=best_prim, tri_id=best_tri, u=best_u, v=best_v,
                overflow=overflow, attr=attr)


def scene_hit_frame(scene: SceneData, hits: Hits, origin: Vec3, direction: Vec3) -> PrimFrame:
    """Shading frame for an analytic-prim or triangle hit.  Triangle frames
    come from the traversal's interpolated ``tri_attr`` channels."""
    frame = eval_prim_frame(scene.prims, hits.prim_id, origin, direction, hits.t)
    if hits.attr is None:  # no mesh
        return frame
    nx, ny, nz, tu, tv, matf = hits.attr
    normal = normalize(Vec3(nx, ny, nz), eps=1e-20)
    tangent, bitangent = build_onb(normal)
    tri_frame = PrimFrame(
        position=origin + direction * torch.clamp(hits.t, 0.0, 1e12),
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        tex_u=tu,
        tex_v=tv,
        material_id=matf.to(torch.int32),
        light_id=torch.full_like(hits.tri_id, -1),
    )
    return merge_frames(hits.tri_id >= 0, tri_frame, frame)


def scene_occluded(scene: SceneData, origin: Vec3, direction: Vec3, t_max):
    """Any-hit shadow query.  Returns (occluded, overflow)."""
    n = origin.x.shape
    t_p, _ = intersect_prims(scene.prims, origin, direction, t_max)
    occ = t_p < t_max
    overflow = torch.zeros(n, dtype=torch.bool, device=origin.x.device)
    if scene.tris is not None and scene.clusters is not None:
        mesh_occ, ovf = wave2_any_hit(scene.clusters, origin, direction, t_max)
        occ = occ | mesh_occ
        overflow = overflow | ovf
    return occ, overflow
