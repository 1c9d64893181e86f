"""Triangle shading frames from the per-triangle tables (port of
``raytracer_tpu/ops/bvh_traverse.py::eval_tri_frame``).

Every traversal mode but wave2 returns no interpolated attributes, so
``scene_hit_frame`` gathers the hit triangle's vertex normals, texture
coordinates and material here.  The skip-link BVH walk of the reference
module (the ``bvh`` traversal mode) waits (ROADMAP).
"""

from __future__ import annotations

import torch

from ..math.sampling import build_onb
from ..math.vec import Vec3, normalize
from ..scene.types import Triangles
from .intersect import Hits, PrimFrame


def eval_tri_frame(tris: Triangles, hits: Hits, origin: Vec3, direction: Vec3) -> PrimFrame:
    """Shading frame at a triangle hit: barycentric vertex normal and
    texture coordinates, an orthonormal basis around the normal."""
    idx = torch.clamp_min(hits.tri_id, 0).long()
    u, v = hits.u, hits.v
    w = 1.0 - u - v
    g3 = lambda vec: Vec3(vec.x[idx], vec.y[idx], vec.z[idx])
    n0, n1, n2 = g3(tris.n0), g3(tris.n1), g3(tris.n2)
    normal = normalize(n0 * w + n1 * u + n2 * v, eps=1e-20)
    tangent, bitangent = build_onb(normal)
    return PrimFrame(
        # miss lanes carry t = BIG: clamp so masked lanes stay finite
        position=origin + direction * torch.clamp(hits.t, 0.0, 1e12),
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        tex_u=tris.uv0_u[idx] * w + tris.uv1_u[idx] * u + tris.uv2_u[idx] * v,
        tex_v=tris.uv0_v[idx] * w + tris.uv1_v[idx] * u + tris.uv2_v[idx] * v,
        material_id=tris.material_id[idx],
        light_id=torch.full_like(hits.tri_id, -1),
    )
