"""Unified scene traversal: analytic prims + the triangle mesh (port of
``raytracer_tpu/ops/traverse.py``).

Closest hit across all geometry kinds, and an any-hit occlusion query for
shadow rays.  The mesh goes to the backend that ``set_traversal_mode`` or
the ``RT_TRAVERSAL_MODE`` environment variable selects:

- ``"wave2"``: the sort-join engine (``ops/wave2_traverse.py``), exact, with
  per-lane any-hit early exit and interpolated shading attributes.  What
  ``"auto"`` (the default) resolves to.
- ``"sorted-pallas"``: octant + Morton ray sort, per-1024-ray-block BFS
  candidates, the stream kernel (``ops/pallas_traverse.py``).  Its per-block
  candidate union truncates on incoherent wavefronts: rays it may have cut
  short are reported as overflow, never silently trusted.
- ``"cluster"``: the per-ray dense two-phase path
  (``ops/cluster_traverse.py``), a second orthogonal implementation for
  validation.
- ``"null"``: diagnostics only, skips mesh traversal.
- ``"wave"`` and ``"bvh"`` are valid names of the reference whose engines
  are not ported yet; selecting one raises, since a chosen mode never
  silently becomes another.

Every mode but wave2 runs closest hit on ``|t_cap|`` (same answer, no
early exit) and returns no attributes, so the shading frame is gathered
from the triangle tables.  Two-level instancing waits (ROADMAP).
"""

from __future__ import annotations

import os

import torch

from ..math.sampling import build_onb
from ..math.vec import Vec3, normalize
from ..scene.types import SceneData
from .bvh_traverse import eval_tri_frame
from .cluster_traverse import cluster_any_hit, cluster_closest_hit
from .intersect import BIG, Hits, PrimFrame, eval_prim_frame, intersect_prims, merge_frames
from .pallas_traverse import pallas_sorted_any_hit, pallas_sorted_closest_hit
from .wave2_traverse import wave2_any_hit, wave2_closest_hit

_MODE = "auto"
_VALID_MODES = ("auto", "wave2", "wave", "sorted-pallas", "cluster", "bvh", "null")
_NOT_PORTED = ("wave", "bvh")


def set_traversal_mode(mode: str) -> None:
    """Select the mesh traversal backend (see the module docstring)."""
    global _MODE
    if mode not in _VALID_MODES:
        raise ValueError(f"traversal mode {mode!r} not in {_VALID_MODES}")
    _MODE = mode


def get_traversal_mode() -> str:
    return _MODE


def _resolved_mode() -> str:
    """The mode in force: the environment override goes through the same
    validation as ``set_traversal_mode``, so a typo raises."""
    mode = _MODE
    env = os.environ.get("RT_TRAVERSAL_MODE")
    if env:
        if env not in _VALID_MODES:
            raise ValueError(f"RT_TRAVERSAL_MODE={env!r} not in {_VALID_MODES}")
        mode = env
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"traversal mode {mode!r} is not ported yet (ROADMAP queue 0); "
            "use 'wave2', 'sorted-pallas' or 'cluster'"
        )
    return "wave2" if mode == "auto" else mode


def _cs_closest(mode, clusters, origin: Vec3, direction: Vec3, t_cap):
    """Closest hit over ONE cluster set by the selected backend.  ``t_cap``
    may be sign-encoded per ray (negative = any-hit lane with limit
    |t_cap|): wave2 honours the early exit per lane, the others trace
    |t_cap|.  Returns (t, tri_id, u, v, overflow, attr or None)."""
    if mode == "wave2":
        return wave2_closest_hit(clusters, origin, direction, t_cap, with_attrs=True)
    t_cap = torch.abs(t_cap)
    if mode == "null":
        z = torch.zeros_like(origin.x)
        return (torch.full_like(z, BIG), torch.full_like(z, -1, dtype=torch.int32), z, z,
                torch.zeros_like(z, dtype=torch.bool), None)
    if mode == "sorted-pallas":
        return pallas_sorted_closest_hit(clusters, origin, direction, t_cap) + (None,)
    return cluster_closest_hit(clusters, origin, direction, t_cap) + (None,)


def _cs_occluded(mode, clusters, origin: Vec3, direction: Vec3, t_max):
    """Any-hit over ONE cluster set. Returns (occluded, overflow)."""
    if mode == "wave2":
        return wave2_any_hit(clusters, origin, direction, t_max)
    if mode == "null":
        z = torch.zeros_like(origin.x, dtype=torch.bool)
        return z, z
    if mode == "sorted-pallas":
        return pallas_sorted_any_hit(clusters, origin, direction, t_max)
    return cluster_any_hit(clusters, origin, direction, t_max)


def scene_traverse(scene: SceneData, origin: Vec3, direction: Vec3, t_max=None, any_hit=None) -> Hits:
    """Closest hit.  ``any_hit`` (N,) bool, optional: lanes that only need
    an occlusion answer (shadow rays in a fused wavefront) — under wave2
    their mesh query keeps any-hit early exit (t collapses to 0 on the
    first hit)."""
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
        t_t, tid, tu, tv, ovf, attr_t = _cs_closest(_resolved_mode(), scene.clusters, origin, direction, cap)
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
    come from the traversal's interpolated ``tri_attr`` channels when the
    backend emitted them (wave2), else from a gather of the triangle tables."""
    frame = eval_prim_frame(scene.prims, hits.prim_id, origin, direction, hits.t)
    if hits.attr is None:
        if scene.tris is None:
            return frame
        return merge_frames(hits.tri_id >= 0, eval_tri_frame(scene.tris, hits, origin, direction), frame)
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
    """Any-hit shadow query.  Returns (occluded, overflow): ``overflow``
    marks shadow rays whose mesh query the backend may have truncated."""
    n = origin.x.shape
    t_p, _ = intersect_prims(scene.prims, origin, direction, t_max)
    occ = t_p < t_max
    overflow = torch.zeros(n, dtype=torch.bool, device=origin.x.device)
    if scene.tris is not None and scene.clusters is not None:
        mesh_occ, ovf = _cs_occluded(_resolved_mode(), scene.clusters, origin, direction, t_max)
        occ = occ | mesh_occ
        overflow = overflow | ovf
    return occ, overflow
