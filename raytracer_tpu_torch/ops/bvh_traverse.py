"""Skip-link BVH walk and triangle shading frames (port of
``raytracer_tpu/ops/bvh_traverse.py``).

The tree is pre-threaded per ray-direction octant with ``hit``/``miss``
skip links (``scene/bvh.py``), so a ray's walk state is ONE int32: the
current node.  A step reads the node's packed row, slab-tests its box
against the ray's running best t, runs Möller-Trumbore on the leaf's 4
slots in order when the box is hit at a leaf, and follows the hit or the
miss link.  Closest hit keeps a strict ``t < best``; any-hit stops at the
first hit below the limit.  A ray takes at most
``ceil(min(M, MAX_TRAVERSAL_STEPS) / WALK_CHUNK) * WALK_CHUNK`` steps and
then returns what it has found so far, as the reference's chunked loop
gives it.

``bvh_walk`` is the wrapper: a CPU tensor takes the plain twin
(``bvh_walk_reference``, the reference's lock-step walk in PyTorch, in
chunks of ``WALK_CHUNK`` steps with one ``any(node >= 0)`` per chunk); a
CUDA tensor launches ``csrc/bvh_walk.cu``, one thread a ray, or raises.
Kernel and twin agree bit for bit.  The walk is detached from autograd, as
in the reference.

``eval_tri_frame`` gathers the hit triangle's vertex normals, texture
coordinates and material, for every traversal mode that returns no
interpolated attributes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math.sampling import build_onb
from ..math.vec import Vec3, cross, dot, normalize
from ..scene.bvh import LEAF_SIZE
from ..scene.types import BVHFlat, Triangles
from .cuda_build import launch
from .intersect import BIG, Hits, PrimFrame

TRI_EPS = 1e-7
HIT_EPS = 1e-4
# hard cap on walk steps; a scene's budget is min(num_nodes, cap) rounded up
# to whole chunks
MAX_TRAVERSAL_STEPS = 8192
# walk steps between two checks whether any ray is still walking
WALK_CHUNK = 16


def walk_budget(num_nodes: int) -> int:
    """The most steps a ray takes: the reference's chunks times their size."""
    return -(-min(num_nodes, MAX_TRAVERSAL_STEPS) // WALK_CHUNK) * WALK_CHUNK


def _octant(direction: Vec3) -> torch.Tensor:
    """Per-ray octant id from direction sign bits (x | y<<1 | z<<2)."""
    return ((direction.x < 0).to(torch.int32) + 2 * (direction.y < 0).to(torch.int32)
            + 4 * (direction.z < 0).to(torch.int32))


def _safe_inv(d: Vec3) -> Vec3:
    tiny = 1e-20
    inv = lambda c: 1.0 / torch.where(torch.abs(c) > tiny, c, torch.where(c >= 0, tiny, -tiny))
    return Vec3(inv(d.x), inv(d.y), inv(d.z))


def _slab_test(node_row, origin: Vec3, inv_dir: Vec3, t_max):
    """Ray-AABB slab test against (N, >= 6) rows [min.xyz, max.xyz, ...]."""
    t1x = (node_row[:, 0] - origin.x) * inv_dir.x
    t2x = (node_row[:, 3] - origin.x) * inv_dir.x
    t1y = (node_row[:, 1] - origin.y) * inv_dir.y
    t2y = (node_row[:, 4] - origin.y) * inv_dir.y
    t1z = (node_row[:, 2] - origin.z) * inv_dir.z
    t2z = (node_row[:, 5] - origin.z) * inv_dir.z
    tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                         torch.maximum(t1z, t2z))
    return (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin < t_max)


def _moller_trumbore(geom_row, origin: Vec3, direction: Vec3):
    """Möller-Trumbore over (N, 9) v0/e1/e2 rows; all-zero padding rows give
    det == 0, a miss.  Returns (t, u, v, hit)."""
    v0 = Vec3(geom_row[:, 0], geom_row[:, 1], geom_row[:, 2])
    e1 = Vec3(geom_row[:, 3], geom_row[:, 4], geom_row[:, 5])
    e2 = Vec3(geom_row[:, 6], geom_row[:, 7], geom_row[:, 8])
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > TRI_EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > HIT_EPS)
    return t, u, v, hit


class WalkResult(NamedTuple):
    """What a walk returns: closest hit fills (t, tri, u, v) with t = BIG on
    a miss, any-hit fills ``occluded``.  With ``count_steps``: ``steps`` (N,)
    int32, and from the twin also its work: ``leaf_visits`` (N,) int32,
    steps that hit a leaf's box and tested its 4 slots, and ``nodes_read``
    (8M,) / ``leaves_read`` (L,) bool, the distinct table rows the walk read."""

    t: torch.Tensor = None
    tri: torch.Tensor = None
    u: torch.Tensor = None
    v: torch.Tensor = None
    occluded: torch.Tensor = None
    steps: torch.Tensor = None
    leaf_visits: torch.Tensor = None
    nodes_read: torch.Tensor = None
    leaves_read: torch.Tensor = None


@torch.no_grad()
def bvh_walk_reference(bvh: BVHFlat, origin: Vec3, direction: Vec3, t_max, any_hit: bool,
                       count_steps: bool = False) -> WalkResult:
    """The plain twin: every ray steps in lock-step, finished rays park on
    node -1.  ``count_steps`` adds the walk's work to the result."""
    n = origin.x.shape[0]
    dev = origin.x.device
    m = bvh.num_nodes
    oct_base = _octant(direction).to(torch.int64) * m
    inv_dir = _safe_inv(direction)
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    t = t_max.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_visits = torch.zeros(n, dtype=torch.int32, device=dev)
    nodes_read = torch.zeros(bvh.packed_nodes.shape[0], dtype=torch.bool, device=dev)
    leaves_read = torch.zeros(bvh.leaf_geom.shape[0], dtype=torch.bool, device=dev)
    for _ in range(walk_budget(m) // WALK_CHUNK):
        if not bool((node >= 0).any()):  # one host sync per chunk
            break
        for _ in range(WALK_CHUNK):
            active = node >= 0
            row_id = oct_base + torch.clamp_min(node, 0)
            row = bvh.packed_nodes[row_id]  # (N, 9)
            links = row[:, 6:9].contiguous().view(torch.int32)  # leaf row, hit, miss
            hit_box = active & _slab_test(row, origin, inv_dir, t)
            do_tris = hit_box & (links[:, 0] >= 0)
            leaf = bvh.leaf_geom[torch.clamp_min(links[:, 0], 0)]  # (N, 40)
            ids = leaf[:, 36:40].contiguous().view(torch.int32)
            for j in range(LEAF_SIZE):
                tt, uu, vv, th = _moller_trumbore(leaf[:, 9 * j:9 * j + 9], origin, direction)
                found = do_tris & th & (ids[:, j] >= 0) & (tt < t)
                if any_hit:
                    occluded = occluded | found
                else:
                    t = torch.where(found, tt, t)
                    tri = torch.where(found, ids[:, j], tri)
                    u = torch.where(found, uu, u)
                    v = torch.where(found, vv, v)
            nxt = torch.where(hit_box, links[:, 1], links[:, 2])
            if any_hit:
                nxt = torch.where(occluded, -1, nxt)  # occluded rays park
            node = torch.where(active, nxt, node)
            if count_steps:
                steps += active.to(torch.int32)
                leaf_visits += do_tris.to(torch.int32)
                nodes_read[row_id[active]] = True
                leaves_read[links[:, 0][do_tris].long()] = True
    work = dict(steps=steps, leaf_visits=leaf_visits, nodes_read=nodes_read,
                leaves_read=leaves_read) if count_steps else {}
    if any_hit:
        return WalkResult(occluded=occluded, **work)
    return WalkResult(t=torch.where(tri < 0, BIG, t), tri=tri, u=u, v=v, **work)


def _kernel_inputs(bvh: BVHFlat, origin: Vec3, direction: Vec3, t_max):
    """The seven ray arrays, contiguous (camera rays may share one origin by
    broadcasting), and the two tables, as the kernel reads them; raises on
    what it cannot read."""
    n = origin.x.shape[0]
    dev = origin.x.device
    rays = tuple(a.contiguous() for a in (*origin, *direction, t_max))
    tables = (bvh.packed_nodes, bvh.leaf_geom)
    m = bvh.num_nodes
    ok = (
        all(a.dtype == torch.float32 and tuple(a.shape) == (n,) and a.device == dev for a in rays)
        and tuple(bvh.packed_nodes.shape) == (8 * m, 9) and bvh.leaf_geom.shape[1:] == (40,)
        and all(a.dtype == torch.float32 and a.device == dev and a.is_contiguous() for a in tables)
        and bvh.leaf_geom.data_ptr() % 16 == 0  # the kernel reads leaf rows 16 bytes at a time
    )
    if not ok:
        raise ValueError("bvh_walk: inputs do not match the kernel's dtypes, shapes, device, layout or alignment")
    return rays, tables


@torch.no_grad()
def bvh_walk(bvh: BVHFlat, origin: Vec3, direction: Vec3, t_max, any_hit: bool,
             count_steps: bool = False) -> WalkResult:
    """The skip-link walk of (N,) rays with (N,) float32 limits ``t_max``.
    CPU tensors take the plain twin; CUDA tensors launch
    ``csrc/bvh_walk.cu`` or raise."""
    dev = origin.x.device
    if dev.type == "cpu":
        return bvh_walk_reference(bvh, origin, direction, t_max, any_hit, count_steps)
    if dev.type != "cuda":
        raise ValueError(f"bvh_walk: unsupported device {dev}")
    n = origin.x.shape[0]
    rays, tables = _kernel_inputs(bvh, origin, direction, t_max)
    m = bvh.num_nodes
    # one allocation for t, tri, u, v / occluded and the step counts
    out = torch.empty((5, n), dtype=torch.float32, device=dev)
    t, tri, u, v = out[0], out[1].view(torch.int32), out[2], out[3]
    occ, steps = out[1].view(torch.int32), out[4].view(torch.int32)
    closest = (None,) * 4 if any_hit else (t, tri, u, v)  # None: the kernel writes nothing there
    launch("bvh_walk", "bvh_walk_launch", *tables, m, walk_budget(m), *rays, *closest, occ if any_hit else None,
           steps if count_steps else None, n, any_hit, device=dev)
    steps = steps if count_steps else None
    if any_hit:
        return WalkResult(occluded=occ != 0, steps=steps)
    return WalkResult(t=t, tri=tri, u=u, v=v, steps=steps)


def _limits(origin: Vec3, t_max) -> torch.Tensor:
    if torch.is_tensor(t_max):
        return (t_max * torch.ones_like(origin.x)).contiguous()
    return torch.full_like(origin.x, t_max)


def bvh_closest_hit(bvh: BVHFlat, tris: Triangles, origin: Vec3, direction: Vec3, t_max):
    """Closest hit over the triangle BVH.  Returns (t, tri_id, u, v); a miss
    has t = BIG and tri_id -1.  ``tris`` is unused, as in the reference: the
    leaf rows carry the geometry."""
    r = bvh_walk(bvh, origin, direction, _limits(origin, t_max), any_hit=False)
    return r.t, r.tri, r.u, r.v


def bvh_any_hit(bvh: BVHFlat, tris: Triangles, origin: Vec3, direction: Vec3, t_max):
    """Any-hit occlusion query: (N,) bool, True where a triangle lies
    before ``t_max``."""
    return bvh_walk(bvh, origin, direction, _limits(origin, t_max), any_hit=True).occluded


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
