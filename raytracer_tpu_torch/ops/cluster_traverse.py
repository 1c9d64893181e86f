"""Dense two-phase ray traversal over triangle clusters (port of
``raytracer_tpu/ops/cluster_traverse.py``): the ``cluster`` traversal mode
and the exact per-ray path the block-candidate kernels are held against.

Phase 1: slab-test each ray against every cluster AABB, an (n, C)
elementwise pass chunked over rays, then take each ray's ``kmax`` nearest
overlapped clusters (nearest first; equal keys keep the lowest cluster id
first, as ``jax.lax.top_k`` orders them: ``torch.topk`` promises no order
among equal keys, so a stable sort takes its place).

Phase 2: a python loop over the kmax candidates; each step gathers one
cluster's (K*9) triangle block per ray and runs a dense Möller-Trumbore
over its K triangles.  A step contributes nothing once the ray's best hit
is closer than the candidate's entry distance.

A ray overlapping more than ``kmax`` clusters closer than its final hit
could miss geometry; the returned overflow mask reports such rays.  Plain
PyTorch on any device; detached from autograd like every traversal.
"""

from __future__ import annotations

import torch

from ..math.vec import Vec3
from ..scene.clusters import ClusterSet
from .intersect import BIG

TRI_EPS = 1e-7
HIT_EPS = 1e-4
_CHUNK_ELEMS = 32 * 1024 * 1024  # phase-1 (n_chunk x C) matrix budget (floats)


def slab_inv(d):
    """Slab-test inverse direction with the reference's 1e-12 floor."""
    tiny = 1e-12
    return 1.0 / torch.where(torch.abs(d) > tiny, d, torch.where(d >= 0, tiny, -tiny))


def per_ray(origin: Vec3, t_max):
    """``t_max`` (scalar or tensor) as one float32 limit per ray."""
    ones = torch.ones_like(origin.x)
    return t_max.to(torch.float32) * ones if torch.is_tensor(t_max) else float(t_max) * ones


def slab_test(boxes, ox, oy, oz, ix, iy, iz):
    """(tmin, tmax) of rays against boxes; ``boxes`` is the 6-tuple
    (min.xyz, max.xyz), broadcast against the ray columns."""
    bx0, by0, bz0, bx1, by1, bz1 = boxes
    t1x, t2x = (bx0 - ox) * ix, (bx1 - ox) * ix
    t1y, t2y = (by0 - oy) * iy, (by1 - oy) * iy
    t1z, t2z = (bz0 - oz) * iz, (bz1 - oz) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                         torch.maximum(t1z, t2z))
    return tmin, tmax


def nearest_first(key, k: int):
    """The ``k`` smallest keys of each row, nearest first, as
    ``jax.lax.top_k(-key, k)`` orders them: by the total order of float32
    (-0.0 before +0.0) and, among equal keys, the lowest column first.
    Returns (keys, int64 columns)."""
    bits = key.contiguous().view(torch.int32)
    order_key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(order_key, dim=-1, stable=True).indices[..., :k]
    return torch.gather(key, -1, idx), idx


def _phase1_candidates(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kmax: int):
    """(N, kmax) nearest-first candidate cluster ids + entry distances
    (+inf where fewer than kmax clusters overlap)."""
    n = origin.x.shape[0]
    n_chunk = max(1, min(n, _CHUNK_ELEMS // max(cs.num_clusters, 1)))
    boxes = tuple(b[None, :] for b in (cs.box_min_x, cs.box_min_y, cs.box_min_z,
                                       cs.box_max_x, cs.box_max_y, cs.box_max_z))
    ix, iy, iz = slab_inv(direction.x), slab_inv(direction.y), slab_inv(direction.z)
    tm = per_ray(origin, t_max)
    ids, tmins = [], []
    for a in range(0, n, n_chunk):
        col = lambda v: v[a:a + n_chunk, None]
        tmin, tmax = slab_test(boxes, col(origin.x), col(origin.y), col(origin.z), col(ix), col(iy), col(iz))
        hit = (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin < col(tm))
        key, idx = nearest_first(torch.where(hit, tmin, float("inf")), kmax)
        ids.append(idx.to(torch.int32))
        tmins.append(key)
    return torch.cat(ids), torch.cat(tmins)


def _mt_block(block, origin: Vec3, direction: Vec3, k: int):
    """Möller-Trumbore over a gathered (N, K*9) block: each ray's best
    (t, slot, u, v) within it (the first slot among equal t)."""
    nb = block.reshape(block.shape[0], k, 9)
    ox, oy, oz = origin.x[:, None], origin.y[:, None], origin.z[:, None]
    dx, dy, dz = direction.x[:, None], direction.y[:, None], direction.z[:, None]
    v0x, v0y, v0z = nb[..., 0], nb[..., 1], nb[..., 2]
    e1x, e1y, e1z = nb[..., 3], nb[..., 4], nb[..., 5]
    e2x, e2y, e2z = nb[..., 6], nb[..., 7], nb[..., 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > TRI_EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > HIT_EPS)
    tkey = torch.where(hit, t, BIG)
    slot = torch.argmin(tkey, dim=-1, keepdim=True)
    pick = lambda a: torch.gather(a, 1, slot)[:, 0]
    return pick(tkey), slot[:, 0], pick(u), pick(v)


@torch.no_grad()
def cluster_closest_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kmax: int = 32):
    """Closest hit. Returns (t, tri_id, u, v, overflow_mask); t == BIG and
    tri_id == -1 on a miss."""
    k = cs.tris_per_cluster
    kmax = min(kmax, cs.num_clusters)
    ids, tmins = _phase1_candidates(cs, origin, direction, t_max, kmax)

    best_t = per_ray(origin, t_max)
    best_id = torch.full_like(origin.x, -1, dtype=torch.int32)
    best_u = torch.zeros_like(origin.x)
    best_v = torch.zeros_like(origin.x)
    for j in range(kmax):
        cid = ids[:, j].long()
        entry = tmins[:, j]
        live = torch.isfinite(entry) & (entry < best_t)
        t, slot, u, v = _mt_block(cs.tri_block[cid], origin, direction, k)
        tid = torch.gather(cs.tri_id[cid], 1, slot[:, None])[:, 0]
        closer = live & (tid >= 0) & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_id = torch.where(closer, tid, best_id)
        best_u = torch.where(closer, u, best_u)
        best_v = torch.where(closer, v, best_v)

    # the farthest candidate was still closer than the final hit: clusters
    # beyond kmax might have mattered
    overflow = torch.isfinite(tmins[:, kmax - 1]) & (tmins[:, kmax - 1] < best_t)
    t_out = torch.where(best_id < 0, BIG, best_t)
    return t_out, best_id, best_u, best_v, overflow


@torch.no_grad()
def cluster_any_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kmax: int = 32):
    """Any-hit occlusion query. Returns (occluded, overflow): ``overflow``
    marks unoccluded rays that still had >= kmax candidate clusters."""
    k = cs.tris_per_cluster
    kmax = min(kmax, cs.num_clusters)
    ids, tmins = _phase1_candidates(cs, origin, direction, t_max, kmax)
    limit = per_ray(origin, t_max)
    occluded = torch.zeros_like(origin.x, dtype=torch.bool)
    for j in range(kmax):
        cid = ids[:, j].long()
        live = torch.isfinite(tmins[:, j]) & (~occluded)
        t, slot, _, _ = _mt_block(cs.tri_block[cid], origin, direction, k)
        tid = torch.gather(cs.tri_id[cid], 1, slot[:, None])[:, 0]
        occluded = occluded | (live & (tid >= 0) & (t < limit))
    overflow = torch.isfinite(tmins[:, kmax - 1]) & (~occluded)
    return occluded, overflow
