"""The reference's own ray-mesh intersection, in plain PyTorch.

It shares no code with the program's traversal engines.  The triangles
(``v0``, ``e1``, ``e2`` in float32, as the scene files give them) are
grouped in Morton order of their centroids into clusters of ``CLUSTER``
triangles, each with a box padded outward.  A query:

1. slab-tests every ray against every cluster box, in blocks of rays, and
   keeps each ray's ``ROUND`` nearest entered clusters, nearest first;
2. visits them ``STEP`` clusters at a time, Möller-Trumbore against every
   triangle of each (the operation order of the wave2 kernel's plain
   twin, so that a hit distance is the same float), keeping the least t,
   ties to the lowest triangle id;
3. stops a ray once its next cluster starts beyond its best hit (closest
   hit) or once it has any hit (any-hit lanes); rays that used up their
   ``ROUND`` clusters unresolved run again from the next rank.

So the answer is exact: no cluster that could hold a nearer hit is left
out.  ``scene_traverse``, ``scene_hit_frame`` and ``scene_occluded`` keep
the semantics of the program's ``ops/traverse.py`` for a scene of analytic
prims and one baked mesh (no instances, no motion): prims first, the mesh
capped by the prims' hit, any-hit lanes collapsing to t = 0 on a hit.
``LOW_PRECISION`` (the control) rounds the rays and hit distances to
bfloat16 at every query.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math.sampling import build_onb
from ..math.vec import Vec3, normalize
from .intersect import BIG, Hits, PrimFrame, eval_prim_frame, intersect_prims, merge_frames

CLUSTER = 64  # triangles a cluster
ROUND = 256  # clusters a ray keeps from one slab test
STEP = 8  # clusters a ray visits a step
BLOCK = 1 << 25  # ray x cluster pairs in one slab-test block
TRI_EPS = 1e-7
HIT_EPS = 1e-4
LOW_PRECISION = False


def low(x):
    """Round to bfloat16 and back when the control is on."""
    return x.to(torch.bfloat16).to(torch.float32) if LOW_PRECISION else x


class MeshAccel(NamedTuple):
    lo: torch.Tensor  # (C, 3) padded cluster box min
    hi: torch.Tensor  # (C, 3) padded cluster box max
    geom: torch.Tensor  # (C, CLUSTER, 9) v0, e1, e2 (zeros in pad slots)
    tid: torch.Tensor  # (C, CLUSTER) int64 triangle id, -1 in pad slots


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton code of points normalised to [0, 1]^3."""
    q = np.clip((c * 1023.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_accel(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, device) -> MeshAccel:
    """Clusters over float32 (T, 3) arrays."""
    n = v0.shape[0]
    pts = np.stack([v0, v0 + e1, v0 + e2], 1).astype(np.float64)  # (T, 3, 3)
    cen = pts.mean(1)
    lo_all, hi_all = cen.min(0), cen.max(0)
    order = np.argsort(_morton((cen - lo_all) / np.maximum(hi_all - lo_all, 1e-30)), kind="stable")
    c = -(-n // CLUSTER)
    ids = np.full(c * CLUSTER, -1, np.int64)
    ids[:n] = order
    ids = ids.reshape(c, CLUSTER)
    safe = np.maximum(ids, 0)
    cp = pts[safe]  # (C, K, 3, 3)
    lo = cp.min((1, 2))
    hi = cp.max((1, 2))
    pad = 1e-5 * (np.abs(lo) + np.abs(hi) + 1.0)
    lo32 = np.nextafter((lo - pad).astype(np.float32), np.float32(-np.inf))
    hi32 = np.nextafter((hi + pad).astype(np.float32), np.float32(np.inf))
    geom = np.concatenate([v0[safe], e1[safe], e2[safe]], -1).astype(np.float32)
    geom[ids < 0] = 0.0
    t = lambda a: torch.as_tensor(a, device=device)
    return MeshAccel(t(lo32), t(hi32), t(geom), t(ids))


def _inv(d):
    return 1.0 / torch.where(torch.abs(d) > 1e-12, d, torch.where(d >= 0, 1e-12, -1e-12))


def _entries(acc: MeshAccel, o, inv, cap, rank0: int):
    """Each ray's clusters ranked ``rank0`` to ``rank0 + ROUND`` by entry
    distance, among those it enters before ``cap``: (ids, entry t), with
    t = inf past a ray's last one."""
    n, c = o.shape[0], acc.lo.shape[0]
    k = min(ROUND, max(c - rank0, 0))
    ids = torch.zeros((n, k), dtype=torch.int64, device=o.device)
    ts = torch.full((n, k), float("inf"), device=o.device)
    step = max(1, BLOCK // c)
    for a in range(0, n, step):
        oa, ia, ca = o[a:a + step, None, :], inv[a:a + step, None, :], cap[a:a + step, None]
        t1 = (acc.lo[None] - oa) * ia
        t2 = (acc.hi[None] - oa) * ia
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        enter = torch.clamp_min(near, 0.0)
        t = torch.where((far >= enter) & (enter < ca), enter, float("inf"))
        tk, ik = torch.topk(t, rank0 + k, dim=1, largest=False, sorted=True)
        ids[a:a + step], ts[a:a + step] = ik[:, rank0:], tk[:, rank0:]
    return ids, ts


def _mt(acc: MeshAccel, cl, o, d, best):
    """Möller-Trumbore of rays (A, 3) against the triangles of clusters cl
    (A, S): the least t below ``best`` per ray, ties to the lowest id, as
    (t, tri id, u, v); t = best and id -1 where none."""
    g = acc.geom[cl].flatten(1, 2)  # (A, S*K, 9)
    tid = acc.tid[cl].flatten(1, 2)
    col = lambda q: g[:, :, q]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (col(q) for q in range(9))
    rox, roy, roz = (o[:, q, None] for q in range(3))
    rdx, rdy, rdz = (d[:, q, None] for q in range(3))
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    okd = torch.abs(det) > TRI_EPS
    inv_det = 1.0 / torch.where(okd, det, 1.0)
    tx, ty, tz = rox - v0x, roy - v0y, roz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (okd & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > HIT_EPS) & (tid >= 0)
           & (tt < best[:, None]))
    t_hit = torch.where(hit, tt, float("inf"))
    t_min = t_hit.amin(1)
    win = hit & (t_hit == t_min[:, None])
    big = torch.iinfo(torch.int64).max
    id_min = torch.where(win, tid, big).amin(1)
    win = win & (tid == id_min[:, None])
    j = win.to(torch.int8).argmax(1, keepdim=True)
    got = win.any(1)
    return (torch.where(got, t_min, best), torch.where(got, id_min, -1),
            uu.gather(1, j)[:, 0], vv.gather(1, j)[:, 0])


def mesh_closest(acc: MeshAccel, origin: Vec3, direction: Vec3, cap, any_hit):
    """(t, tri id, u, v) of each ray's nearest triangle with HIT_EPS < t <
    cap (t = BIG, id -1 where none); ``any_hit`` lanes stop at their
    first hit and report t = 0."""
    o = torch.stack([low(origin.x), low(origin.y), low(origin.z)], 1).detach()
    d = torch.stack([low(direction.x), low(direction.y), low(direction.z)], 1).detach()
    n = o.shape[0]
    best = cap.detach().clone()
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    bu = torch.zeros(n, device=o.device)
    bv = torch.zeros(n, device=o.device)
    ah = any_hit if any_hit is not None else torch.zeros(n, dtype=torch.bool, device=o.device)
    inv = _inv(d)
    todo = torch.nonzero(cap > 0.0)[:, 0]
    rank0 = 0
    while todo.numel() and rank0 < acc.lo.shape[0]:
        ids, ts = _entries(acc, o[todo], inv[todo], best[todo], rank0)
        for j in range(0, ids.shape[1], STEP):
            live = (ts[:, j] < best[todo]) & ~(ah[todo] & (tri[todo] >= 0))
            rows = torch.nonzero(live)[:, 0]
            if rows.numel() == 0:
                break
            r = todo[rows]
            t, i, u, v = _mt(acc, ids[rows, j:j + STEP], o[r], d[r], best[r])
            got = i >= 0
            best[r] = t
            tri[r] = torch.where(got, i, tri[r])
            bu[r] = torch.where(got, u, bu[r])
            bv[r] = torch.where(got, v, bv[r])
        # rays whose kept clusters ran out while a nearer one may remain
        more = (ts[:, -1] < best[todo]) & ~(ah[todo] & (tri[todo] >= 0)) if ids.shape[1] else ts[:, 0] < 0
        todo = todo[more]
        rank0 += ROUND
    t = torch.where(tri >= 0, torch.where(ah, 0.0, low(best)), BIG)
    return t, tri, bu, bv


def scene_traverse(scene, origin: Vec3, direction: Vec3, t_max=None, time=None, any_hit=None) -> Hits:
    n = origin.x.shape
    dev = origin.x.device
    if t_max is None:
        t_max = torch.full(n, BIG, dtype=torch.float32, device=dev)
    t_p, pid = intersect_prims(scene.prims, origin, direction, t_max, time)
    t_p = low(t_p)
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    tri = torch.full(n, -1, dtype=torch.int32, device=dev)
    t, u, v = t_p, z, z
    if scene.tris is not None:
        t_t, tid, tu, tv = mesh_closest(scene.clusters, origin, direction, torch.minimum(t_p, t_max), any_hit)
        closer = (t_t < t_p) & (tid >= 0)
        t = torch.where(closer, t_t, t_p)
        pid = torch.where(closer, -1, pid)
        tri = torch.where(closer, tid.to(torch.int32), tri)
        u = torch.where(closer, tu, z)
        v = torch.where(closer, tv, z)
    return Hits(t=t, prim_id=pid, tri_id=tri, u=u, v=v, overflow=torch.zeros(n, dtype=torch.bool, device=dev),
                inst_id=torch.full(n, -1, dtype=torch.int32, device=dev), attr=None)


def eval_tri_frame(tris, hits: Hits, origin: Vec3, direction: Vec3) -> PrimFrame:
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
    frame = eval_prim_frame(scene.prims, hits.prim_id, origin, direction, hits.t, time=time)
    if scene.tris is None:
        return frame
    is_tri = hits.tri_id >= 0
    return merge_frames(is_tri, eval_tri_frame(scene.tris, hits, origin, direction), frame)


def scene_occluded(scene, origin: Vec3, direction: Vec3, t_max, time=None):
    t_max = t_max * torch.ones_like(origin.x)
    hits = scene_traverse(scene, origin, direction, t_max, time, any_hit=torch.ones_like(origin.x, dtype=torch.bool))
    return hits.t < t_max, hits.overflow


def scene_traversal_cost(scene, origin, direction, time=None):
    raise NotImplementedError("the reference counts no traversal work")
