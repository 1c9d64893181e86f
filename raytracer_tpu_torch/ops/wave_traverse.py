"""Binned-wavefront mesh traversal, the ``wave`` mode (port of
``raytracer_tpu/ops/wave_traverse.py``).

Exact closest-hit / any-hit over a ``ClusterSet``, plain PyTorch on any
device:

- **Phase 1, per-ray candidates** (``_phase1_round``): every ray is
  slab-tested against every cluster box in a dense (rays x C) pass, chunked
  over rays, and keeps its ``kc`` nearest overlapped clusters that come
  after its resume cursor, ordered by (entry distance, cluster id) as
  ``jax.lax.top_k`` orders them (``cluster_traverse.nearest_first``).
- **Phase 2, cluster-binned execution** (``_phase2_binned``): the (ray,
  cluster) pairs are sorted by cluster id and cut into blocks of ``BLOCK``
  pairs of one cluster; each block runs a dense Möller-Trumbore of its rays
  against the cluster's K triangles (``_mt_blocks``), and scatter-mins give
  each ray its round's least t, ties to the lowest tri id.
- **Rounds**: a ray whose ``kc``-th candidate was still nearer than its best
  hit goes round again from its cursor, so every overlapped cluster is
  processed once and nothing is dropped.  The reference's
  ``lax.while_loop`` becomes a python loop with two host syncs a round:
  whether any ray is still live, and the number of live blocks, which sizes
  phase 2 (the reference runs every block of its static capacity; the
  count is known only after the round's phase 1, so it cannot share the
  first sync).  ``overflow`` marks rays still unresolved after
  ``max_rounds``.

Traversal is detached from autograd, as in the reference (hit selection is
a discrete decision); the integrator re-derives smooth quantities from the
ids.
"""

from __future__ import annotations

import torch

from ..math.vec import Vec3
from ..scene.clusters import ClusterSet
from .cluster_traverse import nearest_first, per_ray, slab_test
from .cluster_traverse import slab_inv as _safe_inv
from .intersect import BIG

TRI_EPS = 1e-7
HIT_EPS = 1e-4

BLOCK = 128  # pairs per execution block
_PHASE1_ELEMS = 32 * 1024 * 1024  # (rays x clusters) f32 budget per phase-1 chunk
_MT_ELEMS = 1 << 24  # (blocks x BLOCK x K) budget per Möller-Trumbore chunk
_INT_MAX = 2 ** 31 - 1


def _phase1_round(cs: ClusterSet, ox, oy, oz, ix, iy, iz, best_t, res_e, res_c, kc: int):
    """One candidate round: each ray's ``kc`` nearest clusters whose
    (entry, cluster id) comes after its cursor (``res_e``, ``res_c``).
    Returns (cand (N, kc) int32, C for an empty slot; entry (N, kc) f32, +inf
    on an empty slot)."""
    n = ox.shape[0]
    c = cs.num_clusters
    ch = max(1, min(n, _PHASE1_ELEMS // max(c, 1)))
    boxes = tuple(b[None, :] for b in (cs.box_min_x, cs.box_min_y, cs.box_min_z,
                                       cs.box_max_x, cs.box_max_y, cs.box_max_z))
    cid_row = torch.arange(c, dtype=torch.int32, device=ox.device)[None, :]
    cands, entries = [], []
    for a in range(0, n, ch):
        col = lambda v: v[a:a + ch, None]
        tmin, tmax = slab_test(boxes, col(ox), col(oy), col(oz), col(ix), col(iy), col(iz))
        ent = torch.clamp_min(tmin, 0.0)
        ok = (tmax >= ent) & (ent < col(best_t))
        # lexicographic resume: (entry, cid) strictly after the cursor
        cre, crc = col(res_e), col(res_c)
        after = (ent > cre) | ((ent == cre) & (cid_row > crc))
        ent_k, idx = nearest_first(torch.where(ok & after, ent, float("inf")), kc)
        cands.append(torch.where(torch.isfinite(ent_k), idx.to(torch.int32), c))
        entries.append(ent_k)
    return torch.cat(cands), torch.cat(entries)


def _mt_blocks(tri_rows, orig, direction):
    """Dense Möller-Trumbore: (B, K, 9) cluster rows x (B, BLOCK) rays.
    ``orig`` / ``direction``: tuples of (B, BLOCK) components.  Returns each
    lane's best (t, slot, u, v) over the K triangles, the first slot among
    equal t; all-zero padding rows miss through det == 0."""
    ox, oy, oz = (a[:, :, None] for a in orig)
    dx, dy, dz = (a[:, :, None] for a in direction)
    v0x, v0y, v0z = (tri_rows[:, None, :, i] for i in range(3))
    e1x, e1y, e1z = (tri_rows[:, None, :, i] for i in range(3, 6))
    e2x, e2y, e2z = (tri_rows[:, None, :, i] for i in range(6, 9))
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
    pick = lambda a: torch.gather(a, 2, slot)[..., 0]
    return pick(tkey), slot[..., 0].to(torch.int32), pick(u), pick(v)


def _phase2_binned(cs: ClusterSet, cand, entry, ox, oy, oz, dx, dy, dz, best_t, limit, any_hit: bool):
    """Cluster-binned pair execution.  Returns each ray's round-best (t, tri,
    u, v), t = +inf where the round found nothing.  For ``any_hit`` a hit
    below the ray's ``limit`` reports t = 0 (the caller ORs occlusion across
    rounds)."""
    n, kc = cand.shape
    c = cs.num_clusters
    k = cs.tris_per_cluster
    p = n * kc
    dev = cand.device
    inf = float("inf")

    valid = torch.isfinite(entry) & (entry < best_t[:, None])
    pair_key = torch.where(valid, cand, c).reshape(p)
    sk, perm = torch.sort(pair_key, stable=True)
    sv = perm.to(torch.int32)

    # blocks over runs of equal cluster id: lane = position within the run
    # mod BLOCK; a block starts at every run start and every BLOCK pairs of a run
    pos = torch.arange(p, dtype=torch.int32, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sk[1:] != sk[:-1]])
    run_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
    lane = torch.remainder(pos - run_start, BLOCK)
    blk = torch.cumsum((lane == 0).to(torch.int32), 0, dtype=torch.int32) - 1  # nondecreasing

    b_cap = p // BLOCK + c + 1  # every run adds at most one partial block
    block_start = torch.searchsorted(blk, torch.arange(b_cap, dtype=torch.int32, device=dev)).to(torch.int32)
    has_pairs = block_start < p
    block_cluster = torch.where(has_pairs, sk[torch.clamp_max(block_start, p - 1)].to(torch.int32), c)
    block_live = has_pairs & (block_cluster < c)
    # pairs are sorted by cluster id with the empty key C last, so the live
    # blocks are a prefix: the rest would only yield t = +inf (the round's
    # second host sync)
    n_live = int(block_live.sum().item())

    rt = torch.full((n,), inf, dtype=torch.float32, device=dev)
    rtri = torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev)
    ru = torch.zeros(n + 1, dtype=torch.float32, device=dev)  # slot n takes the dropped writes
    rv = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    if n_live == 0:
        return rt, torch.full((n,), -1, dtype=torch.int32, device=dev), ru[:n], rv[:n]

    lanes = torch.arange(BLOCK, dtype=torch.int32, device=dev)[None, :]
    ids = torch.arange(n_live, dtype=torch.int32, device=dev)[:, None]
    pair_pos = torch.clamp_max(block_start[:n_live, None] + lanes, p - 1).long()
    lane_ok = blk[pair_pos] == ids
    ray = (sv[pair_pos] // kc).long()  # (n_live, BLOCK) ray of each lane
    cl = block_cluster[:n_live].long()

    step = max(1, _MT_ELEMS // (BLOCK * k))
    t_parts, tid_parts, u_parts, v_parts = [], [], [], []
    for a in range(0, n_live, step):
        r = ray[a:a + step]
        tri_rows = cs.tri_block[cl[a:a + step]].reshape(-1, k, 9)
        t, slot, u, v = _mt_blocks(tri_rows, (ox[r], oy[r], oz[r]), (dx[r], dy[r], dz[r]))
        t_parts.append(t)
        tid_parts.append(torch.gather(cs.tri_id[cl[a:a + step]], 1, slot.long()))
        u_parts.append(u)
        v_parts.append(v)
    t, tid, u, v = (torch.cat(x) for x in (t_parts, tid_parts, u_parts, v_parts))
    hit = lane_ok & (tid >= 0) & (t < limit[ray])
    t = torch.where(hit, 0.0 if any_hit else t, inf)

    # per-ray reduction by scatter-min: (1) least t, (2) least tri id among
    # the t-winners (deterministic tie-break), (3) the unique winner writes u/v
    ray_f, t_f = ray.reshape(-1), t.reshape(-1)
    rt.scatter_reduce_(0, ray_f, t_f, "amin")
    win = (t_f == rt[ray_f]) & torch.isfinite(t_f)
    tid_f = torch.where(win, tid.reshape(-1), _INT_MAX)
    rtri.scatter_reduce_(0, ray_f, tid_f, "amin")
    final = win & (tid_f == rtri[ray_f])
    w_idx = torch.where(final, ray_f, n)
    ru.scatter_(0, w_idx, u.reshape(-1))
    rv.scatter_(0, w_idx, v.reshape(-1))
    rtri = torch.where(torch.isfinite(rt), rtri, -1)
    return rt, rtri, ru[:n], rv[:n]


def _wave_trace(cs: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kc: int, max_rounds: int, any_hit: bool):
    """The round loop.  Returns (best_t, best_tri, best_u, best_v, live):
    ``live`` marks rays still unresolved after ``max_rounds``."""
    n = ox.shape[0]
    dev = ox.device
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    best_t = tm.clone()  # closest: best t; any-hit: parks at 0 once occluded
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    res_e = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    res_c = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    for _ in range(max_rounds):
        if not bool(live.any()):  # the round's first host sync
            break
        # dead rays scan with best_t = 0 -> zero candidates
        scan_t = torch.where(live, best_t, 0.0)
        cand, entry = _phase1_round(cs, ox, oy, oz, ix, iy, iz, scan_t, res_e, res_c, kc)
        rt, rtri, ru, rv = _phase2_binned(cs, cand, entry, ox, oy, oz, dx, dy, dz, best_t,
                                          tm if any_hit else best_t, any_hit)
        closer = rt < best_t
        best_t = torch.where(closer, rt, best_t)
        best_tri = torch.where(closer, rtri, best_tri)
        best_u = torch.where(closer, ru, best_u)
        best_v = torch.where(closer, rv, best_v)
        # advance the resume cursor to the last candidate processed
        got = torch.isfinite(entry).sum(1)
        full_round = got == kc
        last = torch.clamp_min(got - 1, 0)
        last_e = entry[rows, last]
        res_e = torch.where(full_round, last_e, res_e)
        res_c = torch.where(full_round, cand[rows, last], res_c)
        # more candidates only if this round filled all kc slots and the
        # last one was still nearer than the (updated) best
        live = full_round & (last_e < best_t)
    return best_t, best_tri, best_u, best_v, live


@torch.no_grad()
def wave_closest_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kc: int = 16, max_rounds: int = 16):
    """Closest hit over the cluster set.  Returns (t, tri_id, u, v, overflow):
    t == BIG and tri_id == -1 on a miss; ``overflow`` marks rays unresolved
    after ``max_rounds`` (it needs max_rounds x kc clusters before the first
    hit)."""
    t, tri, u, v, overflow = _wave_trace(cs, origin.x, origin.y, origin.z, direction.x, direction.y, direction.z,
                                         per_ray(origin, t_max), min(kc, cs.num_clusters), max_rounds, False)
    return torch.where(tri < 0, BIG, t), tri, u, v, overflow


@torch.no_grad()
def wave_any_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kc: int = 16, max_rounds: int = 16):
    """Any-hit occlusion query.  Returns (occluded, overflow).  An occluded
    ray parks at t = 0, which empties its next round's candidates."""
    _, tri, _, _, overflow = _wave_trace(cs, origin.x, origin.y, origin.z, direction.x, direction.y, direction.z,
                                         per_ray(origin, t_max), min(kc, cs.num_clusters), max_rounds, True)
    return tri >= 0, overflow
