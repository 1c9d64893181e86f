"""Block-candidate cluster traversal (port of
``raytracer_tpu/ops/pallas_traverse.py``): the ``sorted-pallas`` traversal
mode and the ``pallas_cluster_*`` entry points.  The public names of the
reference are kept so a reader finds the counterpart; its two Pallas TPU
kernels are hand-written CUDA kernels here.

Rays are grouped into blocks of ``RB = 8 * 128``.  Phase 1 finds, per
block, up to ``kb`` candidate clusters nearest first: densely
(``_block_candidates``: slab test of every ray against every cluster,
block-min entry distance, the kb nearest) or by a breadth-first walk of
the 8-ary cluster tree with the block's interval ray
(``_block_candidates_bfs``; truncation at any level sets the block's
overflow flag).  Phase 2 runs Möller-Trumbore over the candidates'
triangles for all rays of the block:

- ``phase2_grid`` (``csrc/phase2_grid.cu``, the reference's
  ``_phase2_kernel``): every candidate j in table order, skipped when its
  entry distance is not below the block's largest running t;
- ``phase2_stream`` (``csrc/phase2_stream.cu``, the reference's
  ``_phase2_stream_kernel``): a loop that ENDS at the first such candidate,
  with a per-ray cluster-box test whose block-wide OR gates the triangle
  loop, and an any-hit mode that parks hit lanes at t = 0.

Both gates are per block, never per ray: a ray whose own box test fails
still meets the triangles when another ray of its block passes.  Each
kernel has its plain PyTorch version beside it (``*_reference``), in the
kernel's operation order; a wrapper takes it only for CPU tensors and
launches the kernel for CUDA tensors, or raises.

The sorted front end (``_pallas_stream_trace``) sorts the wavefront by
(direction octant, origin Morton cell) so that blocks are coherent, traces
the sorted blocks and scatters the results back.  This path is known to be
inexact on incoherent wavefronts (the block union overflows ``kb``); the
port reproduces its candidates, answers and overflow flags and does not
improve them.  Traversal is detached from autograd.
"""

from __future__ import annotations

import torch

from ..math.vec import Vec3
from ..scene.clusters import ClusterSet
from .cluster_traverse import HIT_EPS, TRI_EPS, nearest_first, per_ray, slab_inv, slab_test
from .cuda_build import launch
from .intersect import BIG

RB_SUB = 8  # ray-block rows
RB_LANE = 128  # ray-block lanes
RB = RB_SUB * RB_LANE  # rays per block
_PHASE1_ELEMS = 32 * 1024 * 1024  # (rays x clusters) f32 budget per phase-1 step


# --------------------------------------------------------------------------
# Phase 1, dense: per-block nearest clusters
# --------------------------------------------------------------------------


def _block_candidates(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kb: int):
    """Per-ray-block nearest-first candidate clusters.  Returns (cand
    (B, kb) int32 valid ids, entry (B, kb) f32 block-min entry distance,
    +inf where no ray of the block overlaps the cluster)."""
    n = origin.x.shape[0]
    c = cs.num_clusters
    b = n // RB
    blocks_per_chunk = max(1, min(b, _PHASE1_ELEMS // max(c * RB, 1)))
    blk = lambda x: x.reshape(b, RB, 1)
    ox, oy, oz = blk(origin.x), blk(origin.y), blk(origin.z)
    ix, iy, iz = blk(slab_inv(direction.x)), blk(slab_inv(direction.y)), blk(slab_inv(direction.z))
    tm = blk(per_ray(origin, t_max))
    boxes = tuple(x[None, None, :] for x in (cs.box_min_x, cs.box_min_y, cs.box_min_z,
                                             cs.box_max_x, cs.box_max_y, cs.box_max_z))
    ids, entry = [], []
    for a in range(0, b, blocks_per_chunk):
        w = slice(a, a + blocks_per_chunk)
        tmin, tmax = slab_test(boxes, ox[w], oy[w], oz[w], ix[w], iy[w], iz[w])
        hit = (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin < tm[w])  # (bpc, RB, C)
        key = torch.where(hit, torch.clamp_min(tmin, 0.0), float("inf"))
        ent, idx = nearest_first(key.amin(1), kb)  # block-min entry distance
        ids.append(idx.to(torch.int32))
        entry.append(ent)
    return torch.clamp(torch.cat(ids), 0, c - 1), torch.cat(entry)


# --------------------------------------------------------------------------
# Sorted front end: ray keys, block bounds, BFS candidates
# --------------------------------------------------------------------------


def _ray_sort_keys(cs: ClusterSet, origin: Vec3, direction: Vec3):
    """int32 sort key: octant (3 bits) | 27-bit Morton of the origin cell."""
    lo = [x.min() for x in (cs.box_min_x, cs.box_min_y, cs.box_min_z)]
    hi = [x.max() for x in (cs.box_max_x, cs.box_max_y, cs.box_max_z)]
    span = [torch.clamp_min(h - l, 1e-6) for h, l in zip(hi, lo)]

    def q9(v, lo, span):  # 9 bits per axis
        return torch.clamp((v - lo) / span * 511.0, 0.0, 511.0).to(torch.int32)

    def spread(v):  # 9-bit Morton spread over 27 bits
        v = v & 0x1FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    qx = spread(q9(origin.x, lo[0], span[0]))
    qy = spread(q9(origin.y, lo[1], span[1]))
    qz = spread(q9(origin.z, lo[2], span[2]))
    morton = qx | (qy << 1) | (qz << 2)
    octant = ((direction.x < 0).to(torch.int32) + 2 * (direction.y < 0).to(torch.int32)
              + 4 * (direction.z < 0).to(torch.int32))
    return (octant << 27) | morton


def _block_bounds(origin: Vec3, direction: Vec3, tm):
    """Per-block interval-ray bounds: origin box, direction box, max t.
    ``tm`` (B, RB); pad rays carry t_max == 0 and are excluded.  Returns
    (o_lo, o_hi, d_lo, d_hi, t_hi): 3-tuples of (B, 1), and (B, 1)."""
    b = tm.shape[0]
    live = tm > 0.0
    big = 3e38
    mn = lambda v: torch.where(live, v, big).amin(1, keepdim=True)
    mx = lambda v: torch.where(live, v, -big).amax(1, keepdim=True)
    blk = lambda v: v.reshape(b, RB)
    o = (blk(origin.x), blk(origin.y), blk(origin.z))
    d = (blk(direction.x), blk(direction.y), blk(direction.z))
    return (tuple(mn(v) for v in o), tuple(mx(v) for v in o),
            tuple(mn(v) for v in d), tuple(mx(v) for v in d), mx(tm))


def _interval_entry(bounds, boxes):
    """Conservative slab test of a block's interval ray against ``boxes``
    (B, M, 6) [min.xyz, max.xyz] (empty boxes have min > max).  Returns
    (entry (B, M), a LOWER bound of any block ray's entry distance;
    reachable (B, M) bool).  A block whose directions straddle zero on an
    axis degrades to a conservative keep on that axis."""
    o_lo, o_hi, d_lo, d_hi, t_hi = bounds
    entry = torch.zeros(boxes.shape[:2], dtype=torch.float32, device=boxes.device)
    exit_ = t_hi.expand(boxes.shape[:2])
    tiny = 1e-12
    for ax in range(3):
        olo, ohi = o_lo[ax], o_hi[ax]
        dlo, dhi = d_lo[ax], d_hi[ax]
        blo, bhi = boxes[:, :, ax], boxes[:, :, 3 + ax]
        pos = dlo >= 0.0  # (B, 1): the whole block moves +ax
        # entry lower bound: closest origin at the fastest speed;
        # exit upper bound: farthest origin at the slowest speed
        ent_pos = (blo - ohi) / torch.clamp_min(dhi, tiny)
        ent_neg = (bhi - olo) / torch.clamp_max(dlo, -tiny)
        ext_pos = (bhi - olo) / torch.clamp_min(dlo, tiny)
        ext_neg = (blo - ohi) / torch.clamp_max(dhi, -tiny)
        ent = torch.where(pos, ent_pos, ent_neg)
        ext = torch.where(pos, ext_pos, ext_neg)
        degen = ((dlo < 0.0) & (dhi > 0.0)) | (torch.maximum(torch.abs(dlo), torch.abs(dhi)) < 1e-6)
        # degenerate axis: keep, but empty boxes (tree padding) stay rejected
        ent = torch.where(degen, 0.0, ent)
        ext = torch.where(degen, torch.where(blo <= bhi, 3e38, -1.0), ext)
        entry = torch.maximum(entry, torch.clamp_min(ent, 0.0))
        exit_ = torch.minimum(exit_, ext)
    return entry, exit_ >= entry


def _block_candidates_bfs(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kb: int):
    """Per-block candidate clusters by a breadth-first walk down the 8-ary
    cluster tree.  Each level expands every surviving node into its 8
    children, tests them against the block's interval ray and compacts the
    survivors, in order, into at most ``kb`` slots; truncation at ANY level
    sets the block's overflow flag.  Returns (cand (B, k_final) int32 ids,
    entry (B, k_final) ascending lower bounds (+inf = invalid), overflow
    (B,) bool)."""
    n = origin.x.shape[0]
    b = n // RB
    dev = origin.x.device
    tm = per_ray(origin, t_max).reshape(b, RB)
    bounds = _block_bounds(origin, direction, tm)
    levels = cs.tree_levels
    inf = float("inf")
    eight = torch.arange(8, dtype=torch.int32, device=dev)

    # root level: test all 8 top nodes
    ids = eight[None, :].expand(b, 8)
    ent, ok = _interval_entry(bounds, levels[0][None].expand(b, 8, 6))
    ids = torch.where(ok, ids, -1)
    overflow = torch.zeros(b, dtype=torch.bool, device=dev)

    for level in levels[1:]:
        k_cur = ids.shape[1]
        k_next = min(kb, k_cur * 8)
        child = (torch.clamp_min(ids, 0)[:, :, None] * 8 + eight[None, None, :]).reshape(b, k_cur * 8)
        parent_ok = (ids >= 0).repeat_interleave(8, dim=1)
        boxes = level[child.long()]  # (B, 8K, 6)
        ent, ok = _interval_entry(bounds, boxes)
        ok = ok & parent_ok
        # stable compaction: cumsum positions; what does not fit spills into
        # one extra column that is cut off again
        pos = torch.cumsum(ok.to(torch.int32), dim=1) - 1
        keep = ok & (pos < k_next)
        overflow = overflow | (ok & (pos >= k_next)).any(1)
        slot = torch.where(keep, pos, k_next).long()
        new_ids = torch.full((b, k_next + 1), -1, dtype=torch.int32, device=dev)
        new_ent = torch.full((b, k_next + 1), inf, dtype=torch.float32, device=dev)
        new_ids.scatter_(1, slot, torch.where(keep, child, -1))
        new_ent.scatter_(1, slot, torch.where(keep, ent, inf))
        ids = new_ids[:, :k_next]
        ent = new_ent[:, :k_next]

    # nearest-first ordering for the kernels' early-out
    k_final = min(kb, ids.shape[1])
    entry, order = nearest_first(torch.where(ids >= 0, ent, inf), k_final)
    cand = torch.gather(ids, 1, order)
    return torch.clamp(cand, 0, cs.num_clusters - 1), entry, overflow


# --------------------------------------------------------------------------
# Phase 2: the two kernels and their plain versions
# --------------------------------------------------------------------------


def _mt_candidate(geom, tid, rays, t, tri, u, v, any_hit: bool):
    """Möller-Trumbore of L ray blocks against one candidate cluster each,
    folded into the running (t, tri, u, v) as the kernels' slot loop folds
    it: slots in order, strict ``tt < best_t``, so the first slot of the
    least t wins (closest hit) or the first slot that hits at all (any-hit,
    which parks the lane at t = 0).

    ``geom`` (L, K, 9), ``tid`` (L, K) int32, rays and state (L, 8, 128).
    Vectorised over the K slots; every product and sum is the kernel's."""
    ox, oy, oz, dx, dy, dz = (a[:, None] for a in rays)  # (L, 1, 8, 128)
    g = lambda i: geom[:, :, i, None, None]  # (L, K, 1, 1)
    v0x, v0y, v0z = g(0), g(1), g(2)
    e1x, e1y, e1z = g(3), g(4), g(5)
    e2x, e2y, e2z = g(6), g(7), g(8)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > TRI_EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    tid_b = tid[:, :, None, None]
    hit = (ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > HIT_EPS) & (tid_b >= 0)
           & (tt < t[:, None]))
    k = geom.shape[1]
    slots = torch.arange(k, dtype=torch.int32, device=geom.device)[None, :, None, None]
    if any_hit:
        first = torch.where(hit, slots, k).amin(1)  # the first slot that hits
    else:
        t_min = torch.where(hit, tt, float("inf")).amin(1)
        first = torch.where(hit & (tt == t_min[:, None]), slots, k).amin(1)  # the first of the least t
    won = first < k
    pick = lambda a: torch.gather(a.expand(-1, -1, RB_SUB, RB_LANE), 1,
                                  torch.clamp_max(first, k - 1).long()[:, None])[:, 0]
    tri = torch.where(won, pick(tid_b), tri)
    if any_hit:
        return torch.where(won, 0.0, t), tri, u, v
    return torch.where(won, t_min, t), tri, torch.where(won, pick(uu), u), torch.where(won, pick(vv), v)


def _check_phase2_inputs(name, cand, entry, rays, dev):
    b, kb = cand.shape
    ok = (
        cand.dtype == torch.int32 and entry.dtype == torch.float32 and entry.shape == cand.shape and kb >= 1
        and all(a.dtype == torch.float32 and tuple(a.shape) == (b, RB_SUB, RB_LANE) for a in rays)
        and all(a.device == dev and a.is_contiguous() for a in (cand, entry) + tuple(rays))
    )
    if not ok:
        raise ValueError(f"{name}: inputs do not match the kernel's dtypes, shapes, device or layout")


def _launch_phase2(name, tables, cand, entry, rays, ints):
    """Allocate (t, tri, u, v) and launch ``csrc/<name>.cu``."""
    t = torch.empty_like(rays[0])
    tri = torch.empty_like(rays[0], dtype=torch.int32)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    launch(name, name + "_launch", cand, entry, *tables, *rays, t, tri, u, v, *ints, device=t.device)
    return t, tri, u, v


def phase2_grid_reference(cand, entry, tri_block, tri_id, ox, oy, oz, dx, dy, dz, tm, stats: dict = None):
    """Plain PyTorch version of ``csrc/phase2_grid.cu`` (and of the TPU
    ``_phase2_kernel``).  For candidate j = 0..kb-1 in table order: blocks
    with ``entry[b, j] < max(t)`` over all their 1,024 rays run
    Möller-Trumbore against cluster ``cand[b, j]``; the others skip it.
    Vectorised over the live blocks.  Returns (t, tri, u, v), each
    (B, 8, 128).  ``stats`` counts 'visits', the (block, candidate) steps
    that ran, 'block_visits', the same per ray block (B,), and 'touched', the
    distinct clusters they read."""
    k = tri_id.shape[1]
    touched = torch.zeros(tri_id.shape[0], dtype=torch.bool, device=tm.device)
    if stats is not None:
        stats.setdefault("visits", 0)
        stats["block_visits"] = torch.zeros(cand.shape[0], dtype=torch.int64, device=tm.device)
    rays = (ox, oy, oz, dx, dy, dz)
    t = tm.clone()
    tri = torch.full_like(tm, -1, dtype=torch.int32)
    u = torch.zeros_like(tm)
    v = torch.zeros_like(tm)
    for j in range(cand.shape[1]):
        live = (entry[:, j] < t.amax((1, 2))).nonzero()[:, 0]
        if live.numel() == 0:
            continue
        c = cand[live, j].long()
        if stats is not None:
            stats["visits"] += live.numel()
            stats["block_visits"][live] += 1
            touched[c] = True
        out = _mt_candidate(tri_block[c].reshape(-1, k, 9), tri_id[c], tuple(a[live] for a in rays),
                            t[live], tri[live], u[live], v[live], any_hit=False)
        for dst, src in zip((t, tri, u, v), out):
            dst[live] = src
    if stats is not None:
        stats["touched"] = int(touched.sum())
    return t, tri, u, v


def phase2_grid(cand, entry, tri_block, tri_id, ox, oy, oz, dx, dy, dz, tm):
    """Phase 2 over a (B, kb) candidate table, every candidate visited or
    skipped.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/phase2_grid.cu`` or raise."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    dev = ox.device
    if dev.type == "cpu":
        return phase2_grid_reference(cand, entry, tri_block, tri_id, *rays)
    if dev.type != "cuda":
        raise ValueError(f"phase2_grid: unsupported device {dev}")
    _check_phase2_inputs("phase2_grid", cand, entry, rays, dev)
    c, k = tri_id.shape
    # the kernel's copy engine moves 16 bytes at a time: rows of k*36 and k*4 bytes
    ok = (tri_block.dtype == torch.float32 and tuple(tri_block.shape) == (c, k * 9)
          and tri_id.dtype == torch.int32 and 0 < k <= 128 and k % 4 == 0
          and all(a.device == dev and a.is_contiguous() and a.data_ptr() % 16 == 0 for a in (tri_block, tri_id)))
    if not ok:
        raise ValueError("phase2_grid: cluster tables do not match the kernel's dtypes, shapes (k a multiple of 4), "
                         "device, layout or 16-byte alignment")
    return _launch_phase2("phase2_grid", (tri_block, tri_id), cand, entry, rays, (cand.shape[0], cand.shape[1], k))


def phase2_stream_reference(cand, entry, stream_block, ox, oy, oz, dx, dy, dz, tm, k: int, any_hit: bool,
                            stats: dict = None):
    """Plain PyTorch version of ``csrc/phase2_stream.cu`` (and of the TPU
    ``_phase2_stream_kernel``).  Each block walks its candidates while
    ``entry[b, j] < max(t)`` and leaves the loop for good at the first that
    fails; per candidate every ray slab-tests the cluster box, and the
    triangle loop runs for the WHOLE block iff any of its rays passes.
    Vectorised over the blocks still in their loop.  Returns (t, tri, u, v),
    each (B, 8, 128).  ``stats`` counts 'steps' (loop iterations), 'visits'
    (iterations that ran the triangle loop), 'block_steps' and 'block_visits'
    (the same per ray block, (B,)) and 'touched' (distinct clusters whose
    tile was read)."""
    rays = (ox, oy, oz, dx, dy, dz)
    ix, iy, iz = slab_inv(dx), slab_inv(dy), slab_inv(dz)
    tiles = stream_block.reshape(stream_block.shape[0], -1)
    t = tm.clone()
    tri = torch.full_like(tm, -1, dtype=torch.int32)
    u = torch.zeros_like(tm)
    v = torch.zeros_like(tm)
    walking = torch.ones(cand.shape[0], dtype=torch.bool, device=tm.device)
    touched = torch.zeros(tiles.shape[0], dtype=torch.bool, device=tm.device)
    if stats is not None:
        stats.setdefault("steps", 0)
        stats.setdefault("visits", 0)
        stats["block_steps"] = torch.zeros(cand.shape[0], dtype=torch.int64, device=tm.device)
        stats["block_visits"] = torch.zeros(cand.shape[0], dtype=torch.int64, device=tm.device)
    for j in range(cand.shape[1]):
        walking = walking & (entry[:, j] < t.amax((1, 2)))
        step = walking.nonzero()[:, 0]
        if step.numel() == 0:
            break
        c = cand[step, j].long()
        tile = tiles[c]  # (S, T*1024)
        box = tuple(tile[:, 10 * k + i, None, None] for i in range(6))
        bmin, bmax = slab_test(box, ox[step], oy[step], oz[step], ix[step], iy[step], iz[step])
        box_hit = (bmax >= torch.clamp_min(bmin, 0.0)) & (bmin < t[step])
        run = box_hit.any(2).any(1)
        if stats is not None:
            stats["steps"] += step.numel()
            stats["visits"] += int(run.sum())
            stats["block_steps"][step] += 1
            stats["block_visits"][step[run]] += 1
            touched[c] = True
        live, tile = step[run], tile[run]
        if live.numel() == 0:
            continue
        out = _mt_candidate(tile[:, :9 * k].reshape(-1, k, 9), tile[:, 9 * k:10 * k].to(torch.int32),
                            tuple(a[live] for a in rays), t[live], tri[live], u[live], v[live], any_hit)
        for dst, src in zip((t, tri, u, v), out):
            dst[live] = src
    if stats is not None:
        stats["touched"] = int(touched.sum())
    return t, tri, u, v


def phase2_stream(cand, entry, stream_block, ox, oy, oz, dx, dy, dz, tm, k: int, any_hit: bool):
    """Phase 2 as one early-ending candidate loop per block.  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/phase2_stream.cu`` or
    raise."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    dev = ox.device
    if dev.type == "cpu":
        return phase2_stream_reference(cand, entry, stream_block, *rays, k, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"phase2_stream: unsupported device {dev}")
    _check_phase2_inputs("phase2_stream", cand, entry, rays, dev)
    ok = (stream_block.dtype == torch.float32 and stream_block.dim() == 3
          and stream_block.shape[1] % RB_SUB == 0 and stream_block.shape[2] == RB_LANE
          and 0 < k <= 128 and 10 * k + 6 <= stream_block.shape[1] * RB_LANE
          and stream_block.device == dev and stream_block.is_contiguous()
          and stream_block.data_ptr() % 16 == 0)  # the kernel's copy engine moves 16 bytes at a time
    if not ok:
        raise ValueError("phase2_stream: stream_block does not match the kernel's dtype, shape, device, layout or "
                         "16-byte alignment")
    return _launch_phase2("phase2_stream", (stream_block,), cand, entry, rays,
                          (cand.shape[0], cand.shape[1], k, stream_block.shape[1] * RB_LANE, any_hit))


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def _padded_rays(origin: Vec3, direction: Vec3, t_max):
    """Ray arrays padded to whole blocks; pad rays carry t_max = 0 and
    cannot hit."""
    n = origin.x.shape[0]
    pad = (-n) % RB
    padded = lambda x, fill: torch.cat([x, x.new_full((pad,), fill)]) if pad else x
    return (padded(origin.x, 0.0), padded(origin.y, 0.0), padded(origin.z, 0.0),
            padded(direction.x, 1.0), padded(direction.y, 0.0), padded(direction.z, 0.0),
            padded(per_ray(origin, t_max), 0.0))


def _rblk(x):
    return x.reshape(-1, RB_SUB, RB_LANE).contiguous()


def _pallas_closest_hit_padded(cs: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kb: int):
    """Padded (B*RB,) ray arrays -> (t, tri, u, v, entry): dense candidates,
    then the grid kernel."""
    n = ox.shape[0]
    cand, entry = _block_candidates(cs, Vec3(ox, oy, oz), Vec3(dx, dy, dz), tm, kb)
    out = phase2_grid(cand.contiguous(), entry.contiguous(), cs.tri_block, cs.tri_id,
                      *(_rblk(a) for a in (ox, oy, oz, dx, dy, dz, tm)))
    return tuple(a.reshape(n) for a in out) + (entry,)


@torch.no_grad()
def pallas_cluster_closest_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kb: int = 48):
    """Closest hit over the cluster set through the grid kernel.  Returns
    (t, tri_id, u, v, overflow_mask); t == BIG and tri_id == -1 on a miss.
    ``kb`` is the per-block candidate budget; ``overflow_mask`` reports rays
    whose result it could have truncated."""
    n = origin.x.shape[0]
    kb = min(kb, cs.num_clusters)
    t, tri, u, v, entry = _pallas_closest_hit_padded(cs, *_padded_rays(origin, direction, t_max), kb)
    t, tri, u, v = t[:n], tri[:n], u[:n], v[:n]
    # the farthest candidate of the ray's block was still closer than its hit
    last = entry[:, kb - 1].repeat_interleave(RB)[:n]
    overflow = torch.isfinite(last) & (last < t)
    return torch.where(tri < 0, BIG, t), tri, u, v, overflow


@torch.no_grad()
def pallas_cluster_any_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kb: int = 48):
    """Any-hit occlusion query through the closest-hit kernel (t < limit)."""
    limit = per_ray(origin, t_max)
    t, tri, _, _, _ = pallas_cluster_closest_hit(cs, origin, direction, limit, kb)
    return (tri >= 0) & (t < limit)


def pallas_available(device=None) -> bool:
    """True where the block-candidate kernels themselves run: on a CUDA
    device.  Elsewhere the entry points take the kernels' plain versions."""
    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available()


def _sorted_candidates(cs: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kb: int):
    """The sorted front end's inputs to phase 2: padded rays sorted by
    (octant, Morton cell), pads last, and their BFS candidate table.
    Returns (perm, cand, entry, block overflow, the seven ray blocks)."""
    keys = _ray_sort_keys(cs, Vec3(ox, oy, oz), Vec3(dx, dy, dz))
    keys = torch.where(tm > 0.0, keys, 0x7FFFFFFF)
    perm = torch.sort(keys, stable=True).indices
    ox, oy, oz, dx, dy, dz, tm = (a[perm] for a in (ox, oy, oz, dx, dy, dz, tm))
    cand, entry, bfs_overflow = _block_candidates_bfs(cs, Vec3(ox, oy, oz), Vec3(dx, dy, dz), tm, kb)
    return (perm, cand.contiguous(), entry.contiguous(), bfs_overflow,
            tuple(_rblk(a) for a in (ox, oy, oz, dx, dy, dz, tm)))


def _sorted_trace(cs: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kb: int, phase2):
    """Sorted rays and BFS candidates, ``phase2(cand, entry, ray blocks)``,
    results scattered back to caller order."""
    n = ox.shape[0]
    perm, cand, entry, bfs_overflow, rays = _sorted_candidates(cs, ox, oy, oz, dx, dy, dz, tm, kb)
    out = phase2(cand, entry, *rays)
    # overflow iff the BFS dropped candidate nodes for the ray's block
    overflow = bfs_overflow.repeat_interleave(RB)
    back = lambda a: torch.empty_like(a).index_copy_(0, perm, a)
    return tuple(back(a.reshape(n)) for a in out) + (back(overflow),)


def _pallas_stream_trace(cs: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kb: int, any_hit: bool):
    """Sorted rays + BFS candidates + the stream kernel on padded arrays."""
    k = cs.tris_per_cluster
    return _sorted_trace(cs, ox, oy, oz, dx, dy, dz, tm, kb,
                         lambda cand, entry, *rays: phase2_stream(cand, entry, cs.stream_block, *rays, k, any_hit))


@torch.no_grad()
def _pallas_sorted_closest_hit(cs: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kb: int):
    """Sorted rays + BFS candidates + the grid kernel on padded arrays (the
    stream kernel's predecessor; kept as the reference keeps it)."""
    return _sorted_trace(cs, ox, oy, oz, dx, dy, dz, tm, kb,
                         lambda cand, entry, *rays: phase2_grid(cand, entry, cs.tri_block, cs.tri_id, *rays))


def _pad_and_trace(cs, origin, direction, t_max, kb, any_hit):
    n = origin.x.shape[0]
    out = _pallas_stream_trace(cs, *_padded_rays(origin, direction, t_max), kb, any_hit)
    return tuple(a[:n] for a in out)


@torch.no_grad()
def pallas_sorted_closest_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kb: int = 256):
    """Mesh closest hit of the ``sorted-pallas`` mode: octant + Morton ray
    sort, per-block BFS candidates over the cluster tree, the stream kernel,
    unsort.  Same contract as :func:`pallas_cluster_closest_hit`."""
    t, tri, u, v, overflow = _pad_and_trace(cs, origin, direction, t_max, kb, False)
    return torch.where(tri < 0, BIG, t), tri, u, v, overflow


@torch.no_grad()
def pallas_sorted_any_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kb: int = 256):
    """Any-hit occlusion through the stream kernel's park-at-zero mode.
    Returns (occluded, overflow): shadow rays whose block's BFS truncated
    are flagged, since they may miss occluders."""
    _, tri, _, _, overflow = _pad_and_trace(cs, origin, direction, t_max, kb, True)
    return tri >= 0, overflow
