"""Correctness and timing checks of the PyTorch/CUDA port's block-candidate
traversal (counterpart of ``tools/check_pallas.py`` and of the ``cluster``,
``pallas``, ``sorted`` and ``wave2`` rows of ``tools/traversal_bench.py``).

    python tools/torch_check_traverse.py [n_tris] [n_rays]

Runs on the CUDA device when there is one (the kernels), else on the CPU at
a small size (the kernels' plain versions).  Imports torch, numpy and the
port only.  ``chip_smoke.py`` calls ``check_kernels`` and ``check_engines``
as two of its phases.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytracer_tpu_torch.math.vec import Vec3  # noqa: E402
from raytracer_tpu_torch.ops import pallas_traverse as pt  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.ops.cluster_traverse import cluster_any_hit, cluster_closest_hit  # noqa: E402

BIGF = 3.0e38
# published peaks of one NVIDIA H100 SXM: HBM bytes/s, float32 operations/s
# outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
# float operations of one Möller-Trumbore test as the kernels spell it
# (csrc/mt_test.cuh, csrc/wave2_mt.cu): p = d x e2 (9), det (5), |det| > eps
# (2), select + divide (2), tvec (3), u (6), q = tvec x e1 (9), v (6), t (6),
# the seven tests of `hit` with their one sum (7)
MT_OPS = 55
# one slab test of a ray against a box: 6 sub, 6 mul, 10 min/max, the clamp at
# 0 and two compares
BOX_OPS = 25


def coherent_rays(n, spread=4.0):
    """Camera-like: common origin, directions in a frustum toward the mesh."""
    w = int(np.sqrt(n))
    xs = (np.arange(n) % w) / w - 0.5
    ys = (np.arange(n) // w) / w - 0.5
    o = np.tile(np.array([[0.0, 0.0, -3 * spread]], np.float32), (n, 1))
    d = np.stack([xs * 0.8, ys * 0.8, np.ones(n)], axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def incoherent_rays(n, rng, spread=4.0):
    """Bounce-like: random origins inside the mesh volume, random dirs."""
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def tie_case(k, seed, n_supers=3, n_chunks=8):
    """Hand-built inputs of ``mt_chunks`` that force ties: numpy arrays
    (block_cluster (B2,), super_geom (Cs, 8k, 16), super_sbox (Cs, 8, 8),
    seven pair arrays (B2, 8, 128)).

    Every super holds 8 well-separated subs of ``k`` random triangles (the
    last row of each sub is padding, tri id -1) with ids in random order.
    Some triangles are copied under another id, lower in one super and
    higher in the next: into another slot of the same sub, into the same
    slot of another sub, into another slot of another sub, into two places
    at once and, where k > 8, into the same slot of the same sub.  Rays are
    aimed at points inside triangles, half of them at copied ones, so equal
    t from different ids is the rule.  Lanes mix closest-hit limits (3e38
    and just behind the target), any-hit lanes (tl < 0) and fillers
    (tl == 0); row 5 of every chunk aims at sub 0 but for lane 17, which
    alone opens sub 7; row 6 is fillers but for 4 lanes; the chunk table
    names every super twice and the sentinel twice."""
    rng = np.random.default_rng(seed)
    cs, nrow = n_supers, 8 * k
    origin = lambda c, s: np.array([8.0 * c + 2.0 * (s & 1), 2.0 * ((s >> 1) & 1), 2.0 * (s >> 2)], np.float32)
    geom = np.zeros((cs, nrow, 16), np.float32)
    for c in range(cs):
        for s in range(8):
            rows = slice(s * k, (s + 1) * k)
            geom[c, rows, 0:3] = origin(c, s) + rng.uniform(0.0, 0.7, (k, 3))
            e1 = rng.normal(size=(k, 3))
            e2 = np.cross(e1, rng.normal(size=(k, 3)))  # at right angles to e1: no slivers
            geom[c, rows, 3:6] = e1 / np.linalg.norm(e1, axis=1, keepdims=True) * rng.uniform(0.2, 0.4, (k, 1))
            geom[c, rows, 6:9] = e2 / np.linalg.norm(e2, axis=1, keepdims=True) * rng.uniform(0.2, 0.4, (k, 1))
    geom[:, :, 9] = rng.permutation(cs * nrow).reshape(cs, nrow)
    # (sub, row in sub) of the original -> the copies
    copies = [((1, 2), [(1, 5)]), ((2, 3), [(3, 3)]), ((4, 0), [(5, 6)]), ((6, 1), [(6, 4), (7, 2)])]
    if k > 8:
        copies.append(((0, 1), [(0, 9)]))
    targets = []
    for c in range(cs):
        for gi, ((s0, j0), dests) in enumerate(copies):
            src = s0 * k + j0
            targets.append((c, src))
            for s1, j1 in dests:
                dst = s1 * k + j1
                ids = sorted((geom[c, src, 9], geom[c, dst, 9]), reverse=(gi + c) % 2 == 0)
                geom[c, dst, 0:9] = geom[c, src, 0:9]
                geom[c, src, 9], geom[c, dst, 9] = ids
    geom[:, k - 1::k, 9] = -1.0  # the last row of each sub is padding
    real = geom[..., 9] >= 0
    corners = np.stack([geom[..., 0:3], geom[..., 0:3] + geom[..., 3:6], geom[..., 0:3] + geom[..., 6:9]], 2)
    sbox = np.zeros((cs, 8, 8), np.float32)
    for c in range(cs):
        for s in range(8):
            pts = corners[c, s * k:(s + 1) * k][real[c, s * k:(s + 1) * k]].reshape(-1, 3)
            sbox[c, s, 0:3], sbox[c, s, 3:6] = pts.min(0), pts.max(0)

    table = np.array(([*range(cs), cs] * 2 * n_chunks)[:n_chunks], np.int32)
    shape = (n_chunks, 8, 128)
    c_of = np.minimum(table, cs - 1)[:, None, None] * np.ones(shape, np.int64)
    row_of = rng.integers(0, nrow, shape)
    row_of[:, 5, :] = rng.integers(0, k - 1, (n_chunks, 128))  # row 5 aims at sub 0 ...
    row_of[:, 5, 17] = 7 * k  # ... but for one lane, alone in sub 7
    to_copy = rng.random(shape) < 0.5
    to_copy[:, 5, :] = False
    pick = rng.integers(0, len(copies), shape)
    row_of = np.where(to_copy, np.array([s0 * k + j0 for (s0, j0), _ in copies])[pick], row_of)
    tri = geom[c_of, row_of]
    a, b = rng.uniform(0.1, 0.4, shape + (1,)), rng.uniform(0.1, 0.4, shape + (1,))
    point = tri[..., 0:3] + a * tri[..., 3:6] + b * tri[..., 6:9]
    normal = np.cross(tri[..., 3:6], tri[..., 6:9])
    d = normal / np.linalg.norm(normal, axis=-1, keepdims=True) + rng.normal(size=shape + (3,)) * 0.4  # not grazing
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = rng.uniform(0.2, 0.5, shape)
    o = point - d * dist[..., None]
    kind = rng.random(shape)
    kind[:, 5, :] = 0.3  # row 5: closest-hit lanes that end just behind their target
    kind[:, 6, :] = 1.0  # row 6: fillers ...
    kind[:, 6, 3:120:31] = 0.1  # ... but for 4 lanes
    tl = np.select([kind < 0.25, kind < 0.5, kind < 0.8], [BIGF, dist + 0.1, -(dist + 0.1)], 0.0)
    filler = tl == 0.0
    o = np.where(filler[..., None], 0.0, o)
    d = np.where(filler[..., None], np.array([1.0, 0.0, 0.0]), d)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    pairs = [f32(o[..., i]) for i in range(3)] + [f32(d[..., i]) for i in range(3)] + [f32(tl)]
    return table, geom, sbox, pairs


def vec(a, dev):
    t = torch.as_tensor(a, device=dev)
    return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(), t[:, 2].contiguous())


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float):
    """The least time one H100 could take: the larger of the bytes over its
    memory rate and the operations over its float32 rate.  Returns
    (milliseconds, 'bytes' or 'operations')."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check(cond, msg, log=print):
    if not cond:
        raise SystemExit(f"FAIL: {msg}")
    log(f"ok: {msg}")


class plain_kernels:
    """Within the block, the entry points of ``ops/pallas_traverse.py`` call
    the kernels' plain versions instead of the kernels."""

    def __enter__(self):
        self.saved = pt.phase2_grid, pt.phase2_stream
        pt.phase2_grid = lambda *a: pt.phase2_grid_reference(*a)
        pt.phase2_stream = lambda *a: pt.phase2_stream_reference(*a)
        return self

    def __exit__(self, *exc):
        pt.phase2_grid, pt.phase2_stream = self.saved


def _blocks(o, d, tm):
    """Ray Vec3s + limits as the kernels' seven (B, 8, 128) arrays."""
    return tuple(pt._rblk(a) for a in (*o, *d, tm))


def _sorted_blocks(cs, o, d, tm, kb):
    """The sorted front end's candidate table, block overflow and ray blocks."""
    _, cand, entry, overflow, rays = pt._sorted_candidates(cs, *o, *d, tm, kb)
    return cand, entry, overflow, rays


def phase2_tie_case(k, seed, b=3, kb=6, n_clusters=8, giant=False):
    """Hand-built inputs of the two phase-2 kernels that force ties and edge
    cases: a dict of numpy arrays (tri_block (C, 9k), tri_id (C, k), box_min /
    box_max (C, 3), cand / entry (b, kb), rays: seven (b, 8, 128)).

    ``n_clusters`` clusters of ``k`` random triangles sit 4 apart along x,
    ids in random order.  In every cluster slot 1 is copied into slot 5 (equal
    t in two slots of one cluster; the lower id first in every other
    cluster) and slot 2 into slot 3 of the NEXT cluster (equal t in two
    candidates: the earlier candidate wins), and the last slot keeps its
    triangle but carries id -1 (a pad slot that rays are aimed at and must
    not hit).  A block's candidates start with two neighbouring clusters and
    go on at random, repeats allowed; every ray is aimed at a point inside a
    triangle of one of its block's candidates, half of them at copied ones,
    so any-hit lanes find their first hit in any slot.  Limits mix 3e38 and
    just behind the target; even blocks keep their 3e38 rays (their loop never
    ends early), odd blocks end just behind every target (their max t falls
    and the entry test bites).  Pad rays (tm = 0) fill the end of row 7 and a
    few lanes elsewhere.  ``entry`` is the block-min slab distance of the
    candidate's box (+inf where no ray reaches it), in table order, NOT
    sorted; then block 0 gets a +inf slot three from the end (the stream loop
    ends there, the grid loop skips it), the last block (b >= 2) finite limits and
    entry[-1, 0] = 1e30 (its stream loop ends at j = 0), the one before it
    (b >= 3) all entries +inf.  With b >= 4 and kb >= 3, block 1 aims every
    ray at a real triangle of its first candidate and ends it 0.1 behind, so
    the max of t falls from about 0.6 to about 0.5 in step 0; its entry[1, 1]
    = 0.55 is live before that step and dead after it (a kernel that fetched
    it ahead must drop it) and entry[1, 2] = 0 stays live for the grid loop.
    cand holds valid ids in every slot.

    ``giant`` puts a triangle with edges (1e30, 0, 0) and (0, 1e8, 0) into
    slot 0 of block 0's first candidate and aims lanes 0-7 of block 0 at it
    along +z: its determinant is -1e38, beyond 2^125, so its reciprocal is a
    denormal that only the IEEE division gives, and the rays hit at t = 1
    with u = v = 0.3."""
    rng = np.random.default_rng(seed)
    c = n_clusters
    geom = np.zeros((c, k, 9), np.float32)
    for ci in range(c):
        geom[ci, :, 0:3] = np.array([4.0 * ci, 0.0, 0.0], np.float32) + rng.uniform(0.0, 0.7, (k, 3))
        e1 = rng.normal(size=(k, 3))
        e2 = np.cross(e1, rng.normal(size=(k, 3)))  # at right angles to e1: no slivers
        geom[ci, :, 3:6] = e1 / np.linalg.norm(e1, axis=1, keepdims=True) * rng.uniform(0.2, 0.4, (k, 1))
        geom[ci, :, 6:9] = e2 / np.linalg.norm(e2, axis=1, keepdims=True) * rng.uniform(0.2, 0.4, (k, 1))
    ids = rng.permutation(c * k).reshape(c, k).astype(np.int32)
    for ci in range(c):
        geom[ci, 5] = geom[ci, 1]
        lo, hi = sorted((ids[ci, 1], ids[ci, 5]))
        ids[ci, 1], ids[ci, 5] = (lo, hi) if ci % 2 == 0 else (hi, lo)
    src = geom[:, 2].copy()
    for ci in range(c):
        geom[(ci + 1) % c, 3] = src[ci]
    ids[:, k - 1] = -1
    corners = np.stack([geom[..., 0:3], geom[..., 0:3] + geom[..., 3:6], geom[..., 0:3] + geom[..., 6:9]], 2)
    real = (ids >= 0)[..., None, None]
    box_min = np.where(real, corners, np.inf).min(axis=(1, 2)).astype(np.float32)
    box_max = np.where(real, corners, -np.inf).max(axis=(1, 2)).astype(np.float32)

    first = rng.integers(0, c, b)
    cand = rng.integers(0, c, (b, kb)).astype(np.int32)
    cand[:, 0] = first
    if kb > 1:
        cand[:, 1] = (first + 1) % c
    shape = (b, 8, 128)
    col = rng.integers(0, kb, shape)
    cl = cand[np.arange(b)[:, None, None], col]
    slot = rng.integers(0, k, shape)
    copied = np.array([1, 5, 2, 3, k - 1])
    slot = np.where(rng.random(shape) < 0.5, copied[rng.integers(0, copied.size, shape)], slot)
    falling = b >= 4 and kb >= 3  # block 1: every ray hits in step 0
    if falling:
        cl[1] = cand[1, 0]
        slot[1] = rng.integers(0, k - 1, shape[1:])
    tri = geom[cl, slot]
    a, bb = rng.uniform(0.1, 0.4, shape + (1,)), rng.uniform(0.1, 0.4, shape + (1,))
    point = tri[..., 0:3] + a * tri[..., 3:6] + bb * tri[..., 6:9]
    normal = np.cross(tri[..., 3:6], tri[..., 6:9])
    d = normal / np.linalg.norm(normal, axis=-1, keepdims=True) + rng.normal(size=shape + (3,)) * 0.4  # not grazing
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = rng.uniform(0.2, 0.5, shape)
    o = point - d * dist[..., None]
    tm = np.where(rng.random(shape) < 0.5, BIGF, dist + 0.1)
    tm[1::2] = (dist + 0.1)[1::2]
    if b >= 2:
        tm[-1] = (dist + 0.1)[-1]
    pad = rng.random(shape) < 0.03
    pad[:, 7, 64:] = True
    if giant:
        geom[cand[0, 0], 0] = [0.0, 0.0, 50.0, 1e30, 0.0, 0.0, 0.0, 1e8, 0.0]
        o[0, 0, :8], d[0, 0, :8] = [3e29, 3e7, 49.0], [0.0, 0.0, 1.0]
        tm[0, 0, :8], pad[0, 0, :8] = BIGF, False
    tm = np.where(pad, 0.0, tm).astype(np.float32)
    o = np.where(pad[..., None], 0.0, o).astype(np.float32)
    d = np.where(pad[..., None], np.array([1.0, 0.0, 0.0]), d).astype(np.float32)

    # block-min slab distance of each candidate's box, float64 on the host: a hand-made table, not a stage under test
    inv = 1.0 / np.where(np.abs(d) > 1e-12, d, np.where(d >= 0, 1e-12, -1e-12)).astype(np.float64)
    entry = np.full((b, kb), np.inf, np.float32)
    for j in range(kb):
        t1 = (box_min[cand[:, j]][:, None, None, :] - o) * inv
        t2 = (box_max[cand[:, j]][:, None, None, :] - o) * inv
        tmin, tmax = np.minimum(t1, t2).max(-1), np.maximum(t1, t2).min(-1)
        hit = (tmax >= np.maximum(tmin, 0.0)) & (tmin < tm) & (tm > 0.0)
        entry[:, j] = np.where(hit, np.maximum(tmin, 0.0), np.inf).min(axis=(1, 2))
    if kb >= 3:
        entry[0, max(kb - 3, 1)] = np.inf
    if b >= 2:
        entry[-1, 0] = 1e30
    if b >= 3:
        entry[-2] = np.inf
    if falling:
        entry[1, 1], entry[1, 2] = 0.55, 0.0
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    rays = [f32(o[..., i]) for i in range(3)] + [f32(d[..., i]) for i in range(3)] + [f32(tm)]
    return {"tri_block": geom.reshape(c, k * 9), "tri_id": ids, "box_min": box_min, "box_max": box_max,
            "cand": cand, "entry": entry, "rays": rays}


# (label, arguments of phase2_tie_case): equal t within and across candidates,
# pad slots and pad rays, a block that ends at j = 0, a block of +inf entries,
# kb = 1, one block, odd block counts, K = 8 / 16 / 64 / 128, a row longer
# than the kernels' staged chunk of 256 entries, and a determinant beyond the
# range of the kernels' fast reciprocal
PHASE2_TIE_CASES = (
    ("ties K=8 B=3 kb=6", dict(k=8, seed=0, b=3, kb=6)),
    ("ties K=16 B=5 kb=12", dict(k=16, seed=1, b=5, kb=12)),
    ("ties K=8 B=1 kb=1", dict(k=8, seed=2, b=1, kb=1)),
    ("ties K=128 B=2 kb=4", dict(k=128, seed=3, b=2, kb=4)),
    ("ties K=64 B=7 kb=9", dict(k=64, seed=4, b=7, kb=9)),
    ("ties K=8 B=3 kb=300", dict(k=8, seed=5, b=3, kb=300)),
    ("giant triangle K=8 B=2 kb=3", dict(k=8, seed=6, b=2, kb=3, giant=True)),
)


def phase2_case_tensors(case, dev):
    """A ``phase2_tie_case`` as the wrappers take it: (cand, entry, tri_block,
    tri_id, stream_block, the seven ray blocks)."""
    from raytracer_tpu_torch.scene.clusters import _pack_stream_blocks

    stream = _pack_stream_blocks(case["tri_block"], case["tri_id"], case["box_min"], case["box_max"])
    to = lambda a: torch.as_tensor(a, device=dev)
    return (to(case["cand"]), to(case["entry"]), to(case["tri_block"]), to(case["tri_id"]), to(stream),
            tuple(to(a) for a in case["rays"]))


def _ray_bytes(b):  # 7 inputs read once, 4 outputs written once
    return b * pt.RB * (7 + 4) * 4


def _grid_case(label, cand, entry, tri_block, tri_id, rays, **flags):
    b, kb = cand.shape
    k = tri_id.shape[1]
    return dict(
        kernel="phase2_grid", label=f"phase2_grid {label.split(' B=')[0]} kb={kb} B={b}", n_rays=b * pt.RB,
        run=lambda: pt.phase2_grid(cand, entry, tri_block, tri_id, *rays),
        plain=lambda s: pt.phase2_grid_reference(cand, entry, tri_block, tri_id, *rays, stats=s),
        bytes_ops=lambda s: (_ray_bytes(b) + b * kb * 8 + s["touched"] * k * 10 * 4, s["visits"] * pt.RB * k * MT_OPS),
        **flags)


def _stream_case(label, cand, entry, stream_block, k, any_hit, rays, **flags):
    b, kb = cand.shape
    return dict(
        kernel="phase2_stream", label=f"phase2_stream {'any-hit' if any_hit else 'closest'} {label.split(' B=')[0]} kb={kb} B={b}",
        n_rays=b * pt.RB,
        run=lambda: pt.phase2_stream(cand, entry, stream_block, *rays, k, any_hit),
        plain=lambda s: pt.phase2_stream_reference(cand, entry, stream_block, *rays, k, any_hit, stats=s),
        bytes_ops=lambda s: (_ray_bytes(b) + s["steps"] * 8 + s["touched"] * (10 * k + 6) * 4,
                             s["visits"] * pt.RB * k * MT_OPS + s["steps"] * pt.RB * BOX_OPS),
        **flags)


def _mesh_cases(cs, o, d, label, dev, row=False, timed=True):
    """The four launch sites on one ray set against ``cs``: the grid kernel
    on dense (kb=48) and BFS (kb=256) candidates, the stream kernel on BFS
    candidates, closest-hit (limit 3e38) and any-hit (limit 20, which reaches
    the mesh from the camera)."""
    o, d = vec(o, dev), vec(d, dev)
    n = o.x.shape[0]
    k = cs.tris_per_cluster
    big = torch.full((n,), BIGF, device=dev)
    lim = torch.full((n,), 20.0, device=dev)
    cand, entry = pt._block_candidates(cs, o, d, big, min(48, cs.num_clusters))
    yield _grid_case(f"dense {label}", cand.contiguous(), entry.contiguous(), cs.tri_block, cs.tri_id,
                     _blocks(o, d, big), timed=timed, row=row)
    cand, entry, overflow, rays = _sorted_blocks(cs, o, d, big, 256)
    yield _grid_case(f"bfs {label}", cand, entry, cs.tri_block, cs.tri_id, rays, timed=timed,
                     note=f"BFS overflow on {int(overflow.sum())} of {n // pt.RB} blocks")
    for any_hit, tm in ((False, big), (True, lim)):
        cand, entry, _, rays = _sorted_blocks(cs, o, d, tm, 256)
        yield _stream_case(label, cand, entry, cs.stream_block, k, any_hit, rays, timed=timed, row=row and not any_hit)


def phase2_cases(cs, dev, n_coherent=262_144, n_incoherent=65_536):
    """Every case the two phase-2 kernels are held to, one dict each
    (``kernel``, ``label``, ``run``, ``plain(stats)``, ``bytes_ops(stats)``,
    ``n_rays``, ``timed``, ``row``): the path's shapes against ``cs`` (timed:
    coherent camera rays and one incoherent window), then untimed the
    hand-built tie and edge cases and mixed windows against K = 8 and K = 128
    cluster sets of a 20k-triangle mesh."""
    import bench_mesh
    from raytracer_tpu_torch.scene.clusters import build_clusters

    rng = np.random.default_rng(7)
    yield from _mesh_cases(cs, *coherent_rays(n_coherent), "coherent", dev, row=True)
    yield from _mesh_cases(cs, *incoherent_rays(n_incoherent, rng), "incoherent", dev)
    for label, kwargs in PHASE2_TIE_CASES:
        cand, entry, tri_block, tri_id, stream_block, rays = phase2_case_tensors(phase2_tie_case(**kwargs), dev)
        yield _grid_case(label, cand, entry, tri_block, tri_id, rays, timed=False)
        for any_hit in (False, True):
            yield _stream_case(label, cand, entry, stream_block, kwargs["k"], any_hit, rays, timed=False)
    verts, faces = bench_mesh.make_mesh(20_000)
    tri = verts[faces].astype(np.float32)
    n_small = min(n_incoherent, 8192)
    oc, dc = coherent_rays(n_small // 2)
    oi, di = incoherent_rays(n_small // 2, rng)
    o, d = np.concatenate([oc, oi]), np.concatenate([dc, di])
    for sk in (8, 128):
        small = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], k=sk, device=dev)
        yield from _mesh_cases(small, o, d, f"mesh20k K={sk} mixed", dev, timed=False)


def hold_case(case, log=print):
    """One case's kernel against its plain version: bit-equal or exit.
    Prints the spread of steps over the ray blocks, the number that explains
    the kernel's tail.  Returns (largest absolute difference, the plain
    version's counts)."""
    stats = {}
    want = case["plain"](stats)
    got = case["run"]()
    if got[0].device.type == "cuda":
        torch.cuda.synchronize()
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    label = case["label"]
    log(f"kernel vs plain [{label}]: max_abs_diff={err} tri_mismatches={int((got[1] != want[1]).sum())} "
        f"hits={int((got[1] >= 0).sum())} of {case['n_rays']} rays; steps={stats.get('steps', stats['visits'])} "
        f"visits that ran the triangle loop={stats['visits']} clusters touched={stats['touched']}"
        + (f"; {case['note']}" if case.get("note") else ""))
    spread = lambda x: f"mean {float(x.double().mean()):.2f}, max {int(x.max())}"
    log(f"per ray block [{label}]: " + (f"steps {spread(stats['block_steps'])}; " if "block_steps" in stats else "")
        + f"steps that ran the triangle loop {spread(stats['block_visits'])}")
    check(all(torch.equal(g, w) for g, w in zip(got, want)), f"{label}: kernel equals its plain version bit for bit", log)
    return err, stats


def time_case(case, stats, log=print, reps=20, plain_reps=5):
    """Median times of one case's kernel and plain version beside its bound
    from the steps the plain version counted."""
    ms = cuda_ms(case["run"], reps=reps)
    plain_ms = cuda_ms(lambda: case["plain"](None), reps=plain_reps, warmup=1)
    n_bytes, n_ops = case["bytes_ops"](stats)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    log(f"time [{case['label']}]: kernel {ms:.4f} ms (median of {reps}), plain {plain_ms:.4f} ms (median of "
        f"{plain_reps}), bound {b_ms:.6f} ms by {b_by} ({n_bytes:.0f} bytes, {n_ops:.0f} operations); the same "
        f"operations without fused multiply-adds, one instruction each: {2 * n_ops / H100_F32_OPS_PER_S * 1e3:.6f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def active_clusters(log=print, k=64):
    """Print how many ray blocks (thread-block clusters) of each phase-2
    kernel the card holds at once with one and with two lanes a ray, as the
    occupancy calculator says: the numbers the launch functions pick the
    lanes per ray by."""
    import ctypes

    from raytracer_tpu_torch.ops.cuda_build import kernel_function

    grid_fn = kernel_function("phase2_grid", "phase2_grid_max_active_clusters", [ctypes.c_int] * 2)
    stream_fn = kernel_function("phase2_stream", "phase2_stream_max_active_clusters", [ctypes.c_int] * 3)
    fits = {"phase2_grid": [grid_fn(k, s) for s in (1, 2)],
            "phase2_stream closest": [stream_fn(k, 0, s) for s in (1, 2)],
            "phase2_stream any-hit": [stream_fn(k, 1, s) for s in (1, 2)]}
    log(f"cudaOccupancyMaxActiveClusters at K={k}, 8 thread blocks a cluster, with 1 / 2 lanes a ray (128 / 256 "
        "threads a block; a negative number is a CUDA error): "
        + ", ".join(f"{name} {a} / {b}" for name, (a, b) in fits.items()))
    check(all(min(f) > 0 for f in fits.values()), "the card holds at least one cluster of each phase-2 kernel", log)


def check_kernels(cs, dev, log=print, reps=20, plain_reps=20, n_coherent=262_144, n_incoherent=65_536):
    """Each of the two phase-2 kernels against its plain version on every
    case of ``phase2_cases``: bit-equal or exit; the cases at the path's
    shapes are timed and the visits give their bound.  Returns the two
    kernels' table rows: the coherent closest-hit case's times, the largest
    error of all cases."""
    rows = {
        "phase2_grid": {"name": "phase2_grid", "route": "cuda", "source": "raytracer_tpu_torch/csrc/phase2_grid.cu",
                        "replaces": "raytracer_tpu/ops/pallas_traverse.py:120"},
        "phase2_stream": {"name": "phase2_stream", "route": "cuda",
                          "source": "raytracer_tpu_torch/csrc/phase2_stream.cu",
                          "replaces": "raytracer_tpu/ops/pallas_traverse.py:478"},
    }
    worst = {name: 0.0 for name in rows}
    active_clusters(log, cs.tris_per_cluster)
    for case in phase2_cases(cs, dev, n_coherent, n_incoherent):
        err, stats = hold_case(case, log)
        worst[case["kernel"]] = max(worst[case["kernel"]], err)
        if case["timed"]:
            res = time_case(case, stats, log, reps, plain_reps)
            if case.get("row"):
                rows[case["kernel"]].update(res)
    for name, row in rows.items():
        row["max_abs_err"] = worst[name]
        row["library_ms"] = None  # no single PyTorch call computes this function
        row["launches"] = 0
    return rows


def _window_chunks(cs, o, d, tl, dev):
    """One traversal window as ``mt_chunks`` sees it: the engine's candidate
    extraction (kc = 16) and sort-join on (n, 3) rays with limits ``tl``."""
    ro, rd = vec(o, dev), vec(d, dev)
    tl = torch.as_tensor(tl, dtype=torch.float32, device=dev).expand(o.shape[0]).contiguous()
    cursor = torch.full_like(tl, -1, dtype=torch.int32)
    cand, _ = w2._p1_extract(cs, *ro, *rd, tl, cursor, min(w2.KC, cs.num_supers))
    join = w2._pair_join(cs, cand, *ro, *rd, tl)
    return (join.block_cluster, cs.super_geom, cs.super_sbox, *join.pairs)


def _mt_case(label, args, any_hit, log):
    """``mt_chunks`` against its twin on one input: bit-equal or exit.
    Returns (largest absolute difference, the twin's gate counts)."""
    stats = {}
    got = w2.mt_chunks(*args, any_hit=any_hit)
    want = w2.mt_chunks_reference(*args, any_hit=any_hit, stats=stats)
    if args[0].device.type == "cuda":
        torch.cuda.synchronize()
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    log(f"kernel vs twin [{label}]: chunks={args[0].shape[0]} live_chunks={stats['live_chunks']} "
        f"open (chunk, row, sub) gates={stats['open_gates']} max_abs_diff={err} "
        f"tri_mismatches={int((got[1] != want[1]).sum())} hits={int((got[1] >= 0).sum())}")
    rows = stats["row_gates"].float()
    if rows.numel():  # a row's subs are folded in order: the fullest row of a chunk sets how long the chunk takes
        log(f"gates per row [{label}]: mean {float(rows.mean()):.3f}, mean over chunks of the fullest row "
            f"{float(rows.max(1).values.mean()):.3f}, rows with all 8 open {float((rows == 8).float().mean()):.3f}")
    check(all(torch.equal(g, w) for g, w in zip(got, want)), f"wave2_mt kernel equals its twin bit for bit ({label})", log)
    return err, stats


def check_wave2_kernel(cs, dev, log=print, reps=20, plain_reps=5, n_rays=w2.SUBWAVE):
    """The wave2 Möller-Trumbore kernel against its plain twin, closest-hit
    and any-hit, bit-equal or exit: on one real window of ``n_rays``
    incoherent rays against ``cs`` (timed: the kernel's table row), on the
    hand-built tie cases (K = 8 and 16), and on windows of mixed closest,
    any-hit and idle rays against K = 8 and K = 128 cluster sets of a
    20k-triangle mesh (the shared-memory size and the loop depend on K)."""
    import bench_mesh
    from raytracer_tpu_torch.scene.clusters import build_clusters

    k = cs.tris_per_cluster
    rng = np.random.default_rng(7)
    o, d = incoherent_rays(n_rays, rng)
    row = {"name": "wave2_mt", "route": "cuda", "source": "raytracer_tpu_torch/csrc/wave2_mt.cu",
           "replaces": "raytracer_tpu/ops/wave2_traverse.py:324", "launches": 0, "library_ms": None,
           "max_abs_err": 0.0}
    for any_hit, tl_value in ((False, BIGF), (True, 4.0)):
        args = _window_chunks(cs, o, d, tl_value, dev)
        label = "any-hit" if any_hit else "closest"
        err, stats = _mt_case(f"window K={k} {label}", args, any_hit, log)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        ms = cuda_ms(lambda: w2.mt_chunks(*args, any_hit=any_hit), reps=reps)
        plain_ms = cuda_ms(lambda: w2.mt_chunks_reference(*args, any_hit=any_hit), reps=plain_reps, warmup=1)
        # each chunk's 1,024 pairs: 7 inputs + 5 outputs; each live chunk's super block read once
        n_bytes = args[0].shape[0] * w2.CHUNK * (7 + 5) * 4 + stats["live_chunks"] * (8 * k * 16 + 8 * 8) * 4
        n_ops = stats["open_gates"] * 128 * k * MT_OPS
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        log(f"time [{label}] at the window shape: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"by {b_by} ({n_bytes} bytes, {n_ops} operations); the same operations without fused "
            f"multiply-adds, one instruction each: {2 * n_ops / H100_F32_OPS_PER_S * 1e3:.6f} ms")
        if not any_hit:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    cases = []
    for tk in (8, 16):
        table, geom, sbox, pairs = tie_case(tk, seed=0)
        cases.append((f"ties K={tk}", tuple(torch.as_tensor(x, device=dev) for x in (table, geom, sbox, *pairs))))
    verts, faces = bench_mesh.make_mesh(20_000)
    tri = verts[faces].astype(np.float32)
    o, d = incoherent_rays(min(n_rays, 16_384), rng)
    u = rng.random(o.shape[0])
    tl = np.where(u < 0.3, -rng.uniform(1.0, 20.0, o.shape[0]), BIGF).astype(np.float32)
    tl[u > 0.95] = 0.0
    for sk in (8, 128):
        small = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], k=sk, device=dev)
        cases.append((f"mixed window K={sk}", _window_chunks(small, o, d, tl, dev)))
    for label, args in cases:
        for any_hit in (False, True):
            err, _ = _mt_case(f"{label} {'any-hit' if any_hit else 'closest'}", args, any_hit, log)
            row["max_abs_err"] = max(row["max_abs_err"], err)
    return row


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_engines(cs, dev, log=print, n_rays=65_536, on_card=True):
    """The five entry points of ``ops/pallas_traverse.py``, kernel path
    against plain path: equal or exit (``on_card``).  Prints, and does not
    gate on, each engine's tri agreement with the exact ``wave2_closest_hit``
    and its overflow share, and the per-ray ``cluster`` engine's, on coherent
    and incoherent rays."""
    rng = np.random.default_rng(11)
    for label, (o, d) in (("coherent", coherent_rays(n_rays)), ("incoherent", incoherent_rays(n_rays, rng))):
        o, d = vec(o, dev), vec(d, dev)
        n = o.x.shape[0]
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        exact = w2.wave2_closest_hit(cs, o, d, BIGF)
        exact_occ = w2.wave2_any_hit(cs, o, d, 4.0)[0]
        padded = pt._padded_rays(o, d, BIGF)
        engines = (
            ("pallas_cluster_closest_hit kb=48", lambda: pt.pallas_cluster_closest_hit(cs, o, d, BIGF)),
            ("pallas_sorted_closest_hit kb=256", lambda: pt.pallas_sorted_closest_hit(cs, o, d, BIGF)),
            ("_pallas_sorted_closest_hit kb=256", lambda: pt._pallas_sorted_closest_hit(cs, *padded, 256)),
            ("cluster_closest_hit kmax=32", lambda: cluster_closest_hit(cs, o, d, BIGF)),
        )
        for name, fn in engines:
            sync()
            t0 = time.perf_counter()
            got = fn()
            sync()
            dt = time.perf_counter() - t0
            agree = float((got[1][:n] == exact[1]).float().mean())
            log(f"engine [{label}] {name}: {dt * 1e3:.1f} ms for {n} rays, hit rate "
                f"{float((got[1] >= 0).float().mean()):.4f}, tri agreement with wave2 {agree:.4f}, "
                f"overflow share {float(got[4].float().mean()):.4f}")
            if on_card and "pallas" in name:
                with plain_kernels():
                    want = fn()
                check(_same(got, want), f"{name}: kernel path equals plain path ({label})", log)
        any_engines = (
            ("pallas_cluster_any_hit kb=48", lambda: (pt.pallas_cluster_any_hit(cs, o, d, 4.0),)),
            ("pallas_sorted_any_hit kb=256", lambda: pt.pallas_sorted_any_hit(cs, o, d, 4.0)),
            ("cluster_any_hit kmax=32", lambda: cluster_any_hit(cs, o, d, 4.0)),
        )
        for name, fn in any_engines:
            got = fn()
            agree = float((got[0] == exact_occ).float().mean())
            ovf = f", overflow share {float(got[1].float().mean()):.4f}" if len(got) > 1 else ""
            log(f"engine [{label}] {name}: occluded {float(got[0].float().mean()):.4f}, "
                f"agreement with wave2 {agree:.4f}{ovf}")
            if on_card and "pallas" in name:
                with plain_kernels():
                    want = fn()
                check(_same(got, want), f"{name}: kernel path equals plain path ({label})", log)


def main():
    import bench_mesh
    from raytracer_tpu_torch.scene.clusters import build_clusters

    on_card = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    n_tris = int(sys.argv[1]) if len(sys.argv) > 1 else (200_000 if on_card else 2000)
    n_rays = int(sys.argv[2]) if len(sys.argv) > 2 else (65_536 if on_card else 2048)
    print(f"device: {torch.cuda.get_device_name(0) if on_card else 'cpu (plain versions)'}  "
          f"tris~{n_tris}  rays={n_rays}")
    verts, faces = bench_mesh.make_mesh(n_tris)
    tri = verts[faces].astype(np.float32)
    cs = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], device=dev)
    print(f"clusters: {cs.num_clusters} x {cs.tris_per_cluster}")
    if on_card:
        check_wave2_kernel(cs, dev, n_rays=n_rays)
        check_kernels(cs, dev, n_coherent=4 * n_rays, n_incoherent=n_rays)
    check_engines(cs, dev, n_rays=n_rays, on_card=on_card)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
