"""Correctness and timing checks of the PyTorch/CUDA port's traversal
kernels (counterpart of ``tools/check_pallas.py`` and of the ``cluster``,
``pallas``, ``sorted``, ``wave2`` and ``bvh`` rows of
``tools/traversal_bench.py``).

    python tools/torch_check_traverse.py [cuda|cpu] [n_tris] [n_rays]

Runs on the CUDA device (the kernels; it exits when there is none), or with
``cpu`` on the CPU at a small size (the kernels' plain versions).  Imports torch, numpy and the
port only.  ``chip_smoke.py`` calls ``check_kernels``, ``check_engines``,
``check_extract_kernel``, ``check_join_kernels``, ``check_bvh_walk`` and
``bvh_against_wave2`` in its phases.
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
# bytes of one skip-link table row: a packed node row of 9 floats, a leaf row
# of 40 floats
NODE_BYTES = 36
LEAF_BYTES = 160


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


def kernel_ms(fn, name, reps=20):
    """Median device time (ms) of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn``, as the profiler records them: the kernel's own
    duration, without the host's launch latency that an event pair around
    one call takes in with it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.duration_ns() / 1e6 for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and name in e.name()]
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


class twin_engine:
    """Within the block, the wave2 engine calls the kernels' plain twins
    (extraction, join, Möller-Trumbore and select), not the kernels."""

    def __enter__(self):
        self.saved = w2.mt_chunks, w2._p1_extract, w2._pair_join, w2._select
        w2.mt_chunks, w2._p1_extract = w2.mt_chunks_reference, w2.p1_extract_reference
        w2._pair_join, w2._select = w2.pair_join_reference, w2.select_reference
        return self

    def __exit__(self, *exc):
        w2.mt_chunks, w2._p1_extract, w2._pair_join, w2._select = self.saved


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


def check_wave2_window(cs, o, d, any_tl, dev, log=print, label="window", reps=20, plain_reps=5):
    """The wave2 Möller-Trumbore kernel against its plain twin on one real
    traversal window of ``cs``: the (n, 3) rays ``o``, ``d`` as closest-hit
    rays and as any-hit rays of length ``any_tl``; bit-equal or exit, both
    timed.  Returns the closest-hit window's ``ms``, ``plain_ms``,
    ``bound_ms`` and ``bound_by``, the chunk count and the larger
    ``max_abs_err`` of the two."""
    out = {"max_abs_err": 0.0}
    for any_hit, tl_value in ((False, BIGF), (True, any_tl)):
        got = check_mt_args(_window_chunks(cs, o, d, tl_value, dev), any_hit, log, label, reps, plain_reps)
        out["max_abs_err"] = max(out["max_abs_err"], got.pop("max_abs_err"))
        if not any_hit:
            out.update(got)
    return out


def check_mt_args(args, any_hit, log=print, label="window", reps=20, plain_reps=5):
    """The wave2 Möller-Trumbore kernel against its plain twin on the
    joined chunks ``args`` (what ``mt_chunks`` takes): bit-equal or exit,
    both timed.  Returns ``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``,
    ``chunks`` and ``max_abs_err``."""
    k = args[1].shape[1] // 8
    kind = "any-hit" if any_hit else "closest"
    err, stats = _mt_case(f"{label} K={k} {kind}", args, any_hit, log)
    ms = cuda_ms(lambda: w2.mt_chunks(*args, any_hit=any_hit), reps=reps)
    plain_ms = cuda_ms(lambda: w2.mt_chunks_reference(*args, any_hit=any_hit), reps=plain_reps, warmup=1)
    # each chunk's CHUNK pairs: 7 inputs + 5 outputs; each live chunk's super block read once
    n_bytes = args[0].shape[0] * w2.CHUNK * (7 + 5) * 4 + stats["live_chunks"] * (8 * k * 16 + 8 * 8) * 4
    n_ops = stats["open_gates"] * 128 * k * MT_OPS
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    log(f"time [{label} {kind}] at the window shape ({w2.ROWS} rows a chunk): kernel {ms:.4f} ms, twin "
        f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} ({n_bytes} bytes, {n_ops} operations); the same "
        f"operations without fused multiply-adds, one instruction each: "
        f"{2 * n_ops / H100_F32_OPS_PER_S * 1e3:.6f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, chunks=int(args[0].shape[0]),
                max_abs_err=err)


def check_wave2_kernel(cs, dev, log=print, reps=20, plain_reps=5, n_rays=w2.SUBWAVE):
    """The wave2 Möller-Trumbore kernel against its plain twin, closest-hit
    and any-hit, bit-equal or exit: on one real window of ``n_rays``
    incoherent rays against ``cs`` (timed: the kernel's table row), on the
    hand-built tie cases (K = 8 and 16), and on windows of mixed closest,
    any-hit and idle rays against K = 8 and K = 128 cluster sets of a
    20k-triangle mesh (the shared-memory size and the loop depend on K)."""
    import bench_mesh
    from raytracer_tpu_torch.scene.clusters import build_clusters

    rng = np.random.default_rng(7)
    o, d = incoherent_rays(n_rays, rng)
    row = {"name": "wave2_mt", "route": "cuda", "source": "raytracer_tpu_torch/csrc/wave2_mt.cu",
           "replaces": "raytracer_tpu/ops/wave2_traverse.py:324", "launches": 0, "library_ms": None}
    window = check_wave2_window(cs, o, d, 4.0, dev, log, reps=reps, plain_reps=plain_reps)
    window.pop("chunks")
    row.update(window)

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


def extract_edge_rays(cs, n, rng):
    """(n, 3) origins and directions, limits and cursors (numpy) that reach
    the extraction's edges on the cluster set ``cs``: a quarter of the
    origins inside a super's box (at its centre or anywhere in it), the rest
    around the boxes; a quarter of the directions along an axis with the
    other two components 0, -0, +-1e-13 (below the slab inverse's 1e-12
    floor) or +-1e-12 (on it); limits closest (3e38), any-hit (negative),
    finite, or 0 (padding); cursors -1, in the middle, Cs - 1, or anywhere
    between."""
    box = cs.super_box.cpu().numpy().astype(np.float64)
    live = box[:, 0] <= box[:, 3]
    lo, hi = box[live, :3].min(0), box[live, 3:].max(0)
    pick = box[rng.integers(0, len(box), n)]
    inside = pick[:, :3] + (pick[:, 3:] - pick[:, :3]) * np.where(rng.random((n, 1)) < 0.5, 0.5, rng.random((n, 3)))
    around = lo - 0.2 * (hi - lo) + 1.4 * (hi - lo) * rng.random((n, 3))
    o = np.where(rng.random((n, 1)) < 0.25, inside, around).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    flat = rng.random(n) < 0.25
    axis = rng.integers(0, 3, n)
    small = np.array([0.0, -0.0, 1e-13, -1e-13, 1e-12, -1e-12], np.float32)
    for i in np.flatnonzero(flat):
        d[i] = small[rng.integers(0, len(small), 3)]
        d[i, axis[i]] = rng.choice([-1.0, 1.0])
    u = rng.random(n)
    tl = np.where(u < 0.5, 3.0e38, np.where(u < 0.7, -rng.uniform(0.5, 20.0, n), rng.uniform(0.1, 5.0, n)))
    tl[u > 0.9] = 0.0
    c = rng.random(n)
    cs_n = cs.num_supers
    cursor = np.where(c < 0.4, -1, np.where(c < 0.6, cs_n // 2, np.where(c < 0.7, cs_n - 1,
                                                                            rng.integers(-1, cs_n, n))))
    return o, d, tl.astype(np.float32), cursor.astype(np.int32)


def _extract_case(label, cs, o, d, tl, cursor, kc, log):
    """``_p1_extract`` (on CUDA tensors the kernel) against its plain twin on
    one input: bit-equal or exit.  Returns the twin's (cand, rem)."""
    ro, rd = vec(o, tl.device), vec(d, tl.device)
    got = w2._p1_extract(cs, *ro, *rd, tl, cursor, kc)
    want = w2.p1_extract_reference(cs, *ro, *rd, tl, cursor, kc)
    if tl.device.type == "cuda":
        torch.cuda.synchronize()
    log(f"extract vs twin [{label}]: rays={tl.shape[0]} Cs={cs.num_supers} kc={kc} "
        f"candidates={int((want[0] < cs.num_supers).sum())} rays with more={int((want[1] > 0).sum())} "
        f"cand_mismatches={int((got[0] != want[0]).sum())} rem_mismatches={int((got[1] != want[1]).sum())}")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"wave2_extract kernel equals its twin bit for bit ({label})", log)
    return want


def _time_extract(label, cs, o, d, tl, cursor, kc, log, reps, plain_reps):
    """Times ``_p1_extract`` (the kernel) and its twin on one input.  The
    bound counts the box tests these inputs need (each ray with a limit
    against each super above its cursor) at BOX_OPS operations, or the
    boxes, rays and cursors read once and the outputs written once.
    Returns the row's numbers."""
    ro, rd = vec(o, tl.device), vec(d, tl.device)
    args = (cs, *ro, *rd, tl, cursor, kc)
    call_ms = cuda_ms(lambda: w2._p1_extract(*args), reps=reps)
    ms = kernel_ms(lambda: w2._p1_extract(*args), "wave2_extract", reps=reps)
    plain_ms = cuda_ms(lambda: w2.p1_extract_reference(*args), reps=plain_reps, warmup=1)
    n, n_cs = tl.shape[0], cs.num_supers
    above = n_cs - torch.clamp(cursor.to(torch.int64) + 1, 0, n_cs)
    tests = int(torch.where(torch.abs(tl) > 0.0, above, 0).sum())
    n_bytes = n_cs * 6 * 4 + n * (8 + kc + 1) * 4
    n_ops = tests * BOX_OPS
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    log(f"time [extract {label}]: kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call between two "
        f"events), twin {plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} "
        f"({n_bytes} bytes, {tests} box tests needed of {n} x {n_cs} = {n_ops} operations; without fused "
        f"multiply-adds {2 * n_ops / H100_F32_OPS_PER_S * 1e3:.6f} ms), {100 * b_ms / ms:.2f}% of the bound")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, rays=n, box_tests=tests)


def check_extract_kernel(cs, o, d, dev, log=print, reps=20, plain_reps=5):
    """The extraction kernel (``csrc/wave2_extract.cu``) against its plain
    twin, bit-equal or exit: on the (n, 3) camera window ``o``, ``d`` of the
    cluster set ``cs`` (closest-hit rays, cursor -1, kc = 16; timed), on
    the continuation window that a real first round of it leaves (up to
    ``w2.NSUB`` unresolved rays with their cursors and limits, padded as
    ``_window_trace`` pads; timed), then untimed on ``extract_edge_rays``
    against ``cs`` and against cluster sets of a 20k-triangle mesh at K = 8
    (a Cs that is not a multiple of 32), a 500-triangle one (Cs below 16)
    and a 320k-triangle one at K = 8 (Cs above the kernel's 4,096-box tile),
    at kc 1, 4, 16 and 33 (kc = Cs where Cs is smaller).  Returns the
    kernel table's row."""
    import bench_mesh
    from raytracer_tpu_torch.scene.clusters import build_clusters

    o, d = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (o, d))
    kc = min(w2.KC, cs.num_supers)
    n = o.shape[0]
    tl = torch.full((n,), BIGF, dtype=torch.float32, device=dev)
    cursor = torch.full((n,), -1, dtype=torch.int32, device=dev)
    row = {"name": "wave2_extract", "route": "cuda", "source": "raytracer_tpu_torch/csrc/wave2_extract.cu",
           "replaces": "none (XLA: raytracer_tpu/ops/wave2_traverse.py:116-160)", "launches": 0,
           "library_ms": None}
    _extract_case("camera window", cs, o, d, tl, cursor, kc, log)
    row["windows"] = {"camera": _time_extract("camera window", cs, o, d, tl, cursor, kc, log, reps, plain_reps)}

    # a continuation window as _window_trace builds it from the first round
    ro, rd = vec(o, dev), vec(d, dev)
    t, _, _, _, cur, unres = w2._round(cs, *ro, *rd, tl, cursor, kc, any_hit=False)
    nsub = min(w2.NSUB, n)
    sel = torch.sort((~unres).to(torch.int32), stable=True).indices[:nsub]
    live = unres[sel]
    ctl = torch.where(live, t[sel], 0.0)
    log(f"continuation window: {int(live.sum())} of {n} rays unresolved after the first round, {nsub} slots")
    args = (o[sel], d[sel], ctl, cur[sel])
    _extract_case("continuation window", cs, *args, kc, log)
    row["windows"]["continuation"] = _time_extract("continuation window", cs, *args, kc, log, reps, plain_reps)
    row.update(row["windows"]["camera"])

    rng = np.random.default_rng(16)
    sets = [("camera scene", cs)]
    for n_tris, k in ((20_000, 8), (500, 8), (320_000, 8)):
        verts, faces = bench_mesh.make_mesh(n_tris)
        tri = verts[faces].astype(np.float32)
        small = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], k=k, device=dev)
        sets.append((f"{n_tris}-triangle mesh K={k}", small))
    for label, c in sets:
        eo, ed, etl, ecur = extract_edge_rays(c, 8192, rng)
        eo, ed = (torch.as_tensor(x, device=dev) for x in (eo, ed))
        etl, ecur = torch.as_tensor(etl, device=dev), torch.as_tensor(ecur, device=dev)
        for ekc in sorted({min(k, c.num_supers) for k in (1, 4, 16, 33)}):
            _extract_case(f"edge rays, {label}, Cs={c.num_supers}, kc={ekc}", c, eo, ed, etl, ecur, ekc, log)
    return row


JOIN_LAUNCHES = ("join_key", "join_runs", "join_place", "join_select")  # the kernels' names in a trace


def _join_window(label, cs, o, d, tl, cursor, log, ftb=False):
    """``_pair_join`` and ``_select`` (on CUDA tensors the kernels of
    ``csrc/wave2_join.cu``) against their twins on one window, for
    closest-hit and any-hit results of the MT kernel: every output
    bit-equal, or exit.  Returns the window's candidates, rays, extraction
    results and closest-hit MT results, for timing."""
    ro, rd = vec(o, tl.device), vec(d, tl.device)
    rays = (*ro, *rd, tl)
    kc = min(w2.KC_FTB if ftb else w2.KC, cs.num_supers)
    if ftb:
        cand, next_t, new_key = w2._p1_extract_ftb(cs, *rays, cursor, kc)
        more = dict(next_t=next_t, new_key=new_key)
    else:
        cand, remaining = w2._p1_extract(cs, *rays, cursor, kc)
        more = dict(remaining=remaining)
    got = w2._pair_join(cs, cand, *rays)
    want = w2.pair_join_reference(cs, cand, *rays)
    p = cand.numel()
    same = {"sidx": torch.equal(got.sidx, want.sidx), "fidx": torch.equal(got.fidx, want.fidx),
            "block_cluster": torch.equal(got.block_cluster, want.block_cluster),
            "pairs": all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got.pairs, want.pairs)),
            "slot_of_pair": torch.equal(want.fidx[got.slot_of_pair.long()], torch.arange(p, dtype=torch.int32,
                                                                                           device=tl.device))}
    torch.cuda.synchronize()
    log(f"join vs twin [{label}]: rays={tl.shape[0]} Cs={cs.num_supers} kc={kc} pairs real="
        f"{int((cand < cs.num_supers).sum())} of {p}, slots={got.fidx.shape[0]}, chunks={got.block_cluster.shape[0]} "
        f"live={int((got.block_cluster < cs.num_supers).sum())}; equal: {same}")
    check(all(same.values()), f"wave2_join key/runs/place kernels equal the twin bit for bit ({label})", log)
    closest = None
    for any_hit in (False, True):
        outs = w2.mt_chunks(got.block_cluster, cs.super_geom, cs.super_sbox, *got.pairs, any_hit=any_hit)
        closest = closest or outs
        a = w2._select(cs.num_supers, cand, got, outs, tl, cursor, any_hit, ftb, **more)
        b = w2.select_reference(cs.num_supers, cand, want, outs, tl, cursor, any_hit, ftb, **more)
        names = ("t", "tri", "u", "v", "cursor", "unresolved")
        diff = {k: int((_bits(x) != _bits(y)).sum()) for k, x, y in zip(names, a, b)}
        log(f"select vs twin [{label}, {'any-hit' if any_hit else 'closest'}]: hits={int((b[1] >= 0).sum())} "
            f"unresolved={int(b[5].sum())} mismatches={diff}")
        check(all(x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b)),
              f"wave2_join select kernel equals its twin bit for bit ({label}, any_hit={any_hit})", log)
    return cand, rays, more, closest


def _profile_ops(fn, reps):
    """Device operations (name, ms) of ``reps`` calls of ``fn``, as the
    profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _host_ms(fn, reps):
    """Median host milliseconds to dispatch ``fn`` (no synchronisation inside
    the timed call; the device is drained before each)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def _time_join(label, cs, cand, rays, more, outs, log, reps):
    """Each launch's device time beside its byte bound, and the round's join
    + select device and host ms with the kernels and with the twins (the
    path the port took before them).  Returns the row's numbers."""
    tl = rays[6]
    cursor = torch.full_like(tl, -1, dtype=torch.int32)
    n, kc = cand.shape
    n_cs = cs.num_supers

    def kernels():
        j = w2._pair_join(cs, cand, *rays)
        return w2._select(n_cs, cand, j, outs, tl, cursor, False, False, **more)

    def twins():
        j = w2.pair_join_reference(cs, cand, *rays)
        return w2.select_reference(n_cs, cand, j, outs, tl, cursor, False, False, **more)

    join = w2._pair_join(cs, cand, *rays)
    p = n * kc
    p_pad, d_len, b2 = join.sidx.shape[0], join.fidx.shape[0], join.block_cluster.shape[0]
    valid = int((cand < n_cs).sum())
    log2 = int(np.ceil(np.log2(p_pad + 1)))
    n_bytes = {  # each input read once, each output written once
        "join_key": p * 4 + n * 6 * 4 + n_cs * 24 + p_pad * 4,
        "sort": p_pad * 4 + p_pad * (4 + 8),
        "join_runs": (n_cs + 1) * log2 * 4 + 2 * (n_cs + 1) * 4,
        "join_place": p_pad * 8 + 2 * (n_cs + 1) * 4 + n * 7 * 4 + p_pad * 4 + d_len * 8 * 4 + b2 * 4 + p * 4,
        "join_select": p * 4 + valid * (1 + 5) * 4 + n * 3 * 4 + n * (5 * 4 + 1),
    }
    ops = _profile_ops(kernels, reps)
    by = {k: [ms for name, ms in ops if k in name] for k in JOIN_LAUNCHES}
    by["sort"] = [ms for name, ms in ops if not any(k in name for k in JOIN_LAUNCHES)]
    out = {"launches": {}, "rays": n, "pair_slots": d_len}
    for k, times in by.items():
        per_call = sum(times) / reps
        b_ms, b_by = bound_ms(n_bytes[k], 0)
        out["launches"][k] = dict(ms=per_call, bound_ms=b_ms, ops=len(times) / reps)
        log(f"time [{label}] {k}: {per_call:.4f} ms of device time a round in {len(times) / reps:.2f} operation(s), "
            f"bound {b_ms:.6f} ms by {b_by} ({n_bytes[k]} bytes), {100 * b_ms / max(per_call, 1e-9):.2f}% of it")
    twin_ops = _profile_ops(twins, reps)
    out["ms"] = sum(ms for _, ms in ops) / reps
    out["plain_ms"] = sum(ms for _, ms in twin_ops) / reps
    out["host_ms"] = _host_ms(kernels, reps)
    out["plain_host_ms"] = _host_ms(twins, reps)
    out["bound_ms"], out["bound_by"] = bound_ms(sum(n_bytes.values()), 0)
    log(f"time [{label}] join + select a round: kernels {out['ms']:.4f} ms of device time in {len(ops) / reps:.2f} "
        f"operations, {out['host_ms']:.4f} ms on the host; twins {out['plain_ms']:.4f} ms of device time in "
        f"{len(twin_ops) / reps:.2f} operations, {out['plain_host_ms']:.4f} ms on the host; bound "
        f"{out['bound_ms']:.6f} ms by bytes")
    return out


def check_join_kernels(cs, o, d, dev, log=print, reps=20):
    """The pair-placement kernels (``csrc/wave2_join.cu``: key, runs, place,
    select) against their plain twins, bit-equal or exit: on the (n, 3)
    camera window ``o``, ``d`` of the cluster set ``cs`` (closest-hit rays,
    cursor -1, kc = 16; timed), on the continuation window that a real first
    round of it leaves (timed), front to back (kc = 4) on the camera
    window, and on windows of mixed closest / any-hit / idle rays against a
    20k-triangle mesh at K = 8.  Returns the kernel table's row."""
    import bench_mesh
    from raytracer_tpu_torch.scene.clusters import build_clusters

    o, d = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (o, d))
    n = o.shape[0]
    tl = torch.full((n,), BIGF, dtype=torch.float32, device=dev)
    cursor = torch.full((n,), -1, dtype=torch.int32, device=dev)
    row = {"name": "wave2_join", "route": "cuda", "source": "raytracer_tpu_torch/csrc/wave2_join.cu",
           "replaces": "none (XLA: the sorts, cummax and cumsum of raytracer_tpu/ops/wave2_traverse.py::_round)",
           "launches": 0, "library_ms": None, "max_abs_err": 0.0}
    camera = _join_window("camera window", cs, o, d, tl, cursor, log)
    row["windows"] = {"camera": _time_join("camera window", cs, *camera, log, reps)}

    # a continuation window as _window_trace builds it from the first round
    ro, rd = vec(o, dev), vec(d, dev)
    t, _, _, _, cur, unres = w2._round(cs, *ro, *rd, tl, cursor, min(w2.KC, cs.num_supers), any_hit=False)
    sel = torch.sort((~unres).to(torch.int32), stable=True).indices[:min(w2.NSUB, n)]
    live = unres[sel]
    log(f"continuation window: {int(live.sum())} of {n} rays unresolved after the first round, {sel.shape[0]} slots")
    cont = _join_window("continuation window", cs, o[sel], d[sel], torch.where(live, t[sel], 0.0), cur[sel], log)
    row["windows"]["continuation"] = _time_join("continuation window", cs, *cont, log, reps)
    row.update({k: row["windows"]["camera"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})

    _join_window("camera window, front to back", cs, o, d, tl, cursor, log, ftb=True)
    verts, faces = bench_mesh.make_mesh(20_000)
    tri = verts[faces].astype(np.float32)
    small = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], k=8, device=dev)
    rng = np.random.default_rng(18)
    mo, md = incoherent_rays(10_000, rng)
    u = rng.random(mo.shape[0])
    mtl = torch.as_tensor(np.where(u < 0.9, np.where(u < 0.3, -rng.uniform(1.0, 20.0, mo.shape[0]), BIGF), 0.0),
                          dtype=torch.float32, device=dev)
    mcur = torch.full_like(mtl, -1, dtype=torch.int32)
    for ftb in (False, True):
        _join_window(f"mixed window, 20k-triangle mesh K=8, ftb={ftb}", small, mo, md, mtl, mcur, log, ftb=ftb)
    return row


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def check_bvh_walk(bvh, o, d, any_tl, dev, log=print, label="window", reps=20):
    """The skip-link walk's kernel (``bvh_walk``) against its plain twin on
    the (n, 3) rays ``o``, ``d``, as closest-hit rays and as any-hit rays
    of length ``any_tl``: every output and each ray's step count bit-equal,
    or exit.  On the card the kernel is timed over ``reps`` calls (CUDA
    events) and the twin once.  The twin's work gives the bound: by bytes,
    each ray read and written once and each DISTINCT node and leaf row the
    walk reads fetched once (the rays share most rows: the root is read by
    every ray); by operations, a slab test per step and 4 Möller-Trumbore
    tests per leaf visit.  The rows read per step are printed too, as the
    traffic the caches serve (``l2_bytes``).  Returns {"closest": {...},
    "any-hit": {...}}, each with ``ms``, ``plain_ms``, ``bound_ms``,
    ``bound_by``, ``bound_no_fma_ms``, ``max_abs_err``, ``visits``,
    ``leaf_visits``, ``rows``, ``l2_bytes``, ``max_steps`` and ``capped``
    (rays that took the whole step budget)."""
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    on_card = dev.type == "cuda"
    ro, rd = vec(o, dev), vec(d, dev)
    n = o.shape[0]
    budget = bt.walk_budget(bvh.num_nodes)
    out = {}
    for any_hit, tl_value in ((False, BIGF), (True, any_tl)):
        kind = "any-hit" if any_hit else "closest"
        tm = torch.full((n,), tl_value, dtype=torch.float32, device=dev)
        got = bt.bvh_walk(bvh, ro, rd, tm, any_hit, count_steps=True)
        t0 = time.perf_counter()
        want = bt.bvh_walk_reference(bvh, ro, rd, tm, any_hit, count_steps=True)
        if on_card:
            torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        fields = ("occluded", "steps") if any_hit else ("t", "tri", "u", "v", "steps")
        pairs = [(getattr(got, f), getattr(want, f)) for f in fields]
        err = 0.0 if any_hit else float((got.t - want.t).double().abs().max())
        steps = want.steps
        visits, leaf_visits = int(steps.sum()), int(want.leaf_visits.sum())
        rows = (int(want.nodes_read.sum()), int(want.leaves_read.sum()))
        hits = int(want.occluded.sum()) if any_hit else int((want.tri >= 0).sum())
        log(f"bvh_walk vs twin [{label} {kind}]: {n} rays, {bvh.num_nodes} nodes, budget {budget} steps; "
            f"{'occluded' if any_hit else 'hits'} {hits}; steps a ray mean {visits / n:.2f}, max {int(steps.max())}, "
            f"rays at the budget {int((steps >= budget).sum())}; leaf visits a ray {leaf_visits / n:.2f}; "
            f"distinct rows read: {rows[0]} of {bvh.packed_nodes.shape[0]} node rows, {rows[1]} of "
            f"{bvh.leaf_geom.shape[0]} leaf rows; max_abs_diff {err}; mismatches "
            f"{sum(int((_bits(g) != _bits(w)).sum()) for g, w in pairs)}")
        check(all(torch.equal(_bits(g), _bits(w)) for g, w in pairs),
              f"bvh_walk kernel equals its twin bit for bit, steps included ({label} {kind})", log)
        ms = cuda_ms(lambda: bt.bvh_walk(bvh, ro, rd, tm, any_hit), reps=reps) if on_card else None
        ray_bytes = n * 7 * 4 + n * (4 if any_hit else 16)
        n_bytes = rows[0] * NODE_BYTES + rows[1] * LEAF_BYTES + ray_bytes
        l2_bytes = visits * NODE_BYTES + leaf_visits * LEAF_BYTES + ray_bytes
        n_ops = visits * BOX_OPS + leaf_visits * 4 * MT_OPS
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        no_fma_ms = 2 * n_ops / H100_F32_OPS_PER_S * 1e3
        log(f"time [{label} {kind}]: kernel {'not measured (no card)' if ms is None else f'{ms:.4f} ms'}, twin "
            f"{plain_ms:.1f} ms (once), bound {b_ms:.6f} ms by {b_by} ({n_bytes} bytes, {n_ops} operations; "
            f"without fused multiply-adds {no_fma_ms:.6f} ms); rows read step by step, the traffic the caches "
            f"serve: {l2_bytes} bytes = {l2_bytes / H100_BYTES_PER_S * 1e3:.6f} ms at the memory rate")
        out[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bound_no_fma_ms=no_fma_ms,
                         max_abs_err=err, visits=visits, leaf_visits=leaf_visits, rows=rows, l2_bytes=l2_bytes,
                         max_steps=int(steps.max()), capped=int((steps >= budget).sum()))
    return out


def walk_against_wave2(bvh, cs, o, d, any_tl, dev):
    """The skip-link walk and the wave2 engine on the same rays and the same
    triangles.  Returns (counts, walk, wave2's (t, tri), occlusion equal):
    ``counts`` holds the rays, hits, tri ids apart, exact ties among them
    (both t bit-equal), the largest relative t difference where both hit,
    and the occlusion of rays ``any_tl`` long."""
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    ro, rd = vec(o, dev), vec(d, dev)
    n = o.shape[0]
    walk = bt.bvh_walk(bvh, ro, rd, torch.full((n,), BIGF, device=dev), any_hit=False)
    w_t, w_tri = w2.wave2_closest_hit(cs, ro, rd, BIGF)[:2]
    occ = bt.bvh_walk(bvh, ro, rd, torch.full((n,), float(any_tl), device=dev), any_hit=True).occluded
    w_occ = w2.wave2_any_hit(cs, ro, rd, any_tl)[0]
    differ = walk.tri != w_tri
    ties = differ & (_bits(walk.t) == _bits(w_t)) & (walk.tri >= 0) & (w_tri >= 0)
    both = (walk.tri >= 0) & (w_tri >= 0)
    rel = float(((walk.t - w_t).abs() / w_t.abs())[both].max()) if bool(both.any()) else 0.0
    counts = {"rays": n, "hits": int((walk.tri >= 0).sum()), "tri_differ": int(differ.sum()),
              "exact_ties": int(ties.sum()), "max_rel_t": rel, "occluded": int(occ.sum()),
              "occluded_differ": int((occ != w_occ).sum())}
    return counts, walk, (w_t, w_tri), torch.equal(differ, ties)


def bvh_against_wave2(bvh, cs, o, d, any_tl, dev, log=print, label="window"):
    """``walk_against_wave2``, held: tri ids equal except on exact ties, t
    within 1e-6 relative where both hit, occlusion equal; or exit.  Returns
    the counts."""
    counts, _, _, ties_only = walk_against_wave2(bvh, cs, o, d, any_tl, dev)
    log(f"bvh vs wave2 [{label}]: {counts}")
    check(ties_only, f"bvh and wave2 tri ids equal but on exact ties ({label})", log)
    check(counts["max_rel_t"] <= 1e-6, f"bvh and wave2 t within 1e-6 relative ({label})", log)
    check(counts["occluded_differ"] == 0, f"bvh and wave2 occlusion equal ({label})", log)
    return counts


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
    from raytracer_tpu_torch.scene.bvh import build_bvh_over_triangles
    from raytracer_tpu_torch.scene.clusters import build_clusters

    args = sys.argv[1:]
    on_card = (args.pop(0) if args and args[0] in ("cuda", "cpu") else "cuda") == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to run the plain versions on the CPU")
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    n_tris = int(args[0]) if len(args) > 0 else (200_000 if on_card else 2000)
    n_rays = int(args[1]) if len(args) > 1 else (65_536 if on_card else 2048)
    print(f"device: {torch.cuda.get_device_name(0) if on_card else 'cpu (plain versions)'}  "
          f"tris~{n_tris}  rays={n_rays}")
    verts, faces = bench_mesh.make_mesh(n_tris)
    tri = verts[faces].astype(np.float32)
    cs = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], device=dev)
    print(f"clusters: {cs.num_clusters} x {cs.tris_per_cluster}")
    if on_card:
        check_wave2_kernel(cs, dev, n_rays=n_rays)
        check_extract_kernel(cs, *coherent_rays(n_rays), dev)
        check_join_kernels(cs, *coherent_rays(n_rays), dev)
        check_kernels(cs, dev, n_coherent=4 * n_rays, n_incoherent=n_rays)
    check_engines(cs, dev, n_rays=n_rays, on_card=on_card)
    # the skip-link walk: its triangle ids are the leaf order, so the
    # clusters for the comparison with wave2 are built over that order
    zero = np.zeros_like(tri)
    (v0, e1, e2, *_), bvh = build_bvh_over_triangles(tri, zero, zero[..., :2], np.zeros(len(tri), np.int32),
                                                     device=dev)
    leaf_cs = build_clusters(v0, e1, e2, device=dev)
    rng = np.random.default_rng(11)
    for label, (o, d) in (("coherent", coherent_rays(n_rays)), ("incoherent", incoherent_rays(n_rays, rng))):
        check_bvh_walk(bvh, o, d, 4.0, dev, label=label)
        bvh_against_wave2(bvh, leaf_cs, o, d, 4.0, dev, label=label)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
