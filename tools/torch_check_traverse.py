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


def _kernel_case(label, kernel, plain, n_rays, bytes_ops, log, reps, plain_reps):
    """Hold one kernel against its plain version on one input, time both and
    work out the bound from the visits the plain version counted."""
    stats = {}
    want = plain(stats)
    got = kernel()
    torch.cuda.synchronize()
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"kernel vs plain [{label}]: max_abs_diff={err} tri_mismatches={int((got[1] != want[1]).sum())} "
        f"hits={int((got[1] >= 0).sum())} of {n_rays} rays; steps={stats.get('steps', stats['visits'])} "
        f"visits that ran the triangle loop={stats['visits']} clusters touched={stats['touched']}")
    check(exact, f"{label}: kernel equals its plain version bit for bit", log)
    ms = cuda_ms(kernel, reps=reps)
    plain_ms = cuda_ms(lambda: plain(None), reps=plain_reps, warmup=1)
    n_bytes, n_ops = bytes_ops(stats)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    log(f"time [{label}]: kernel {ms:.4f} ms (median of {reps}), plain {plain_ms:.4f} ms (median of "
        f"{plain_reps}), bound {b_ms:.6f} ms by {b_by} ({n_bytes:.0f} bytes, {n_ops:.0f} operations)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_kernels(cs, dev, log=print, reps=20, plain_reps=20, n_coherent=262_144, n_incoherent=65_536):
    """Each of the two phase-2 kernels against its plain version at the
    path's shapes: bit-equal or exit.  Coherent camera rays (B = 256 blocks)
    and one incoherent window; the grid kernel on dense candidates at kb=48
    and on BFS candidates at kb=256, the stream kernel on BFS candidates at
    kb=256, closest-hit and any-hit.  Returns the two kernels' table rows:
    the coherent closest-hit case's times, the largest error of all cases."""
    k = cs.tris_per_cluster
    rng = np.random.default_rng(7)
    ray_sets = {"coherent": coherent_rays(n_coherent), "incoherent": incoherent_rays(n_incoherent, rng)}
    rows = {
        "phase2_grid": {"name": "phase2_grid", "route": "cuda", "source": "raytracer_tpu_torch/csrc/phase2_grid.cu",
                        "replaces": "raytracer_tpu/ops/pallas_traverse.py:120"},
        "phase2_stream": {"name": "phase2_stream", "route": "cuda",
                          "source": "raytracer_tpu_torch/csrc/phase2_stream.cu",
                          "replaces": "raytracer_tpu/ops/pallas_traverse.py:478"},
    }
    worst = {name: 0.0 for name in rows}

    def ray_bytes(b):  # 7 inputs read once, 4 outputs written once
        return b * pt.RB * (7 + 4) * 4

    for rays_label, (o, d) in ray_sets.items():
        o, d = vec(o, dev), vec(d, dev)
        n = o.x.shape[0]
        b = n // pt.RB
        big = torch.full((n,), BIGF, device=dev)
        lim = torch.full((n,), 20.0, device=dev)  # reaches the mesh from the camera

        def grid_case(label, cand, entry, rays):
            kb = cand.shape[1]
            grid_bytes_ops = lambda s: (ray_bytes(b) + b * kb * 8 + s["touched"] * k * 10 * 4,
                                        s["visits"] * pt.RB * k * MT_OPS)
            res = _kernel_case(
                f"phase2_grid {label} kb={kb} {rays_label} B={b}",
                lambda: pt.phase2_grid(cand, entry, cs.tri_block, cs.tri_id, *rays),
                lambda s: pt.phase2_grid_reference(cand, entry, cs.tri_block, cs.tri_id, *rays, stats=s),
                n, grid_bytes_ops, log, reps, plain_reps)
            worst["phase2_grid"] = max(worst["phase2_grid"], res["max_abs_err"])
            return res

        cand, entry = pt._block_candidates(cs, o, d, big, min(48, cs.num_clusters))
        res = grid_case("dense", cand.contiguous(), entry.contiguous(), _blocks(o, d, big))
        if rays_label == "coherent":
            rows["phase2_grid"].update(res)

        cand, entry, overflow, rays = _sorted_blocks(cs, o, d, big, 256)
        log(f"BFS candidates [{rays_label}]: kb={cand.shape[1]}, overflow on {int(overflow.sum())} of {b} blocks")
        grid_case("bfs", cand, entry, rays)

        for any_hit, tm in ((False, big), (True, lim)):
            cand, entry, _, rays = _sorted_blocks(cs, o, d, tm, 256)
            kb = cand.shape[1]
            stream_bytes_ops = lambda s: (ray_bytes(b) + s["steps"] * 8 + s["touched"] * (10 * k + 6) * 4,
                                          s["visits"] * pt.RB * k * MT_OPS + s["steps"] * pt.RB * BOX_OPS)
            res = _kernel_case(
                f"phase2_stream {'any-hit' if any_hit else 'closest'} kb={kb} {rays_label} B={b}",
                lambda: pt.phase2_stream(cand, entry, cs.stream_block, *rays, k, any_hit),
                lambda s: pt.phase2_stream_reference(cand, entry, cs.stream_block, *rays, k, any_hit, stats=s),
                n, stream_bytes_ops, log, reps, plain_reps)
            worst["phase2_stream"] = max(worst["phase2_stream"], res["max_abs_err"])
            if rays_label == "coherent" and not any_hit:
                rows["phase2_stream"].update(res)

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
