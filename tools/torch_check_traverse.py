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
        check_kernels(cs, dev, n_coherent=4 * n_rays, n_incoherent=n_rays)
    check_engines(cs, dev, n_rays=n_rays, on_card=on_card)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
