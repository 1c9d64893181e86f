"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. device: needs CUDA; prints the card, its power limit, torch and CUDA.
2. build: compiles csrc/wave2_mt.cu with nvcc into raytracer_tpu_torch/_build/.
3. kernel vs twin: on the 200k-triangle bench mesh, one real traversal
   window (65,536 incoherent rays, kc=16) is joined into pair chunks; the
   CUDA Möller-Trumbore kernel and its plain PyTorch twin run on the same
   chunks (closest-hit and any-hit) and must agree bit for bit; both are
   timed (median of 20 runs after warm-up, CUDA events).
4. engine: wave2_closest_hit / wave2_any_hit on coherent and incoherent
   rays, kernel path against twin path: tri ids equal, no overflow.
5. slice: a 32^2 render of a 2k-triangle mesh on the card agrees with the
   same render on the CPU (twin path); then the 512^2 MIS depth-6 render of
   the 200k-triangle scene (1 warm-up + 4 timed passes) with the kernel's
   launches counted, and the Cornell box at 512^2 (8 passes).

Prints the kernel table as one JSON line before the last line, and last
{"ok": true, "device": {...}}.  Scene files are written under
raytracer_tpu_torch/_build/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench_mesh  # noqa: E402  (numpy-only scene generator)

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.io.scene_loader import load_scene  # noqa: E402
from raytracer_tpu_torch.math.transform import RigidTransform  # noqa: E402
from raytracer_tpu_torch.math.vec import Vec3  # noqa: E402
from raytracer_tpu_torch.ops import cuda_build  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams  # noqa: E402
from raytracer_tpu_torch.scene.camera import make_camera  # noqa: E402
from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw  # noqa: E402

bench_mesh.BENCH_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "bench_scene")
KERNEL_SOURCE = "raytracer_tpu_torch/csrc/wave2_mt.cu"
KERNEL_REPLACES = "raytracer_tpu/ops/wave2_traverse.py:324"


def log(msg: str):
    print(msg, flush=True)


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


class twin_engine:
    """Within the block, the wave2 engine calls the plain twin, not the kernel."""

    def __enter__(self):
        self.saved = w2.mt_chunks
        w2.mt_chunks = w2.mt_chunks_reference
        return self

    def __exit__(self, *exc):
        w2.mt_chunks = self.saved


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAIL: {msg}")
    log(f"ok: {msg}")


def main():
    # --- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false; this script needs one NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # --- 2. build ------------------------------------------------------------
    lib_t0 = time.perf_counter()
    cuda_build.load_kernel_library("wave2_mt")
    info = cuda_build.BUILD_INFO["wave2_mt"]
    log(f"build: wave2_mt in {info['seconds']:.2f} s (load {time.perf_counter() - lib_t0:.2f} s)")
    log(info["log"])

    # --- 3. kernel vs twin on one real window ------------------------------
    t0 = time.perf_counter()
    mscene, mmeta, mcam = load_scene(bench_mesh.ensure_scene(200_000), device=dev)
    cs_set = mscene.clusters
    log(f"scene: mesh200k loaded in {time.perf_counter() - t0:.1f} s; {mscene.tris.count} tris, "
        f"{cs_set.num_supers} supers x 8 x {cs_set.tris_per_cluster}")
    rng = np.random.default_rng(7)
    o, d = incoherent_rays(w2.SUBWAVE, rng)
    ro, rd = vec(o, dev), vec(d, dev)
    kernel_row = None
    for any_hit, tl_value in ((False, w2.BIGF), (True, 4.0)):
        tl = torch.full((w2.SUBWAVE,), tl_value, dtype=torch.float32, device=dev)
        cursor = torch.full_like(tl, -1, dtype=torch.int32)
        cand, _ = w2._p1_extract(cs_set, *ro, *rd, tl, cursor, min(w2.KC, cs_set.num_supers))
        join = w2._pair_join(cs_set, cand, *ro, *rd, tl)
        args = (join.block_cluster, cs_set.super_geom, cs_set.super_sbox, *join.pairs)
        got = w2.mt_chunks(*args, any_hit=any_hit)
        want = w2.mt_chunks_reference(*args, any_hit=any_hit)
        torch.cuda.synchronize()
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        mism = int((got[1] != want[1]).sum())
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        label = "any-hit" if any_hit else "closest"
        log(f"kernel vs twin [{label}]: chunks={join.block_cluster.shape[0]} max_abs_diff={err} "
            f"tri_mismatches={mism} hits={int((got[1] >= 0).sum())}")
        check(exact, f"wave2_mt kernel equals its twin bit for bit ({label})")
        ms = cuda_ms(lambda: w2.mt_chunks(*args, any_hit=any_hit))
        plain_ms = cuda_ms(lambda: w2.mt_chunks_reference(*args, any_hit=any_hit))
        log(f"time [{label}] at the window shape: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms ({smi})")
        if not any_hit:
            kernel_row = {"name": "wave2_mt", "route": "cuda", "source": KERNEL_SOURCE,
                          "replaces": KERNEL_REPLACES, "launches": 0, "max_abs_err": err,
                          "ms": ms, "plain_ms": plain_ms}
        else:
            kernel_row["max_abs_err"] = max(kernel_row["max_abs_err"], err)

    # --- 4. the engine, kernel path against twin path ----------------------
    for label, (o, d) in (("coherent", coherent_rays(w2.SUBWAVE)),
                          ("incoherent", incoherent_rays(w2.SUBWAVE, rng))):
        ro, rd = vec(o, dev), vec(d, dev)
        t0 = time.perf_counter()
        k_hit = w2.wave2_closest_hit(cs_set, ro, rd, 3.0e38)
        k_occ = w2.wave2_any_hit(cs_set, ro, rd, 4.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with twin_engine():
            t_hit = w2.wave2_closest_hit(cs_set, ro, rd, 3.0e38)
            t_occ = w2.wave2_any_hit(cs_set, ro, rd, 4.0)
        log(f"engine [{label}] {w2.SUBWAVE} rays: closest+any {dt * 1e3:.1f} ms, "
            f"hit rate {float((k_hit[1] >= 0).float().mean()):.4f}, "
            f"occluded {float(k_occ[0].float().mean()):.4f}")
        check(torch.equal(k_hit[1], t_hit[1]) and torch.equal(k_hit[0], t_hit[0]),
              f"engine closest-hit tri ids and t equal, kernel vs twin ({label})")
        check(torch.equal(k_occ[0], t_occ[0]), f"engine any-hit equal, kernel vs twin ({label})")
        check(not bool(k_hit[4].any()) and not bool(k_occ[1].any()), f"engine overflow all false ({label})")

    # --- 5. the slice --------------------------------------------------------
    params = RenderParams(max_depth=6, mis=True)
    small = bench_mesh.ensure_scene(2000)
    views = []
    for where in ("cpu", dev):
        s, m, c = load_scene(small, device=where)
        views.append(Viewport(s, m, c, ViewportParams(32, 32, seed=0), params, device=where).render(1))
    a, b = (v.radiance() for v in views)
    close = float(np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1).mean())
    log(f"slice 32^2 mesh2k cuda vs cpu: {close:.4f} of pixels within atol 1e-4 rtol 1e-3; "
        f"means {a.mean():.6f} / {b.mean():.6f}")
    check(close >= 0.98 and abs(a.mean() - b.mean()) <= 0.01 * abs(a.mean()),
          "32^2 render on the card agrees with the CPU render")

    vp = Viewport(mscene, mmeta, mcam, ViewportParams(512, 512, seed=0), params, device=dev)
    t0 = time.perf_counter()
    vp.render(1)
    torch.cuda.synchronize()
    log(f"mesh200k warm-up pass: {time.perf_counter() - t0:.2f} s")
    before = vp.progress()
    w2.mt_chunks.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vp.render(4)
    radiance = vp.radiance()  # host copy: the timing ends with the film on the host
    dt = time.perf_counter() - t0
    launches = w2.mt_chunks.launches
    after = vp.progress()
    rays = after["total_rays"] - before["total_rays"]
    shadow = after["total_shadow_rays"] - before["total_shadow_rays"]
    overflow = after["total_traversal_overflow"]
    mrays = (rays + shadow) / dt / 1e6
    log(f"mesh200k_mis 512^2 depth 6, 4 passes: {dt:.3f} s, {mrays:.4f} Mray/s, rays {rays:.0f}, "
        f"shadow rays {shadow:.0f}, overflow {overflow:.0f}, kernel launches {launches}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    check(launches > 0, "the mesh render launched the wave2_mt kernel")
    check(overflow == 0, "traversal overflow is 0")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, "radiance finite with non-zero mean")
    kernel_row["launches"] = launches

    cscene, cmeta = cornell_box(device=dev)
    t_kw, c_kw = cornell_camera_kw()
    ccam = make_camera(RigidTransform(**t_kw), **c_kw, device=dev)
    cvp = Viewport(cscene, cmeta, ccam, ViewportParams(512, 512, seed=0), params, device=dev)
    cvp.render(1)
    torch.cuda.synchronize()
    before = cvp.progress()
    t0 = time.perf_counter()
    cvp.render(8)
    crad = cvp.radiance()
    cdt = time.perf_counter() - t0
    after = cvp.progress()
    crays = (after["total_rays"] - before["total_rays"]
             + after["total_shadow_rays"] - before["total_shadow_rays"])
    log(f"cornell_mis 512^2 depth 6, 8 passes (after 1 warm-up): {cdt:.3f} s, "
        f"{crays / cdt / 1e6:.4f} Mray/s, rays+shadow {crays:.0f} ({smi})")
    check(bool(np.isfinite(crad).all()) and crad.mean() > 0, "cornell radiance finite with non-zero mean")
    check("jax" not in sys.modules, "no jax module was imported")

    print(f"{smi}", flush=True)
    print(json.dumps({"kernels": [kernel_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
