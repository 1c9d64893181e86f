"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. device: needs CUDA; prints the card, its power limit, torch and CUDA.
2. build: compiles csrc/wave2_mt.cu, phase2_grid.cu, phase2_stream.cu and
   add_one.cu with nvcc, all at once, into raytracer_tpu_torch/_build/, and
   prints what ptxas says of each.
3. wave2 kernel vs twin (tools/torch_check_traverse.py::check_wave2_kernel):
   on the 200k-triangle bench mesh, one real traversal window (65,536
   incoherent rays, kc=16) is joined into pair chunks; the CUDA
   Möller-Trumbore kernel and its plain PyTorch twin run on the same chunks
   (closest-hit and any-hit) and must agree bit for bit; both are timed (CUDA
   events) and the gates that pass give the kernel's bound.  Then, bit-equal
   or FAIL: the hand-built tie cases (equal t under different tri ids within
   a slot, across slots and across subs; closest, any-hit and filler lanes
   mixed) and windows against K = 8 and K = 128 cluster sets.
4. wave2 engine: wave2_closest_hit / wave2_any_hit on coherent and
   incoherent rays, kernel path against twin path: tri ids equal, no overflow.
5. the wave2 slice: a 32^2 render of a 2k-triangle mesh on the card agrees
   with the same render on the CPU (twin path); then the 512^2 MIS depth-6
   render of the 200k-triangle scene (1 warm-up + 4 timed passes) with the
   kernel's launches counted, one profiled pass, and the Cornell box at
   512^2 (8 passes).
6. (with 2) the three new libraries' ptxas output.
7. block-candidate kernels vs plain versions
   (tools/torch_check_traverse.py::check_kernels): how many ray blocks
   (thread-block clusters) of each kernel the card holds at once; then, at the
   path's shapes, phase2_grid on dense (kb=48) and BFS (kb=256) candidates and
   phase2_stream closest-hit and any-hit (kb=256), on 256 coherent camera
   blocks and one incoherent 65,536-ray window: bit-equal or FAIL; both
   timed; the visits give the bound.  Then, bit-equal or FAIL and untimed:
   the hand-built tie and edge cases (equal t in two slots and in two
   candidates, pad slots and pad rays, a block that ends at j = 0, a block of
   +inf entries, kb = 1 and kb = 300, B = 1 and odd B, K = 8 to 128) and
   mixed windows against K = 8 and K = 128 cluster sets.  Every case prints
   the spread of steps over its ray blocks (mean, max): the slowest ray block
   sets a kernel's time.
8. block-candidate engines (check_engines): pallas_cluster_closest_hit /
   any_hit, pallas_sorted_closest_hit / any_hit, _pallas_sorted_closest_hit,
   kernel path against plain path: equal.  Their agreement with wave2 and
   their overflow share are printed, not gated.
9. the sorted-pallas slice: a 32^2 render on the card against the CPU, then
   512^2, depth 6, MIS under `sorted-pallas` (1 warm-up + 4 timed passes):
   Mray/s, ray counts, the overflow count (reported, not required to be 0),
   stream-kernel launches > 0, finite radiance; one profiled pass; the mode
   is restored to `auto`.
10. probes (tools/torch_probe_launch.py): add_one against its plain version
    (the probe's shape, odd sizes, an unaligned view), chained x + 1 through
    torch, through add_one in both launch forms and beside an empty kernel,
    mt_chunks at 64 (live, all-sentinel), 512, 1,024 and 4,096 chunks.

11. textures, env map and postprocess against the CPU
    (tools/torch_check_textures.py): sample_texture_many over 2^20 lanes of
    mixed ids (three bitmaps in the three filters, checkerboard, noise with 1
    and 8 octaves, mix, const, INVALID_ID): texel fetches and checkerboard
    bit-equal, the rest within 1e-6; sample_2d / pdf_2d (same texel in every
    lane) and env_sample_direction; postprocess with each tonemapper and both
    dithers, bloom on, to_u8 within 1.
12. interior800k_mis: the 800k-triangle interior of tools/gen_interior.py,
    written by tools/torch_gen_interior.py (numpy BMP writer, no PIL) and
    loaded by the port's loader: no textures (both loaders ignore map_Kd),
    2 area lights + background; 512^2, depth 6, MIS under wave2 (1 warm-up +
    4 timed passes): Mray/s, rays, shadow rays, overflow = 0, wave2_mt
    launches > 0, finite radiance, peak memory; one profiled pass.  Before
    the render, on this scene's own cluster set: the wave2_mt kernel against
    its twin (bit-equal, timed) on a window of the scene's camera rays and on
    a window of bounce rays leaving their hit points, and the wave2 engine,
    kernel path against twin path, on both windows.
13. interior800k_tex_mis: the same meshes with the textured additions of
    torch_gen_interior.ensure_interior_tex (textures block, normal-mapped
    textured floor slab, textured props, a lat-long sky on the background
    light): the same kernel, engine and render checks, plus scene.textures and
    scene.env_dist present and Viewport.image() a (512, 512, 3) uint8 array
    that is neither constant nor saturated; before it, a 32^2 render of the
    small textured scene on the card against the CPU.

Prints the kernel table as one JSON line before the last line (the wave2_mt
row's top-level numbers are the 200k mesh's window; its ``by_path`` entry
gives each driven path's launches and its own windows), and last
{"ok": true, "device": {...}}.  Scene files are written under
raytracer_tpu_torch/_build/.  No phase imports PIL.
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
import torch_check_textures as tctex  # noqa: E402
import torch_check_traverse as tct  # noqa: E402
import torch_gen_interior  # noqa: E402
import torch_probe_launch as tpl  # noqa: E402
from torch_check_traverse import bound_ms, coherent_rays, incoherent_rays, vec  # noqa: E402

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.io.scene_loader import load_scene  # noqa: E402
from raytracer_tpu_torch.math.transform import RigidTransform  # noqa: E402
from raytracer_tpu_torch.ops import cuda_build  # noqa: E402
from raytracer_tpu_torch.ops import pallas_traverse as pt  # noqa: E402
from raytracer_tpu_torch.ops import traverse  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.ops.launch_probe import add_one  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams, pixel_grid  # noqa: E402
from raytracer_tpu_torch.sampler.sampler import make_stream  # noqa: E402
from raytracer_tpu_torch.scene.camera import generate_rays, make_camera  # noqa: E402
from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw  # noqa: E402

bench_mesh.BENCH_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "bench_scene")
INTERIOR_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "interior")
KERNELS = ("wave2_mt", "phase2_grid", "phase2_stream", "add_one")


def log(msg: str):
    print(msg, flush=True)


class twin_engine:
    """Within the block, the wave2 engine calls the plain twin, not the kernel."""

    def __enter__(self):
        self.saved = w2.mt_chunks
        w2.mt_chunks = w2.mt_chunks_reference
        return self

    def __exit__(self, *exc):
        w2.mt_chunks = self.saved


def check(cond, msg):
    tct.check(cond, msg, log)


def timed_render(vp, passes, smi, label):
    """1 warm-up pass, then ``passes`` timed ones ending with the film on
    the host.  Returns (seconds, rays, shadow rays, overflow in the timed
    passes, radiance)."""
    t0 = time.perf_counter()
    vp.render(1)
    torch.cuda.synchronize()
    log(f"{label} warm-up pass: {time.perf_counter() - t0:.2f} s")
    before = vp.progress()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vp.render(passes)
    radiance = vp.radiance()  # host copy: the timing ends with the film on the host
    dt = time.perf_counter() - t0
    after = vp.progress()
    rays = after["total_rays"] - before["total_rays"]
    shadow = after["total_shadow_rays"] - before["total_shadow_rays"]
    overflow = after["total_traversal_overflow"] - before["total_traversal_overflow"]
    log(f"{label} 512^2 depth 6, {passes} passes: {dt:.3f} s, {(rays + shadow) / dt / 1e6:.4f} Mray/s, "
        f"rays {rays:.0f}, shadow rays {shadow:.0f}, overflow {overflow:.0f}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    return dt, rays, shadow, overflow, radiance


def profiled_pass(vp, label, top=8, named=()):
    """One pass under torch.profiler: device kernel time in total and by
    kernel name (the ``top`` largest, and those whose name holds one of
    ``named``), beside the pass's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vp.render(1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    dev_time = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    # kernels and copies only: the host-side ops carry their kernels' time a second time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_time(e) > 0]
    total = sum(dev_time(e) for e in events)
    log(f"{label} profiled pass: wall {wall * 1e3:.1f} ms, device kernel time {total / 1e3:.1f} ms, "
        f"{sum(e.count for e in events)} device events")
    ranked = sorted(events, key=dev_time, reverse=True)
    for e in ranked[:top] + [e for e in ranked[top:] if any(n in e.key for n in named)]:
        log(f"  {dev_time(e) / 1e3:9.2f} ms  {e.count:6d} calls  {e.key[:90]}")


def small_render_agrees(params, dev, label, small=None, name="mesh2k"):
    """A 32^2 render of a small scene (the 2k-triangle mesh unless ``small``
    names another file) on the card against the CPU."""
    small = small or bench_mesh.ensure_scene(2000)
    views = []
    for where in ("cpu", dev):
        s, m, c = load_scene(small, device=where)
        views.append(Viewport(s, m, c, ViewportParams(32, 32, seed=0), params, device=where).render(1))
    a, b = (v.radiance() for v in views)
    close = float(np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1).mean())
    log(f"slice 32^2 {name} [{label}] cuda vs cpu: {close:.4f} of pixels within atol 1e-4 rtol 1e-3; "
        f"means {a.mean():.6f} / {b.mean():.6f}; overflow {views[0].progress()['total_traversal_overflow']:.0f} / "
        f"{views[1].progress()['total_traversal_overflow']:.0f}")
    check(close >= 0.98 and abs(a.mean() - b.mean()) <= 0.01 * abs(a.mean()),
          f"32^2 render of {name} on the card agrees with the CPU render ({label})")
    return views[1]


def engine_agrees(cs, o, d, any_tl, dev, label):
    """wave2_closest_hit and wave2_any_hit (rays of length ``any_tl``) on the
    (n, 3) rays ``o``, ``d``, kernel path against twin path: t, tri ids and
    occlusion bit-equal, no overflow.  Returns the kernel path's closest hit."""
    ro, rd = vec(o, dev), vec(d, dev)
    t0 = time.perf_counter()
    k_hit = w2.wave2_closest_hit(cs, ro, rd, 3.0e38)
    k_occ = w2.wave2_any_hit(cs, ro, rd, any_tl)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with twin_engine():
        t_hit = w2.wave2_closest_hit(cs, ro, rd, 3.0e38)
        t_occ = w2.wave2_any_hit(cs, ro, rd, any_tl)
    log(f"engine [{label}] {ro.x.shape[0]} rays: closest+any {dt * 1e3:.1f} ms, "
        f"hit rate {float((k_hit[1] >= 0).float().mean()):.4f}, "
        f"occluded {float(k_occ[0].float().mean()):.4f}")
    check(torch.equal(k_hit[1], t_hit[1]) and torch.equal(k_hit[0], t_hit[0]),
          f"engine closest-hit tri ids and t equal, kernel vs twin ({label})")
    check(torch.equal(k_occ[0], t_occ[0]), f"engine any-hit equal, kernel vs twin ({label})")
    check(not bool(k_hit[4].any()) and not bool(k_occ[1].any()), f"engine overflow all false ({label})")
    return k_hit


def interior_windows(scene, meta, cam, dev, label):
    """The wave2_mt kernel and the wave2 engine held against the twin on the
    interior's own cluster set, with two windows of w2.SUBWAVE rays of the
    driven path: the camera rays of the frame at half its resolution, and
    bounce rays that leave those rays' hit points in seeded random directions
    (rays that hit nothing keep their origin).  Any-hit rays are as long as
    the scene's radius.  Returns {window: check_wave2_window's numbers}."""
    side = int(w2.SUBWAVE ** 0.5)
    cx, cy, pixel_ids = pixel_grid(side, side, device=dev)
    rays, _ = generate_rays(cam, cx, cy, make_stream(pixel_ids.to(torch.int64), 0, seed=0))
    o, d = torch.stack(tuple(rays.origin), 1), torch.stack(tuple(rays.dir), 1)
    cs, reach = scene.clusters, float(meta.scene_radius)
    t, tri = engine_agrees(cs, o, d, reach, dev, f"{label} camera")[:2]
    windows = {"camera": tct.check_wave2_window(cs, o, d, reach, dev, log, label=f"{label} camera window")}
    hit = (tri >= 0)[:, None]
    bo = torch.where(hit, o + d * (t * (1.0 - 1e-4))[:, None], o)
    bd = np.random.default_rng(12).normal(size=(o.shape[0], 3)).astype(np.float32)
    bd = torch.as_tensor(bd / np.linalg.norm(bd, axis=1, keepdims=True), device=dev)
    engine_agrees(cs, bo, bd, reach, dev, f"{label} bounce")
    windows["bounce"] = tct.check_wave2_window(cs, bo, bd, reach, dev, log, label=f"{label} bounce window")
    return windows


def interior_render(path, dev, smi, label, textured):
    """Phases 12 and 13: load an interior scene, check what it holds, render
    512^2 depth 6 MIS under wave2 (1 warm-up + 4 timed passes, one profiled)
    with the wave2_mt launches counted; before the render, the kernel and the
    engine against the twin on this scene's cluster set (interior_windows).
    Returns (viewport, {"launches": ..., "windows": ...})."""
    t0 = time.perf_counter()
    scene, meta, cam = load_scene(path, strict=True, device=dev)
    torch.cuda.synchronize()
    cs = scene.clusters
    log(f"scene: {label} loaded in {time.perf_counter() - t0:.1f} s; {scene.tris.count} tris, {cs.num_clusters} "
        f"clusters, {cs.num_supers} supers x 8 x {cs.tris_per_cluster}; {scene.prims.count} prims, "
        f"{scene.materials.bsdf.shape[0]} materials, light kinds {meta.light_kinds}, scene radius "
        f"{meta.scene_radius:.2f}; textures "
        f"{None if scene.textures is None else tuple(scene.textures.data.shape)}, env_dist "
        f"{None if scene.env_dist is None else tuple(scene.env_dist.density.shape)}; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check(750_000 <= scene.tris.count <= 850_000, "the interior holds about 800k triangles")
    check(meta.light_kinds == (0, 0, 1), "2 area lights and the background light")
    if textured:
        check(scene.textures is not None and scene.env_dist is not None,
              "the textured interior has its atlas and its env distribution")
        check(scene.textures.kinds_present == (0, 1, 2, 3) and scene.textures.max_octaves == 4,
              "the atlas holds bitmaps, a checkerboard, a 4-octave noise and a mix")
    else:
        check(scene.textures is None and scene.env_dist is None,
              "the interior has no textures (the OBJ maps are ignored, as in the reference loader)")
    check(traverse.get_traversal_mode() == "auto" and not os.environ.get("RT_TRAVERSAL_MODE"),
          "the traversal mode is the default (auto -> wave2)")
    windows = interior_windows(scene, meta, cam, dev, label)
    vp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True), device=dev)
    w2.mt_chunks.launches = 0
    _, _, _, overflow, radiance = timed_render(vp, 4, smi, f"{label} [wave2]")
    launches = w2.mt_chunks.launches
    log(f"{label} [wave2]: wave2_mt launches {launches} in 5 passes; mean radiance {radiance.mean():.6f}")
    check(launches > 0, f"the {label} render launched the wave2_mt kernel")
    check(overflow == 0, f"{label}: traversal overflow is 0")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, f"{label}: radiance finite with non-zero mean")
    profiled_pass(vp, f"{label} [wave2]", named=("wave2_mt",))
    return vp, {"launches": launches, "windows": windows}


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

    # --- 2 + 6. build all four libraries, one nvcc each, together -----------
    t0 = time.perf_counter()
    cuda_build.build_kernel_libraries(KERNELS)
    log(f"build: {len(KERNELS)} libraries in {time.perf_counter() - t0:.2f} s")
    for kernel in KERNELS:
        cuda_build.load_kernel_library(kernel)
        log(f"build [{kernel}] {cuda_build.BUILD_INFO[kernel]['seconds']:.2f} s\n{cuda_build.BUILD_INFO[kernel]['log']}")

    # --- 3. wave2 kernel vs twin: one real window, the tie cases, K = 8 and 128 ---
    t0 = time.perf_counter()
    mscene, mmeta, mcam = load_scene(bench_mesh.ensure_scene(200_000), device=dev)
    cs_set = mscene.clusters
    log(f"scene: mesh200k loaded in {time.perf_counter() - t0:.1f} s; {mscene.tris.count} tris, "
        f"{cs_set.num_clusters} clusters, {cs_set.num_supers} supers x 8 x {cs_set.tris_per_cluster}")
    rows = {"wave2_mt": tct.check_wave2_kernel(cs_set, dev, log)}
    rng = np.random.default_rng(7)

    # --- 4. the wave2 engine, kernel path against twin path ----------------
    for label, (o, d) in (("coherent", coherent_rays(w2.SUBWAVE)),
                          ("incoherent", incoherent_rays(w2.SUBWAVE, rng))):
        engine_agrees(cs_set, o, d, 4.0, dev, label)

    # --- 5. the wave2 slice --------------------------------------------------
    params = RenderParams(max_depth=6, mis=True)
    check(traverse.get_traversal_mode() == "auto" and not os.environ.get("RT_TRAVERSAL_MODE"),
          "the traversal mode is the default (auto -> wave2)")
    small_render_agrees(params, dev, "wave2")
    vp = Viewport(mscene, mmeta, mcam, ViewportParams(512, 512, seed=0), params, device=dev)
    w2.mt_chunks.launches = 0
    _, _, _, overflow, radiance = timed_render(vp, 4, smi, "mesh200k_mis [wave2]")
    rows["wave2_mt"]["launches"] = w2.mt_chunks.launches  # warm-up + timed passes of this drive
    log(f"mesh200k_mis [wave2]: wave2_mt launches {w2.mt_chunks.launches}")
    check(w2.mt_chunks.launches > 0, "the mesh render launched the wave2_mt kernel")
    check(overflow == 0, "traversal overflow is 0")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, "radiance finite with non-zero mean")
    profiled_pass(vp, "mesh200k_mis [wave2]", named=("wave2_mt",))

    cscene, cmeta = cornell_box(device=dev)
    t_kw, c_kw = cornell_camera_kw()
    ccam = make_camera(RigidTransform(**t_kw), **c_kw, device=dev)
    cvp = Viewport(cscene, cmeta, ccam, ViewportParams(512, 512, seed=0), params, device=dev)
    _, _, _, _, crad = timed_render(cvp, 8, smi, "cornell_mis")
    check(bool(np.isfinite(crad).all()) and crad.mean() > 0, "cornell radiance finite with non-zero mean")

    # --- 7. block-candidate kernels against their plain versions -----------
    rows.update(tct.check_kernels(cs_set, dev, log, reps=20, plain_reps=5))

    # --- 8. block-candidate engines, kernel path against plain path --------
    pt.phase2_grid.launches = pt.phase2_stream.launches = 0
    tct.check_engines(cs_set, dev, log)
    rows["phase2_grid"]["launches"] = pt.phase2_grid.launches
    log(f"engines: phase2_grid launches {pt.phase2_grid.launches}, phase2_stream launches "
        f"{pt.phase2_stream.launches} (kernel-path calls only; the plain path launches nothing)")
    check(pt.phase2_grid.launches > 0, "the pallas_cluster_* and _pallas_sorted_closest_hit engines launched "
                                       "the phase2_grid kernel")

    # --- 9. the sorted-pallas slice ----------------------------------------
    traverse.set_traversal_mode("sorted-pallas")
    small_render_agrees(params, dev, "sorted-pallas")
    vp = Viewport(mscene, mmeta, mcam, ViewportParams(512, 512, seed=0), params, device=dev)
    pt.phase2_stream.launches = 0
    w2.mt_chunks.launches = 0
    _, rays, shadow, overflow, radiance = timed_render(vp, 4, smi, "mesh200k_mis [sorted-pallas]")
    rows["phase2_stream"]["launches"] = pt.phase2_stream.launches
    log(f"mesh200k_mis [sorted-pallas]: phase2_stream launches {pt.phase2_stream.launches}, wave2_mt launches "
        f"{w2.mt_chunks.launches}, overflow share {overflow / max(rays + shadow, 1):.4f} of rays + shadow rays")
    check(pt.phase2_stream.launches > 0 and w2.mt_chunks.launches == 0,
          "the sorted-pallas render launched the phase2_stream kernel and not wave2_mt")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, "radiance finite with non-zero mean")
    profiled_pass(vp, "mesh200k_mis [sorted-pallas]")
    # the same mode through the environment, which overrides set_traversal_mode
    traverse.set_traversal_mode("auto")
    os.environ["RT_TRAVERSAL_MODE"] = "sorted-pallas"
    before = pt.phase2_stream.launches
    env_vp = Viewport(mscene, mmeta, mcam, ViewportParams(128, 128, seed=0), params, device=dev).render(1)
    del os.environ["RT_TRAVERSAL_MODE"]
    check(pt.phase2_stream.launches > before and bool(np.isfinite(env_vp.radiance()).all()),
          "RT_TRAVERSAL_MODE=sorted-pallas reaches the stream kernel")
    check(traverse.get_traversal_mode() == "auto", "the traversal mode is back to auto")

    # --- 10. probes -----------------------------------------------------------
    err = tpl.check_add_one(dev, log)
    add_one.launches = 0
    probe = tpl.probe_dispatch(dev, log)
    b_ms, b_by = bound_ms(2 * tpl.PROBE_SHAPE[0] * tpl.PROBE_SHAPE[1] * 4, tpl.PROBE_SHAPE[0] * tpl.PROBE_SHAPE[1])
    rows["add_one"] = {"name": "add_one", "route": "cuda", "source": "raytracer_tpu_torch/csrc/add_one.cu",
                       "replaces": "tools/probe_r4.py:29", "launches": add_one.launches, "max_abs_err": err,
                       "ms": probe["add_one_grid_graph_us"] / 1e3, "plain_ms": probe["torch_add_graph_us"] / 1e3,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": probe["torch_add_graph_us"] / 1e3}
    check(add_one.launches > 0, "the dispatch probe launched the add_one kernel")
    tpl.probe_mt_chunks(cs_set, dev, log)

    # --- 11. textures, env map and postprocess against the CPU ----------------
    tctex.check_all(dev, log)

    # --- 12. the 800k-triangle interior, as the reference renders it ----------
    t0 = time.perf_counter()
    plain_json = torch_gen_interior.ensure_interior(INTERIOR_DIR)
    log(f"scene: interior files under _build/interior in {time.perf_counter() - t0:.1f} s")
    mt = rows["wave2_mt"]
    window = {key: mt[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    mt["by_path"] = {"mesh200k_mis": {"launches": mt["launches"], "windows": {"incoherent": window}}}
    _, mt["by_path"]["interior800k_mis"] = interior_render(plain_json, dev, smi, "interior800k_mis", False)

    # --- 13. the textured interior ---------------------------------------------
    small = small_render_agrees(params, dev, "wave2", name="small textured scene",
                                small=torch_gen_interior.ensure_small_textured(INTERIOR_DIR + "_small"))
    check(small.scene.textures is not None and small.scene.env_dist is not None,
          "the small textured scene has its atlas and its env distribution")
    vp, mt["by_path"]["interior800k_tex_mis"] = interior_render(
        torch_gen_interior.ensure_interior_tex(INTERIOR_DIR), dev, smi, "interior800k_tex_mis", True)
    t0 = time.perf_counter()
    image = vp.image()
    log(f"interior800k_tex_mis: Viewport.image() in {(time.perf_counter() - t0) * 1e3:.1f} ms: {image.shape} "
        f"{image.dtype}, min {image.min()}, max {image.max()}, mean {image.mean():.2f}, "
        f"{float((image == 255).mean()):.4f} of values saturated")
    check(image.shape == (512, 512, 3) and image.dtype == np.uint8, "image() is a (512, 512, 3) uint8 array")
    check(image.min() < image.max() and float((image == 255).mean()) < 0.5 and float((image == 0).mean()) < 0.5,
          "the image is neither constant nor saturated")
    mt["max_abs_err"] = max(w["max_abs_err"] for path in mt["by_path"].values() for w in path["windows"].values())

    check("PIL" not in sys.modules, "no phase imported PIL")
    for mod in ("jax", "raytracer_tpu"):
        check(not any(m == mod or m.startswith(mod + ".") for m in sys.modules), f"no {mod} module was imported")
    for row in rows.values():
        check(row["launches"] > 0, f"{row['name']}: launched {row['launches']} times on its driven path")
    for path, entry in mt["by_path"].items():
        check(entry["launches"] > 0, f"wave2_mt: launched {entry['launches']} times on {path}")

    print(f"{smi}", flush=True)
    print(json.dumps({"kernels": [rows[kernel] for kernel in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
