"""Time the mesh-bench render pass directly (counterpart of
``tools/probe_render.py``), optionally under ``torch.profiler``.

    python tools/torch_probe_render.py [n_passes] [--trace] [--cpu]

Loads the 200k-triangle bench mesh (``tools/bench_mesh.py``, written under
``raytracer_tpu_torch/_build/bench_scene``; 2,000 triangles and 64^2 with
``--cpu``) and renders 512^2, depth 6, MIS through ``render_pass`` with no
Viewport around it: the first pass (the kernels already built: its time
holds the first launches' set-up), the rays a pass, then ``n_passes`` (4)
timed passes ending with the film on the host: ms a pass and Mray/s.  With
``--trace`` the timed passes run under ``torch.profiler`` and its Chrome
trace is written to ``raytracer_tpu_torch/_build/probe_render_trace.json``.
``chip_smoke.py`` phase 24 calls ``probe`` for one pass on the scene it
has loaded.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import nullcontext

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.render.film import make_film  # noqa: E402
from raytracer_tpu_torch.render.renderer import ViewportParams, render_pass  # noqa: E402

TRACE_PATH = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "probe_render_trace.json")


def probe(scene, meta, cam, dev, n_passes=4, trace=False, size=512, log=print):
    """The probe (module docstring) on a loaded scene.  Returns {"first_s",
    "rays_a_pass", "ms_a_pass", "mrays_per_sec"}."""
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    vp = ViewportParams(width=size, height=size, seed=0)
    params = RenderParams(max_depth=6, mis=True)
    film = make_film(size, size, dev)
    t0 = time.perf_counter()
    film, counters = render_pass(scene, meta, cam, film, 0, None, vp, params)
    film.sum.cpu()
    first = time.perf_counter() - t0
    rays = float(counters.num_rays + counters.num_shadow_rays)
    log(f"first pass: {first:.2f} s; rays a pass {rays / 1e6:.3f}M")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with (profile(activities=acts) if trace else nullcontext()) as prof:
        sync()
        t0 = time.perf_counter()
        for i in range(1, n_passes + 1):
            film, _ = render_pass(scene, meta, cam, film, i, None, vp, params)
        film.sum.cpu()
        dt = (time.perf_counter() - t0) / n_passes
    if trace:
        os.makedirs(os.path.dirname(TRACE_PATH), exist_ok=True)
        prof.export_chrome_trace(TRACE_PATH)
        log(f"trace: {TRACE_PATH}")
    log(f"per-pass: {dt * 1e3:.1f} ms   {rays / dt / 1e6:.4f} Mray/s")
    return {"first_s": first, "rays_a_pass": rays, "ms_a_pass": dt * 1e3, "mrays_per_sec": rays / dt / 1e6}


def main():
    import bench_mesh
    from raytracer_tpu_torch.io.scene_loader import load_scene

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    cpu = "--cpu" in sys.argv
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give --cpu to run on the CPU")
    dev = "cpu" if cpu else "cuda"
    bench_mesh.BENCH_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "bench_scene")
    scene, meta, cam = load_scene(bench_mesh.ensure_scene(2000 if cpu else 200_000), device=dev)
    probe(scene, meta, cam, dev, int(args[0]) if args else 4, "--trace" in sys.argv, 64 if cpu else 512)


if __name__ == "__main__":
    main()
