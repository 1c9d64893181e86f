"""Time the port's forward renders of two checkouts in turns on one card.

    python tools/torch_compare_trees.py PARENT_DIR [CHANGE_DIR]

``PARENT_DIR`` and ``CHANGE_DIR`` (default: this checkout) each hold a
``raytracer_tpu_torch/``.  Each tree renders in its own process, in the
order parent, change, change, parent, so that a drift of the host shows as
a difference between a tree's two runs.  A run renders ``mesh200k_mis``,
``cornell_mis`` and ``interior800k_mis`` at 512^2, depth 6, MIS under the
default mode (one warm-up pass, then timed passes that end with the film on
the host) and prints one JSON line of ms a pass and mean radiance; the
scene files are written once, by this checkout's generators, under its
``raytracer_tpu_torch/_build/``.  Needs a CUDA device; prints the card and
its power limit, then one line per workload: each run's ms a pass.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "raytracer_tpu_torch", "_build")
PASSES = {"mesh200k_mis": 2, "cornell_mis": 4, "interior800k_mis": 2}


def scene_files():
    """The three scenes' files under this checkout's build directory."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_mesh
    import torch_gen_interior

    bench_mesh.BENCH_DIR = os.path.join(BUILD, "bench_scene")
    return {"mesh200k_mis": bench_mesh.ensure_scene(200_000),
            "interior800k_mis": torch_gen_interior.ensure_interior(os.path.join(BUILD, "interior"))}


def run_one(tree: str, files: dict) -> dict:
    """Renders the workloads with the package of ``tree``; returns
    {workload: [ms a pass, mean radiance]}."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import raytracer_tpu_torch
    from raytracer_tpu_torch.integrators.path_tracer import RenderParams
    from raytracer_tpu_torch.io.scene_loader import load_scene
    from raytracer_tpu_torch.math.transform import RigidTransform
    from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
    from raytracer_tpu_torch.scene.camera import make_camera
    from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw

    assert os.path.realpath(raytracer_tpu_torch.__file__).startswith(os.path.realpath(tree))
    dev = torch.device("cuda", 0)
    out = {}
    for name, passes in PASSES.items():
        if name == "cornell_mis":
            scene, meta = cornell_box(device=dev)
            t_kw, c_kw = cornell_camera_kw()
            cam = make_camera(RigidTransform(**t_kw), **c_kw, device=dev)
        else:
            scene, meta, cam = load_scene(files[name], device=dev)
        vp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True),
                      device=dev)
        vp.render(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        radiance = vp.render(passes).radiance()
        out[name] = [(time.perf_counter() - t0) / passes * 1e3, float(np.mean(radiance))]
    return out


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2], json.loads(sys.argv[3]))), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: this comparison needs a CUDA device")
    parent = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else ROOT
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    files = scene_files()
    runs = []
    for label, tree in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, json.dumps(files)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            raise SystemExit(f"FAIL: the {label} run exited {res.returncode}: {res.stderr[-3000:]}")
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    for name in PASSES:
        cells = ", ".join(f"{label} {r[name][0]:.1f}" for label, r in runs)
        means = {f"{r[name][1]:.6f}" for _, r in runs}
        print(f"{name}: ms a pass in turn: {cells}; mean radiance {sorted(means)}", flush=True)


if __name__ == "__main__":
    main()
