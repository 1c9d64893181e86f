"""Rays-a-second scaling of ``render_pass_sharded`` over 1, 2 and 4 ranks
(counterpart of ``tools/scaling_bench.py``).

    python tools/torch_scaling_bench.py [cuda|cpu] [--size 256] [--counts 1,2,4] [--passes 4]
    python tools/torch_scaling_bench.py worker RANK WORLD INIT_FILE OUT_DIR DEVICE BACKEND SIZE PASSES

Renders the same fixed Cornell box, MIS, depth 6, at ``size``^2 (strong
scaling: each rank traces its band of rows) through ``render_pass_sharded``
in a group of n ranks, one process a rank (``parallel/launch.py``: NCCL when
each rank has a card of its own, gloo otherwise), for each n of
``counts``: 2 warm-up passes, then ``passes`` timed passes ending with the
band on the host; a rank count's seconds a pass is its slowest rank's.  One
JSON line a rank count, then a summary line.  The reference's two
semantics (``scaling_bench.py:9-17``):

- n NCCL ranks on n cards add compute: ``efficiency_n = thr_n / (n thr_1)``;
- ranks that share one device (gloo on the CPU's cores, or on one card)
  cannot trace more than one rank: what is measured is the sharding
  overhead ``overhead_n = T_n / T_1`` (ideal 1.0).

Every rank's band after the 2 + ``passes`` passes must equal the same rows
of a one-process render of those passes (``render_passes``) bit for bit,
else the tool exits 1.  ``chip_smoke.py`` phase 24 calls ``run``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.math.transform import RigidTransform  # noqa: E402
from raytracer_tpu_torch.render.film import make_film  # noqa: E402
from raytracer_tpu_torch.render.renderer import ViewportParams, render_passes  # noqa: E402
from raytracer_tpu_torch.scene.camera import make_camera  # noqa: E402
from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw  # noqa: E402

WARMUP = 2
RANK_TIMEOUT_S = 600
WORK_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "scaling")


def _setup(size, device):
    scene, meta = cornell_box(device=device)
    t_kw, c_kw = cornell_camera_kw()
    cam = make_camera(RigidTransform(**t_kw), **c_kw, device=device)
    return scene, meta, cam, ViewportParams(width=size, height=size, seed=0), RenderParams(max_depth=6, mis=True)


def worker(rank, world, init_file, out_dir, device, backend, size, passes):
    """One rank: warm-up and timed passes of its band; writes
    ``out_dir/rank<rank>.npz``."""
    from raytracer_tpu_torch.parallel import mesh as pm

    pm.init_distributed(f"file://{init_file}", world, rank, backend)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    scene, meta, cam, vp, params = _setup(size, device)
    mesh = pm.make_mesh()
    film = pm.film_sharding(make_film(size, size, device), mesh)
    for p in range(WARMUP):
        film, _ = pm.render_pass_sharded(scene, meta, cam, film, p, None, vp, params, mesh)
    film.sum.cpu()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    rays = 0.0
    for p in range(WARMUP, WARMUP + passes):
        film, counters = pm.render_pass_sharded(scene, meta, cam, film, p, None, vp, params, mesh)
        rays += float(counters.num_rays + counters.num_shadow_rays)
    band = film.sum.cpu().numpy()
    dt = (time.perf_counter() - t0) / passes
    row0, rows = pm._band(mesh, size)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), row0=row0, rows=rows, band=band, seconds_per_pass=dt,
             rays_a_pass=rays / passes)
    torch.distributed.destroy_process_group()
    print("RANK_OK", rank, flush=True)


def run(dev="cuda", counts=(1, 2, 4), size=256, passes=4, log=print, out=print):
    """The bench (module docstring).  Returns ({n: the rank count's JSON
    line as a dict}, the summary dict).  Raises SystemExit where a rank
    fails or a band differs from the one-process render's rows."""
    from raytracer_tpu_torch.parallel.launch import backend_for, rank_device, run_ranks

    dev = torch.device(dev)
    scene, meta, cam, vp, params = _setup(size, dev)
    whole = render_passes(scene, meta, cam, make_film(size, size, dev), 0, None, vp, params, WARMUP + passes)[0]
    whole = whole.sum.cpu().numpy()
    platform = "gpu" if dev.type == "cuda" else "cpu"
    lines, results = {}, {}
    for n in counts:
        backend = backend_for(n, dev)
        work = os.path.join(WORK_DIR, f"{n}ranks-{os.getpid()}")
        os.makedirs(work, exist_ok=True)
        init_file = os.path.join(work, "rendezvous")
        if os.path.exists(init_file):
            os.remove(init_file)
        t0 = time.perf_counter()
        done = run_ranks(lambda r: [os.path.abspath(__file__), "worker", str(r), str(n), init_file, work,
                                    rank_device(r, dev), backend, str(size), str(passes)], n, work, RANK_TIMEOUT_S)
        for r, (code, text) in enumerate(done):
            if code != 0 or "RANK_OK" not in text:
                raise SystemExit(f"FAIL: scaling bench, {n} ranks [{backend}]: rank {r} exited {code}:\n{text[-3000:]}")
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(n)]
        for r, o in enumerate(ranks):
            sl = slice(int(o["row0"]), int(o["row0"]) + int(o["rows"]))
            if not np.array_equal(o["band"], whole[sl]):
                raise SystemExit(f"FAIL: scaling bench, {n} ranks: rank {r}'s band differs from the one-process "
                                 f"render's rows {sl.start}..{sl.stop - 1}")
        dt = max(float(o["seconds_per_pass"]) for o in ranks)
        rays = float(ranks[0]["rays_a_pass"])
        results[n] = (dt, rays / dt / 1e6, backend)
        line = {"metric": f"scaling_rays_per_sec_{n}dev", "value": round(rays / dt / 1e6, 4), "unit": "Mray/s",
                "platform": platform, "devices": n, "backend": backend, "seconds_per_pass": round(dt, 5),
                "shared_device": backend == "gloo"}
        t1, thr1, _ = results[counts[0]]
        if backend == "gloo":
            line["overhead_n"] = round(dt / t1, 4)
        else:
            line["efficiency_n"] = round(rays / dt / 1e6 / (n * thr1), 4)
        lines[n] = line
        out(json.dumps(line))
        log(f"scaling: {n} ranks [{backend}] bands bit-equal to the one-process render's rows; "
            f"{time.perf_counter() - t0:.1f} s from spawn to the last exit")
    n_max = counts[-1]
    shared = lines[n_max]["shared_device"]
    t1, thr1, _ = results[counts[0]]
    tn, thrn, _ = results[n_max]
    summary = {"metric": "scaling_overhead" if shared else "scaling_efficiency",
               "value": round(tn / t1 if shared else thrn / (n_max * thr1), 4), "unit": "ratio", "platform": platform,
               "devices": n_max, "backend": lines[n_max]["backend"],
               "semantics": ("sharding overhead T_n / T_1, ranks sharing one device (ideal 1.0)" if shared
                             else "strong-scaling efficiency thr_n / (n thr_1), one card a rank")}
    out(json.dumps(summary))
    return lines, summary


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        rank, world, init_file, out_dir, device, backend, size, passes = sys.argv[2:10]
        return worker(int(rank), int(world), init_file, out_dir, device, backend, int(size), int(passes))
    ap = argparse.ArgumentParser()
    ap.add_argument("device", nargs="?", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--counts", default="1,2,4")
    ap.add_argument("--passes", type=int, default=4)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to run on the CPU")
    run(args.device, tuple(int(c) for c in args.counts.split(",")), args.size, args.passes)


if __name__ == "__main__":
    main()
