"""Micro-benchmarks of the port's hot functions (counterpart of
``tools/microbench.py``): each is warmed up, then timed over a wavefront;
one JSON line a bench, with the reference's names and units.

    python tools/torch_microbench.py [--cpu] [--n 1048576] [--iters 10]

Runs on the CUDA device unless ``--cpu`` (and refuses to run without one).
Each line also names the device.  The benches: ``ray_triangle``
(``ops/bvh_traverse.py``'s Möller-Trumbore over n lanes),
``bsdf_sample_all_lobes`` / ``bsdf_evaluate_all_lobes`` (rough metal),
``rng_hash_uniform``, ``tonemap_aces`` (1024^2), ``env_distribution_sample``
(256 x 512), ``scene_traverse_cornell`` and ``scene_traverse_mesh_bvh``
(``random_mesh_scene()`` under the default traversal mode).  A time is the
host clock over ``iters`` calls between two device synchronisations.
``chip_smoke.py`` phase 24 calls ``main``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytracer_tpu_torch.color.colorhelpers import tonemap  # noqa: E402
from raytracer_tpu_torch.math.distribution import make_distribution_2d, sample_2d  # noqa: E402
from raytracer_tpu_torch.math.vec import Vec3, normalize  # noqa: E402
from raytracer_tpu_torch.ops.bsdf import MatParams, evaluate, sample  # noqa: E402
from raytracer_tpu_torch.ops.bvh_traverse import _moller_trumbore  # noqa: E402
from raytracer_tpu_torch.ops.traverse import scene_traverse  # noqa: E402
from raytracer_tpu_torch.sampler.sampler import hash_u32, u32_to_unit_float  # noqa: E402
from raytracer_tpu_torch.scene.presets import cornell_box, random_mesh_scene  # noqa: E402

BENCHES = ("ray_triangle", "bsdf_sample_all_lobes", "bsdf_evaluate_all_lobes", "rng_hash_uniform", "tonemap_aces",
           "env_distribution_sample", "scene_traverse_cornell", "scene_traverse_mesh_bvh")


def _time(fn, dev, iters):
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    fn()  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def main(argv=None, out=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give --cpu to run on the CPU")
    dev = torch.device("cpu" if args.cpu else "cuda")
    device_name = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    n = args.n
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def vec3(scale=1.0, offset=0.0):
        return Vec3(*(f32(rng.uniform(-1, 1, n) * scale + offset) for _ in range(3)))

    results = []

    def bench(name, seconds, unit_count, unit="Mop/s"):
        r = {"bench": name, "rate": round(unit_count / seconds / 1e6, 2), "unit": unit,
             "time_us": round(seconds * 1e6, 1), "device": device_name}
        results.append(r)
        out(json.dumps(r))

    o = vec3(0.1)
    d = Vec3(torch.zeros(n, device=dev), torch.zeros(n, device=dev), torch.ones(n, device=dev))
    geom = f32(rng.uniform(-1, 1, (n, 9)))
    bench("ray_triangle", _time(lambda: _moller_trumbore(geom, o, d), dev, args.iters), n, "Mtests/s")

    full = lambda v, dt=torch.float32: torch.full((n,), v, dtype=dt, device=dev)
    mp = MatParams(bsdf=full(6, torch.int32), base_color=vec3(0.5, 0.5), emission=vec3(0.0), roughness=full(0.3),
                   metalness=full(1.0), ior=full(1.5), k=full(4.0), dispersive=torch.zeros(n, dtype=torch.bool, device=dev))
    wo = normalize(Vec3(full(0.3), full(0.1), full(0.9)))
    u = f32(rng.random((3, n)))
    bench("bsdf_sample_all_lobes", _time(lambda: sample(mp, wo, u[0], u[1], u[2]), dev, args.iters), n, "Msamples/s")
    bench("bsdf_evaluate_all_lobes", _time(lambda: evaluate(mp, wo, wo), dev, args.iters), n, "Mevals/s")

    ids = torch.arange(n, dtype=torch.int64, device=dev)
    bench("rng_hash_uniform", _time(lambda: u32_to_unit_float(hash_u32(ids)), dev, args.iters), n)

    img = f32(rng.random((1024, 1024, 3))) * 4.0
    bench("tonemap_aces", _time(lambda: tonemap(img), dev, args.iters), img.numel() // 3, "Mpx/s")

    dist = make_distribution_2d(rng.random((256, 512)), device=dev)
    u1, u2 = f32(rng.random(n)), f32(rng.random(n))
    bench("env_distribution_sample", _time(lambda: sample_2d(dist, u1, u2), dev, args.iters), n, "Msamples/s")

    scene, _ = cornell_box(device=dev)
    o2 = vec3(0.4)
    d2 = normalize(vec3(1.0))
    bench("scene_traverse_cornell", _time(lambda: scene_traverse(scene, o2, d2), dev, args.iters), n, "Mrays/s")

    mscene, _ = random_mesh_scene(device=dev)
    bench("scene_traverse_mesh_bvh", _time(lambda: scene_traverse(mscene, o2, d2), dev, args.iters), n, "Mrays/s")
    return results


if __name__ == "__main__":
    main()
