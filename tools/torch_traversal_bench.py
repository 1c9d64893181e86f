"""Every mesh traversal engine of the port side by side (counterpart of
``tools/traversal_bench.py``): closest-hit and any-hit on coherent
(camera-like) and incoherent (bounce-like) rays over a heightfield mesh.

    python tools/torch_traversal_bench.py [cuda|cpu] [n_tris] [n_rays] [only]

Defaults: the card, 200,000 triangles, 2^20 rays, every engine (``only``:
a comma list of ``cluster``, ``bvh``, ``pallas``, ``wave``, ``wave2``,
``sorted``).  The mesh and both ray sets are the reference's at seed 7
(``make_mesh`` here is a jax-free copy of ``traversal_bench.make_mesh``,
the rays ``torch_check_traverse``'s copies), drawn from one generator in
the reference's order.  For each ray set and engine, one line each for
closest-hit and any-hit (any-hit rays 4.0 long): ms a call by CUDA events
(a warm-up call, then 3 timed calls, or 1 where the warm-up took over a
second), Mray/s, hit or occluded share, overflow share, agreement with
wave2 (tri ids; occlusion for any-hit) on the rays that neither engine
flags as overflow (``bvh`` reports in leaf order, mapped back to the mesh's
order; it flags nothing), peak device memory and the kernel launches.
Every engine traces all 2^20 rays at once (the largest, ``cluster``, peaks
at 7.01 GiB on an 80 GB H100), so none runs in windows.  Nothing is
caught: an engine that fails fails the tool.

``chip_smoke.py`` phase 24 calls ``run`` on the card.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_check_traverse import coherent_rays, incoherent_rays, vec  # noqa: E402

from raytracer_tpu_torch.ops import bvh_traverse as bt  # noqa: E402
from raytracer_tpu_torch.ops import cluster_traverse as ct  # noqa: E402
from raytracer_tpu_torch.ops import pallas_traverse as pt  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.ops import wave_traverse as wv  # noqa: E402
from raytracer_tpu_torch.ops.cuda_build import launch_counts  # noqa: E402
from raytracer_tpu_torch.scene.bvh import build_bvh_over_triangles  # noqa: E402
from raytracer_tpu_torch.scene.clusters import build_clusters  # noqa: E402

ENGINES = ("cluster", "bvh", "pallas", "wave", "wave2", "sorted")
SHADOW_T = 4.0
BIGF = 3.0e38


def make_mesh(t, rng, spread=4.0, size=0.12):
    """Surface-like mesh: a wavy heightfield grid with ~t triangles, as
    (v0, e1, e2) float32 arrays (``tools/traversal_bench.py::make_mesh``)."""
    g = max(2, int(np.sqrt(t / 2)) + 1)
    xs = np.linspace(-spread, spread, g, dtype=np.float32)
    zs = np.linspace(-spread, spread, g, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs)
    Y = (
        0.8 * np.sin(X * 1.7) * np.cos(Z * 1.3)
        + 0.3 * np.sin(X * 5.1 + Z * 3.7)
        + rng.normal(0, 0.02, X.shape)
    ).astype(np.float32)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    idx = np.arange(g * g).reshape(g, g)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, d], axis=1), np.stack([a, d, c], axis=1)], axis=0)
    tri = verts[faces]  # (F, 3, 3)
    v0 = tri[:, 0]
    return v0, tri[:, 1] - v0, tri[:, 2] - v0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _time(fn, dev):
    """(the result, ms a call): a warm-up call, then 3 timed calls (1 where
    the warm-up took over a second), by CUDA events on the card."""
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    reps = 1 if time.perf_counter() - t0 > 1.0 else 3
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


class Bench:
    """The mesh, its cluster set and BVH on ``dev``; ``run_engine`` times one
    engine on one ray set against the wave2 answers of that set."""

    def __init__(self, n_tris: int, dev, log=print, seed=7):
        self.dev, self.log = torch.device(dev), log
        self.rng = np.random.default_rng(seed)
        v0, e1, e2 = make_mesh(n_tris, self.rng)
        self.n_tris = v0.shape[0]
        t0 = time.perf_counter()
        self.cs = build_clusters(v0, e1, e2, device=self.dev)
        log(f"clusters: {self.cs.num_clusters} x {self.cs.tris_per_cluster} ({self.cs.num_supers} supers) in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        tri_v = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float32)
        zero = np.zeros_like(tri_v)
        # the material column carries each triangle's own index into leaf order
        arrays, self.bvh = build_bvh_over_triangles(tri_v, zero, zero[..., :2], np.arange(self.n_tris, dtype=np.int32),
                                                    device=self.dev)
        self.leaf_to_mesh = torch.as_tensor(arrays[5], device=self.dev)
        log(f"bvh build: {time.perf_counter() - t0:.2f} s  nodes={self.bvh.num_nodes}")

    def closest(self, engine, o, d, tl):
        """(t, tri, u, v, overflow) of ``engine`` with tri ids in the mesh's order."""
        cs = self.cs
        if engine == "bvh":
            t, tri, u, v = bt.bvh_closest_hit(self.bvh, None, o, d, tl)
            tri = torch.where(tri >= 0, self.leaf_to_mesh[tri.clamp_min(0).long()], tri)
            return t, tri, u, v, torch.zeros_like(tri, dtype=torch.bool)
        fn = {"cluster": ct.cluster_closest_hit, "pallas": pt.pallas_cluster_closest_hit, "wave": wv.wave_closest_hit,
              "wave2": w2.wave2_closest_hit, "sorted": pt.pallas_sorted_closest_hit}[engine]
        return fn(cs, o, d, tl)

    def any_hit(self, engine, o, d, tl):
        """(occluded, overflow) of ``engine``."""
        cs = self.cs
        if engine == "bvh":
            occ = bt.bvh_any_hit(self.bvh, None, o, d, tl)
            return occ, torch.zeros_like(occ)
        if engine == "pallas":
            occ = pt.pallas_cluster_any_hit(cs, o, d, tl)
            return occ, torch.zeros_like(occ)
        fn = {"cluster": ct.cluster_any_hit, "wave": wv.wave_any_hit, "wave2": w2.wave2_any_hit,
              "sorted": pt.pallas_sorted_any_hit}[engine]
        return fn(cs, o, d, tl)

    def run_engine(self, engine, label, o, d, ref=None):
        """Both queries of ``engine`` on the (n, 3) rays ``o``, ``d``.
        ``ref``: wave2's {"closest": ..., "any": ...} on them.  Returns
        {"closest": figures, "any": figures, "answers": ...}."""
        dev, n = self.dev, o.shape[0]
        ro, rd = vec(o, dev), vec(d, dev)
        out, answers = {}, {}
        for query, tl, call in (("closest", BIGF, self.closest), ("any", SHADOW_T, self.any_hit)):
            counts0 = launch_counts()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            res, ms = _time(lambda: call(engine, ro, rd, tl), dev)
            peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
            launches = dict(launch_counts() - counts0)
            hit = res[1] >= 0 if query == "closest" else res[0]
            ovf = res[-1]
            fig = {"ms": ms, "mrays_per_sec": n / ms / 1e3, "hit_share": float(hit.float().mean()),
                   "overflow_share": float(ovf.float().mean()), "peak_gib": peak, "launches": launches}
            if ref is not None:
                r = ref[query]
                both = ~ovf & ~r[-1]
                same = (res[1] == r[1]) if query == "closest" else (res[0] == r[0])
                fig["agree_vs_wave2"] = float(same[both].float().mean()) if bool(both.any()) else float("nan")
                fig["compared"] = int(both.sum())
            out[query] = fig
            answers[query] = res
            self.log(f"[{label}] {engine} {'closest' if query == 'closest' else 'any-hit'}: {ms:10.2f} ms  "
                     f"{fig['mrays_per_sec']:9.2f} Mray/s  {'hits' if query == 'closest' else 'occl'}="
                     f"{fig['hit_share']:.4f} ovf={fig['overflow_share']:.4f}"
                     + (f"  agree-vs-wave2={fig['agree_vs_wave2']:.5f} on {fig['compared']} rays" if ref else "")
                     + (f"  peak {peak:.2f} GiB" if dev.type == "cuda" else "")
                     + f"  launches {launches}")
        out["answers"] = answers
        return out


def run(n_tris=200_000, n_rays=1 << 20, only=None, dev="cuda", log=print):
    """The shootout (module docstring).  Returns (the Bench, {label: {engine:
    run_engine's figures}})."""
    dev = torch.device(dev)
    log(f"device: {torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'cpu (plain versions)'}  "
        f"tris~{n_tris}  rays={n_rays}")
    bench = Bench(n_tris, dev, log)
    engines = [e for e in ENGINES if only is None or e in only]
    results = {}
    for label, mk in (("coherent", lambda n: coherent_rays(n)), ("incoherent", lambda n: incoherent_rays(n, bench.rng))):
        o_np, d_np = mk(n_rays)
        o, d = torch.as_tensor(o_np, device=dev), torch.as_tensor(d_np, device=dev)
        ref = bench.run_engine("wave2", label, o, d)
        results[label] = {"wave2": ref}
        for engine in engines:
            if engine != "wave2":
                results[label][engine] = bench.run_engine(engine, label, o, d, ref["answers"])
        if "wave2" not in engines:
            del results[label]["wave2"]
    return bench, results


def main():
    args = sys.argv[1:]
    on_card = (args.pop(0) if args and args[0] in ("cuda", "cpu") else "cuda") == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to run the plain versions on the CPU")
    n_tris = int(args[0]) if len(args) > 0 else 200_000
    n_rays = int(args[1]) if len(args) > 1 else 1 << 20
    only = args[2].split(",") if len(args) > 2 else None
    run(n_tris, n_rays, only, "cuda" if on_card else "cpu")


if __name__ == "__main__":
    main()
