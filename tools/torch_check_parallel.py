"""Multi-device rendering of the PyTorch port (``parallel/mesh.py`` and
VCM's band mode) driven on the card: ``chip_smoke.py`` phase 22.

    python tools/torch_check_parallel.py [cuda|cpu]
    python tools/torch_check_parallel.py worker RANK WORLD INIT_FILE MESH_JSON OUT_DIR DEVICE

``band_runs`` is what one rank does: mesh200k at 512^2, depth 6, MIS, 2
passes through ``render_pass_sharded`` (the Viewport's Halton vectors, its
``wave2_mt`` launches counted); one VCM pass of the Cornell box at 512^2
through ``render_pass_vcm_sharded``; one ``train_step_sharded`` on the
Cornell box at 64^2, depth 4, pass 1.

- ``world_of_one`` (22 a): this process alone in a group (NCCL on the card,
  ``init_method`` a ``file://``): the band runs bit-equal to the unsharded
  functions (``Viewport`` film and counters, ``render_pass_vcm``,
  ``train_step``); the group is destroyed before it returns.
- ``two_ranks`` (22 b): two processes of this file (``worker``) in a gloo
  group, each rendering its band on the same card (NCCL refuses two ranks
  on one device; gloo's collectives take the CUDA tensors through the host,
  explicitly, and count the bytes): each band bit-equal to the same rows of
  (a)'s film, the counters (summed over the group) equal to (a)'s, the VCM
  bands within the reference's bound of sharded against one-device VCM,
  rtol 2e-4 / atol 2e-5, the train step's loss within rtol 1e-5 and its
  gradients within rtol 2e-4 / atol 1e-6 (``tests/test_parallel.py``);
  ``wave2_mt`` launched in each rank; each rank's ms a pass and its host
  bytes.  The parent reads both children's exit codes, with a timeout.

A failed check raises SystemExit through ``check``.  ``main`` runs (a) and
(b) on the card; given ``cpu`` it rehearses them on the CPU at 32^2 (a gloo
group of one for (a)); with no argument and no card it exits.
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

import torch_check_integrators as tci  # noqa: E402
from torch_check_traverse import check  # noqa: E402

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.integrators.vcm import VcmParams, render_pass_vcm  # noqa: E402
from raytracer_tpu_torch.io.scene_loader import load_scene  # noqa: E402
from raytracer_tpu_torch.ops.cuda_build import launch_counts  # noqa: E402
from raytracer_tpu_torch.parallel import mesh as pm  # noqa: E402
from raytracer_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from raytracer_tpu_torch.render.film import make_film  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams  # noqa: E402
from raytracer_tpu_torch.sampler.sampler import halton_frame_vector  # noqa: E402

VCM_RTOL, VCM_ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
CHILD_TIMEOUT_S = 600


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def band_runs(mesh_scene, cornell, dev, mesh, size=512, train_size=64):
    """One rank's work (module docstring).  Returns numpy arrays and
    figures: this rank's bands, the summed counters, the loss and the 7
    gradient leaves, ms a pass, wave2_mt launches, host bytes."""
    scene, meta, cam = mesh_scene
    vp, params = ViewportParams(size, size, seed=0), RenderParams(max_depth=6, mis=True)
    row0, rows = pm._band(mesh, size)
    film = pm.film_sharding(make_film(size, size, dev), mesh)
    counts0 = launch_counts()
    total, ms = None, []
    for p in range(2):
        halton = torch.as_tensor(halton_frame_vector(p), device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        film, counters = pm.render_pass_sharded(scene, meta, cam, film, p, halton, vp, params, mesh)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        total = counters if total is None else type(counters)(*(a + b for a, b in zip(total, counters)))
    out = dict(row0=row0, rows=rows, band_sum=film.sum.cpu().numpy(), band_secondary=film.secondary_sum.cpu().numpy(),
               counters=np.array([float(c) for c in total]), launches=(launch_counts() - counts0)["wave2_mt"],
               ms=np.array(ms))
    cs, cm, cc = cornell
    _sync(dev)
    t0 = time.perf_counter()
    vcm_band = pm.render_pass_vcm_sharded(cs, cm, cc, pm.film_sharding(make_film(size, size, dev), mesh), 0, vp,
                                          params, mesh, vcm=VcmParams())
    _sync(dev)
    out["vcm_ms"] = (time.perf_counter() - t0) * 1e3
    out["vcm_band"] = vcm_band.sum.cpu().numpy()
    tvp = ViewportParams(train_size, train_size, seed=0)
    loss, grads = pm.train_step_sharded(cs, cm, cc, torch.full((train_size, train_size, 3), 0.25, device=dev), 1, tvp,
                                        RenderParams(max_depth=4, mis=True), mesh)
    out["loss"] = float(loss)
    out["grads"] = np.stack([g.cpu().numpy() for g in (*grads[0], *grads[1], grads[2])])
    out["host_bytes"] = pm.STATS.host_bytes
    return out


def world_of_one(mesh_scene, cornell, dev, log, work_dir, backend="nccl", size=512, train_size=64):
    """Phase 22 a.  Returns (the band runs, whole-frame references)."""
    os.makedirs(work_dir, exist_ok=True)
    rendezvous = os.path.join(work_dir, f"rendezvous-one-{os.getpid()}")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    pm.init_distributed(f"file://{rendezvous}", 1, 0, backend)
    try:
        mesh = pm.make_mesh()
        log(f"world of one: backend {torch.distributed.get_backend()}, mesh {mesh.mesh.tolist()} "
            f"{mesh.mesh_dim_names}, device type {mesh.device_type}")
        got = band_runs(mesh_scene, cornell, dev, mesh, size, train_size)
        whole = pm.gather_film(pm.film_sharding(make_film(4, 4, dev), mesh), mesh)
        check(tuple(whole.sum.shape) == (4, 4, 3), "gather_film of a world of one is the whole film", log)
    finally:
        torch.distributed.destroy_process_group()
    check(not torch.distributed.is_initialized(), "the group is destroyed", log)

    scene, meta, cam = mesh_scene
    vp = Viewport(scene, meta, cam, ViewportParams(size, size, seed=0), RenderParams(max_depth=6, mis=True),
                  device=dev).render(2)
    film_same = np.array_equal(got["band_sum"], vp.film.sum.cpu().numpy()) and \
        np.array_equal(got["band_secondary"], vp.film.secondary_sum.cpu().numpy())
    cs, cm, cc = cornell
    vcm = render_pass_vcm(cs, cm, cc, make_film(size, size, dev), 0, None, ViewportParams(size, size, seed=0),
                          RenderParams(max_depth=6, mis=True), VcmParams()).sum.cpu().numpy()
    loss, grads = pm.train_step(cs, cm, cc, torch.full((train_size, train_size, 3), 0.25, device=dev), 1,
                                ViewportParams(train_size, train_size, seed=0), RenderParams(max_depth=4, mis=True))
    grads = np.stack([g.cpu().numpy() for g in (*grads[0], *grads[1], grads[2])])
    log(f"world of one [{backend}]: mesh200k {size}^2 2 passes {got['ms'].round(1).tolist()} ms, film "
        f"{'bit-equal' if film_same else 'DIFFERENT'} to the Viewport's; rays {got['counters'][0]:.0f} against "
        f"{vp.total_rays:.0f}; wave2_mt launches {got['launches']}; VCM {got['vcm_ms']:.1f} ms, "
        f"{'bit-equal' if np.array_equal(got['vcm_band'], vcm) else 'DIFFERENT'} to render_pass_vcm; train step loss "
        f"{got['loss']:.8g} against {float(loss):.8g}, gradients "
        f"{'bit-equal' if np.array_equal(got['grads'], grads) else 'DIFFERENT'}; host bytes {got['host_bytes']}")
    check(film_same, "render_pass_sharded in a world of one equals the Viewport's film bit for bit", log)
    check(got["counters"][0] == vp.total_rays and got["counters"][1] == vp.total_shadow_rays,
          "the world of one's counters are the Viewport's", log)
    check(np.array_equal(got["vcm_band"], vcm), "render_pass_vcm_sharded in a world of one equals render_pass_vcm", log)
    check(got["loss"] == float(loss) and np.array_equal(got["grads"], grads),
          "train_step_sharded in a world of one equals train_step bit for bit", log)
    on_card = torch.device(dev).type == "cuda"  # the CPU takes the twin, which counts no launch
    check(got["launches"] > 0 or not on_card, "the world of one's mesh render launched wave2_mt", log)
    check(np.isfinite(vcm).all() and vcm.mean() > 0 and np.isfinite(grads).all(), "VCM and gradients finite", log)
    return got, {"film_sum": got["band_sum"], "film_secondary": got["band_secondary"], "counters": got["counters"],
                 "vcm_sum": vcm, "loss": float(loss), "grads": grads}


def two_ranks(mesh_json, one, dev, log, work_dir, size=512, train_size=64):
    """Phase 22 b: spawn the two gloo ranks and hold them against ``one``
    (phase 22 a's whole-frame results).  Returns each rank's figures."""
    os.makedirs(work_dir, exist_ok=True)
    rendezvous = os.path.join(work_dir, f"rendezvous-two-{os.getpid()}")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    t0 = time.perf_counter()
    done = run_ranks(lambda rank: [os.path.abspath(__file__), "worker", str(rank), "2", rendezvous, mesh_json,
                                   work_dir, str(dev), str(size), str(train_size)], 2, work_dir, CHILD_TIMEOUT_S)
    for rank, (code, text) in enumerate(done):
        log(f"gloo rank {rank}: exit {code}; its log ends:\n{text[-1500:]}")
        check(code == 0 and "RANK_OK" in text, f"gloo rank {rank} ran to its end within {CHILD_TIMEOUT_S} s", log)
    log(f"two gloo ranks on one card: {time.perf_counter() - t0:.1f} s from spawn to both exits")
    ranks = []
    for rank in range(2):
        r = dict(np.load(os.path.join(work_dir, f"rank{rank}.npz")))
        sl = slice(int(r["row0"]), int(r["row0"]) + int(r["rows"]))
        band_same = np.array_equal(r["band_sum"], one["film_sum"][sl]) and \
            np.array_equal(r["band_secondary"], one["film_secondary"][sl])
        vcm_ok = np.allclose(r["vcm_band"], one["vcm_sum"][sl], rtol=VCM_RTOL, atol=VCM_ATOL)
        vcm_err = float(np.abs(r["vcm_band"] - one["vcm_sum"][sl]).max())
        loss_rel = abs(float(r["loss"]) - one["loss"]) / abs(one["loss"])
        grads_ok = np.allclose(r["grads"], one["grads"], rtol=GRAD_RTOL, atol=GRAD_ATOL)
        log(f"gloo rank {rank}: rows {sl.start}..{sl.stop - 1}, mesh200k ms a pass {r['ms'].round(1).tolist()}, "
            f"wave2_mt launches {int(r['launches'])}; band {'bit-equal' if band_same else 'DIFFERENT'} to the world "
            f"of one's rows; counters {r['counters'][:2].tolist()} against {one['counters'][:2].tolist()}; VCM "
            f"{float(r['vcm_ms']):.1f} ms, largest difference {vcm_err:.3e} against the world of one; loss relative "
            f"difference {loss_rel:.3e}, gradients largest difference "
            f"{float(np.abs(r['grads'] - one['grads']).max()):.3e}; host bytes {int(r['host_bytes'])}")
        check(band_same, f"gloo rank {rank}: its mesh200k band equals the world of one's rows bit for bit", log)
        check(np.array_equal(r["counters"], one["counters"]), f"gloo rank {rank}: the counters' sum is the frame's", log)
        check(vcm_ok, f"gloo rank {rank}: its VCM band within rtol {VCM_RTOL} / atol {VCM_ATOL} of the world of one's",
              log)
        check(loss_rel <= LOSS_RTOL and grads_ok, f"gloo rank {rank}: the train step within the reference's bounds", log)
        on_card = torch.device(dev).type == "cuda"
        check(int(r["launches"]) > 0 or not on_card, f"gloo rank {rank}: wave2_mt launched", log)
        check(int(r["host_bytes"]) > 0 or not on_card,
              f"gloo rank {rank}: the CUDA tensors went through the host", log)
        ranks.append({k: r[k] for k in ("launches", "ms", "vcm_ms", "host_bytes")})
    return ranks


def worker(rank, world, init_file, mesh_json, out_dir, dev, size, train_size):
    """One gloo rank of ``two_ranks``, on ``dev``."""
    pm.init_distributed(f"file://{init_file}", world, rank, "gloo")
    mesh_scene = load_scene(mesh_json, device=dev)
    out = band_runs(mesh_scene, tci.port_cornell(dev), dev, pm.make_mesh(), size, train_size)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "raytracer_tpu"))
    check(not foreign, f"rank {rank} imported no jax and nothing of the JAX package", print)
    print("RANK_OK", rank, flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        rank, world, init_file, mesh_json, out_dir, dev, size, train_size = sys.argv[2:10]
        return worker(int(rank), int(world), init_file, mesh_json, out_dir, dev, int(size), int(train_size))
    arg = sys.argv[1] if len(sys.argv) > 1 else None
    if arg != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to rehearse on the CPU")
    import bench_mesh

    dev = "cpu" if arg == "cpu" else "cuda"
    small = dev == "cpu"
    bench_mesh.BENCH_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "bench_scene")
    mesh_json = bench_mesh.ensure_scene(2000 if small else 200_000)
    size, train_size = (32, 16) if small else (512, 64)
    work = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "parallel")
    _, one = world_of_one(load_scene(mesh_json, device=dev), tci.port_cornell(dev), dev, print, work,
                          backend="gloo" if small else "nccl", size=size, train_size=train_size)
    two_ranks(mesh_json, one, dev, print, work, size=size, train_size=train_size)
    print("multi-device checks passed")


if __name__ == "__main__":
    main()
