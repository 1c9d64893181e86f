"""wave2's front-to-back extraction and its other settings on the card
(``chip_smoke.py`` phase 25).

    python tools/torch_check_wave2_config.py [cpu]

What it checks and measures, on mesh200k (``tools/bench_mesh.py``) and the
800k-triangle hall (``tools/torch_gen_interior.py``):

- ``ftb_kernel_windows``: the ``wave2_mt`` kernel against its plain twin,
  bit for bit and timed with CUDA events, on the chunks of a front-to-back
  first round at kc = 4 and of the continuation round after it (up to
  ``NSUB`` unresolved rays from their cursors, capped at their hits),
  closest-hit and any-hit.
- ``chunk_child``: a child process with ``RT_WAVE2_CHUNK=256`` (read at
  import; 2 rows a chunk): the kernel against its twin on a mesh200k window
  and a hall window at 2 rows a chunk, the mesh200k window's hits (to be
  held bit for bit against this process's at 1,024), and a 512^2 mesh200k
  render (1 warm-up + 1 timed pass).
- ``engine_kernel_vs_twin``: the engine under front to back, kernel path
  against twin path: t, tri ids and occlusion bit-equal.
- ``engine_modes``: front to back at kc = 4 and 6 against id order at
  kc = 16 on 2^20 coherent and incoherent rays, closest-hit and any-hit:
  t bit-equal on every ray that neither mode flags, tri ids equal but at
  ties in t (counted), occlusion equal; ms, rounds, continuation
  iterations, pair slots, host syncs and overflow of each.
- ``timed_passes``: 512^2 MIS depth-6 renders under a setting (front to
  back, ``RT_WAVE2_SPATIAL_KEY=0``, the ablation switches), each against
  the default render at the same seed and pass count: bit-equal, or under
  front to back equal on at least ``FTB_EQUAL_PIXELS`` of pixels.

Every setting is put into the environment only around the call that uses
it (``mock.patch.dict``).  With ``cpu`` the checks run on the CPU at a small size
(a rehearsal: the kernel wrapper takes its twin there); with no argument and
no card the script exits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
sys.path.insert(0, ROOT)
sys.path.insert(0, TOOLS)

import torch_check_traverse as tct  # noqa: E402
from torch_check_traverse import BIGF, check, coherent_rays, incoherent_rays, twin_engine, vec  # noqa: E402

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.ops.cuda_build import launch_counts  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams  # noqa: E402

# every wave2 setting of the environment; chip_smoke.py runs with none set
SETTINGS = ("RT_WAVE2_FTB", "RT_WAVE2_KC", "RT_WAVE2_CHUNK", "RT_WAVE2_NSUB", "RT_WAVE2_SPATIAL_KEY",
            "RT_WAVE2_SKIP_KERNEL", "RT_SKIP_TRI_FRAME")
FTB_KCS = (4, 6)
CHILD_CHUNK = 256
# the share of pixels on which a front-to-back render must equal the
# default's: they may differ only where two triangles tie in t
FTB_EQUAL_PIXELS = 0.99


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _bits(x):
    return x.view(torch.int32)


# --- the kernel on front-to-back windows --------------------------------------------


def ftb_chunks(cs, o, d, tl, dev, kc=w2.KC_FTB, any_hit=False):
    """The kernel's inputs on the front-to-back path of the (n, 3) rays with
    limit ``tl``: the first round's joined chunks and the first
    continuation round's (up to ``NSUB`` unresolved rays, from their cursor
    keys, capped at their hits).  Returns (first, continuation, the rays
    left unresolved by the first round)."""
    ro, rd = vec(o, dev), vec(d, dev)
    n = o.shape[0]
    tl = torch.as_tensor(tl, dtype=torch.float32, device=dev).expand(n).contiguous()
    kc = min(kc, cs.num_supers)
    cursor = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def chunks(rays, lim, cur):
        cand, _, _ = w2._p1_extract_ftb(cs, *rays, lim, cur, kc)
        join = w2._pair_join(cs, cand, *rays, lim)
        return (join.block_cluster, cs.super_geom, cs.super_sbox, *join.pairs)

    rays = (*ro, *rd)
    first = chunks(rays, tl, cursor)
    t, _, _, _, cur, unres = w2._round(cs, *rays, tl, cursor, kc, any_hit, True)
    sel = torch.sort((~unres).to(torch.int32), stable=True).indices[:min(w2.NSUB, n)]
    cap = torch.where(unres[sel], t[sel], 0.0)
    cont = chunks(tuple(a[sel] for a in rays), cap, cur[sel])
    return first, cont, int(unres.sum())


def ftb_kernel_windows(cs, o, d, reach, dev, log, label, reps=20, plain_reps=2):
    """``wave2_mt`` against its twin on the front-to-back first-round and
    continuation chunks of the rays, closest-hit and any-hit (rays of length
    ``reach``).  Returns {window: check_mt_args' numbers}."""
    out = {}
    for any_hit, tl in ((False, BIGF), (True, reach)):
        first, cont, left = ftb_chunks(cs, o, d, tl, dev, any_hit=any_hit)
        kind = "any-hit" if any_hit else "closest"
        log(f"ftb windows [{label} {kind}]: {o.shape[0]} rays, kc {w2.KC_FTB}: {first[0].shape[0]} chunks in the "
            f"first round, {left} rays unresolved after it, {cont[0].shape[0]} chunks in the continuation round")
        for name, args in (("ftb round 1", first), ("ftb continuation", cont)):
            out[f"{label} {name} {kind}"] = tct.check_mt_args(args, any_hit, log, f"{label} {name}", reps, plain_reps)
    return out


# --- the engine ---------------------------------------------------------------------


def _host_timing():
    """The CPU rehearsal times one call on the host's clock: no CUDA events."""
    def host_ms(fn, reps=1, warmup=0):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    tct.cuda_ms = host_ms


def _timed(fn, dev):
    w2.reset_stats()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3, dict(w2.STATS)


def _stats_text(ms, st, flagged):
    return (f"{ms:.2f} ms, {st['windows']} windows, {st['rounds']} rounds, {st['continuations']} continuation "
            f"iterations (at most {st['max_window_continuations']} in a window), {st['pair_slots']} pair slots, "
            f"{st['host_syncs']} host syncs, overflow {flagged}")


def engine_kernel_vs_twin(cs, o, d, reach, dev, log, label, kc=w2.KC_FTB):
    """The engine under front to back at ``kc``, kernel path against twin
    path: t, tri ids, occlusion and overflow bit-equal."""
    ro, rd = vec(o, dev), vec(d, dev)
    run = lambda: (w2.wave2_closest_hit(cs, ro, rd, BIGF, kc=kc, ftb=True),
                   w2.wave2_any_hit(cs, ro, rd, reach, kc=kc, ftb=True))
    (k_hit, k_occ), ms, st = _timed(run, dev)
    with twin_engine():
        t_hit, t_occ = run()
    log(f"engine ftb kc {kc} [{label}] kernel path: {_stats_text(ms, st, int(k_hit[4].sum()) + int(k_occ[1].sum()))}")
    check(torch.equal(_bits(k_hit[0]), _bits(t_hit[0])) and torch.equal(k_hit[1], t_hit[1])
          and torch.equal(k_hit[4], t_hit[4]), f"engine ftb kc {kc}: closest-hit t, tri ids and overflow equal, "
                                               f"kernel against twin ({label})", log)
    check(torch.equal(k_occ[0], t_occ[0]) and torch.equal(k_occ[1], t_occ[1]),
          f"engine ftb kc {kc}: any-hit equal, kernel against twin ({label})", log)


def engine_modes(cs, o, d, reach, dev, log, label, kcs=FTB_KCS):
    """Front to back at each kc of ``kcs`` against id order at kc 16 on the
    (n, 3) rays.  Returns {mode: {"closest": ..., "any": ...}} with ms, the
    engine's counts and the overflow."""
    ro, rd = vec(o, dev), vec(d, dev)
    res = {}
    base = {}
    for name, kc, ftb in [("id16", 16, False)] + [(f"ftb{k}", k, True) for k in kcs]:
        c, c_ms, c_st = _timed(lambda: w2.wave2_closest_hit(cs, ro, rd, BIGF, kc=kc, ftb=ftb), dev)
        a, a_ms, a_st = _timed(lambda: w2.wave2_any_hit(cs, ro, rd, reach, kc=kc, ftb=ftb), dev)
        res[name] = {"closest": dict(c_st, ms=c_ms, overflow=int(c[4].sum())),
                     "any": dict(a_st, ms=a_ms, overflow=int(a[1].sum()))}
        log(f"engine [{label}] {name} closest: {_stats_text(c_ms, c_st, res[name]['closest']['overflow'])}; "
            f"hit rate {float((c[1] >= 0).float().mean()):.4f}")
        log(f"engine [{label}] {name} any-hit: {_stats_text(a_ms, a_st, res[name]['any']['overflow'])}; "
            f"occluded {float(a[0].float().mean()):.4f}")
        if not ftb:
            base = {"closest": c, "any": a}
            continue
        both = ~c[4] & ~base["closest"][4]
        same_t = torch.equal(_bits(c[0][both]), _bits(base["closest"][0][both]))
        apart = both & (c[1] != base["closest"][1])
        ties = bool(((c[1] >= 0) & (base["closest"][1] >= 0))[apart].all())
        occ_both = ~a[1] & ~base["any"][1]
        same_occ = torch.equal(a[0][occ_both], base["any"][0][occ_both])
        res[name]["tri_apart_at_ties"] = int(apart.sum())
        log(f"engine [{label}] {name} against id16 on the {int(both.sum())} closest-hit rays neither flags: t "
            f"{'bit-equal' if same_t else 'DIFFERENT'}, tri ids apart on {int(apart.sum())} (each a hit of both at "
            f"the same t: {ties}); occlusion {'equal' if same_occ else 'DIFFERENT'} on the {int(occ_both.sum())} "
            f"any-hit rays neither flags")
        check(same_t, f"engine [{label}] {name}: t bit-equal to id order on every ray neither flags", log)
        check(ties, f"engine [{label}] {name}: tri ids apart from id order only at ties in t", log)
        check(same_occ, f"engine [{label}] {name}: occlusion equal to id order", log)
    return res


def frame_rays(scene, cam, n, dev):
    """``n`` camera rays of the frame (a side x side grid over the film)
    and ``n`` bounce rays that leave their hits in seeded random directions
    (rays that hit nothing keep their origin), as two (o, d) pairs of (n, 3)
    float32 numpy arrays."""
    from raytracer_tpu_torch.render.renderer import pixel_grid
    from raytracer_tpu_torch.sampler.sampler import make_stream
    from raytracer_tpu_torch.scene.camera import generate_rays

    side = int(round(n ** 0.5))
    cx, cy, ids = pixel_grid(side, side, device=dev)
    rays, _ = generate_rays(cam, cx, cy, make_stream(ids.to(torch.int64), 0, seed=0))
    o, d = torch.stack(tuple(rays.origin), 1), torch.stack(tuple(rays.dir), 1)
    t, tri = w2.wave2_closest_hit(scene.clusters, vec(o, dev), vec(d, dev), BIGF)[:2]
    bo = torch.where((tri >= 0)[:, None], o + d * (t * (1.0 - 1e-4))[:, None], o)
    bd = np.random.default_rng(12).normal(size=(o.shape[0], 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    np_ = lambda a: a.cpu().numpy().astype(np.float32)
    return (np_(o), np_(d)), (np_(bo), bd)


# --- renders --------------------------------------------------------------------------


def timed_passes(scene, meta, cam, dev, timed, log, label, env=None, size=512):
    """A Viewport of the scene at ``size``^2, depth 6, MIS, seed 0, with
    ``env`` in the environment around its passes: 1 warm-up pass, then
    ``timed`` passes ending with the film on the host.  ``wave2_mt``'s
    launches are counted from just before the first pass to after the last."""
    env = env or {}
    vp = Viewport(scene, meta, cam, ViewportParams(size, size, seed=0), RenderParams(max_depth=6, mis=True), device=dev)
    with mock.patch.dict(os.environ, env):
        counts0 = launch_counts()
        w2.reset_stats()
        t0 = time.perf_counter()
        vp.render(1)
        _sync(dev)
        warm = time.perf_counter() - t0
        before = vp.progress()
        t0 = time.perf_counter()
        if timed:
            vp.render(timed)
        radiance = vp.radiance()
        dt = time.perf_counter() - t0
        launches = (launch_counts() - counts0)["wave2_mt"]
    after = vp.progress()
    rays = after["total_rays"] - before["total_rays"] + after["total_shadow_rays"] - before["total_shadow_rays"]
    out = {"ms": dt / max(timed, 1) * 1e3, "mrays_per_sec": rays / dt / 1e6 if timed else 0.0, "warm_s": warm,
           "launches": launches, "overflow": float(after["total_traversal_overflow"]), "radiance": radiance,
           "finite": bool(np.isfinite(radiance).all()), "stats": dict(w2.STATS), "passes": 1 + timed}
    log(f"{label} {size}^2 depth 6, {env or 'defaults'}: warm-up {warm:.2f} s, {timed} timed passes "
        f"{out['ms']:.1f} ms a pass, {out['mrays_per_sec']:.4f} Mray/s, wave2_mt launches {launches} in "
        f"{1 + timed} passes, overflow {out['overflow']:.0f}, finite {out['finite']}, mean radiance "
        f"{radiance.mean():.6f}; wave2 {out['stats']}")
    return out


def against(a, b):
    """(share of pixels whose three values are equal, largest difference)
    of two radiance arrays."""
    return float((a == b).all(-1).mean()), float(np.abs(a.astype(np.float64) - b).max())


# --- CHUNK = 256 in a child process ---------------------------------------------------------


def chunk_child(out_dir, mesh_json, hall_path, dev_name, size, n_rays):
    """In a process started with ``RT_WAVE2_CHUNK`` = 256: the kernel
    against its twin at 2 rows a chunk on a mesh200k window and a hall
    window, the mesh window's hits and a ``size``^2 mesh render of 1 + 1
    passes, written to ``out_dir``."""
    from raytracer_tpu_torch.io.scene_loader import load_scene

    dev = torch.device(dev_name)
    if dev.type == "cpu":
        _host_timing()
    log = lambda msg: print(f"[CHUNK {w2.CHUNK}] {msg}", flush=True)
    check(w2.CHUNK == CHILD_CHUNK and w2.ROWS == CHILD_CHUNK // 128,
          f"the child reads RT_WAVE2_CHUNK: CHUNK {w2.CHUNK}, {w2.ROWS} rows a chunk", log)
    scene, meta, cam = load_scene(mesh_json, device=dev)
    hall = torch.load(hall_path, map_location=dev, weights_only=False)
    hall_cs = hall["clusters"]
    o, d = incoherent_rays(n_rays, np.random.default_rng(7))
    windows = {"mesh200k incoherent": tct.check_wave2_window(scene.clusters, o, d, 4.0, dev, log,
                                                            label="mesh200k incoherent window", plain_reps=2),
               "interior800k camera": tct.check_wave2_window(hall_cs, hall["o"], hall["d"], hall["reach"], dev, log,
                                                             label="interior800k camera window", plain_reps=2)}
    hits = w2.wave2_closest_hit(scene.clusters, vec(o, dev), vec(d, dev), BIGF)
    occ = w2.wave2_any_hit(scene.clusters, vec(o, dev), vec(d, dev), 4.0)
    render = timed_passes(scene, meta, cam, dev, 1, log, f"mesh200k_mis [CHUNK {w2.CHUNK}]", size=size)
    np.savez(os.path.join(out_dir, "chunk_child.npz"), radiance=render.pop("radiance"),
             **{f"hit_{i}": h.cpu().numpy() for i, h in enumerate(hits)}, occ=occ[0].cpu().numpy())
    with open(os.path.join(out_dir, "chunk_child.json"), "w") as f:
        json.dump({"windows": windows, "render": render, "chunk": w2.CHUNK, "rows": w2.ROWS}, f)


def run_chunk_child(scene, mesh_json, hall_cs, hall_window, dev, log, work_dir, size=512, n_rays=w2.SUBWAVE,
                    timeout=300):
    """``chunk_child`` in a child process with ``RT_WAVE2_CHUNK`` = 256 (its
    output logged line by line), then its mesh window's hits against this
    process's at ``CHUNK`` (t, tri ids, u, v, overflow and occlusion bit-equal).
    Returns its windows, its render's numbers and its radiance."""
    os.makedirs(work_dir, exist_ok=True)
    hall_path = os.path.join(work_dir, "hall_window.pt")
    torch.save({"clusters": hall_cs, "o": hall_window[0], "d": hall_window[1], "reach": hall_window[2]}, hall_path)
    env = dict(os.environ, RT_WAVE2_CHUNK=str(CHILD_CHUNK), PYTHONPATH=ROOT)
    cmd = [sys.executable, os.path.abspath(__file__), "chunk-child", work_dir, mesh_json, hall_path, str(dev),
           str(size), str(n_rays)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    for line in (res.stdout + res.stderr).splitlines():
        log(line)
    check(res.returncode == 0, f"the RT_WAVE2_CHUNK={CHILD_CHUNK} child exited 0 ({time.perf_counter() - t0:.1f} s "
                               f"from spawn to exit)", log)
    with open(os.path.join(work_dir, "chunk_child.json")) as f:
        got = json.load(f)
    z = np.load(os.path.join(work_dir, "chunk_child.npz"))
    o, d = incoherent_rays(n_rays, np.random.default_rng(7))
    here = w2.wave2_closest_hit(scene.clusters, vec(o, dev), vec(d, dev), BIGF)
    occ = w2.wave2_any_hit(scene.clusters, vec(o, dev), vec(d, dev), 4.0)[0].cpu().numpy()
    same = [np.array_equal(np.asarray(z[f"hit_{i}"]).view(np.int32), h.cpu().numpy().view(np.int32))
            for i, h in enumerate(here)]
    log(f"mesh200k window at CHUNK {got['chunk']} against CHUNK {w2.CHUNK}: t, tri, u, v, overflow equal {same}, "
        f"occlusion equal {np.array_equal(z['occ'], occ)}")
    check(all(same) and np.array_equal(z["occ"], occ),
          f"CHUNK {got['chunk']}: the engine's hits bit-equal to CHUNK {w2.CHUNK}'s", log)
    got["render"]["radiance"] = z["radiance"]
    return got


# --- phase 25 -------------------------------------------------------------------------


def check_clean_environment(log=print, when="at start"):
    """Fails where a wave2 setting is in the environment: the defaults are
    what the script measures, and each setting is set only around its own
    measurement."""
    found = sorted(k for k in SETTINGS if k in os.environ)
    check(not found, f"no wave2 setting in the environment {when} ({found or 'none found'})", log)


def run(mesh, mesh_json, hall, dev, log, *, size=512, n_engine=1 << 20, n_window=w2.SUBWAVE, reps=20,
        work_dir=None):
    """Phase 25 on ``mesh`` and ``hall`` ((scene, meta, cam) each; the mesh
    scene's file ``mesh_json`` for the child): mesh200k's rays are the
    traversal bench's (``coherent_rays``, ``incoherent_rays``), the hall's
    its frame's (``frame_rays``).  Returns {"windows": {scene: {window:
    numbers}}, "launches": {render: n}, "summary": [lines], "renders": ...,
    "modes": ...}."""
    (mscene, mmeta, mcam), (hscene, hmeta, hcam) = mesh, hall
    hreach = float(hmeta.scene_radius)
    windows, launches, summary = {}, {}, []
    rng = np.random.default_rng(25)
    o_inc, d_inc = incoherent_rays(n_window, np.random.default_rng(7))
    (ho, hd), _ = frame_rays(hscene, hcam, n_window, dev)

    # a. the kernel on front-to-back windows at kc 4
    t0 = time.perf_counter()
    windows["mesh200k"] = ftb_kernel_windows(mscene.clusters, o_inc, d_inc, 4.0, dev, log, "mesh200k incoherent",
                                             reps=reps)
    windows["interior800k"] = ftb_kernel_windows(hscene.clusters, ho, hd, hreach, dev, log, "interior800k camera",
                                                 reps=reps)
    log(f"phase 25 a (kernel on ftb windows) wall time {time.perf_counter() - t0:.1f} s")

    # b. the engine: kernel path against twin path, then the modes against id order
    t0 = time.perf_counter()
    engine_kernel_vs_twin(mscene.clusters, o_inc, d_inc, 4.0, dev, log, "mesh200k incoherent")
    engine_kernel_vs_twin(hscene.clusters, ho, hd, hreach, dev, log, "interior800k camera")
    modes = {}
    for scene_label, cs, reach in (("mesh200k", mscene.clusters, 4.0), ("interior800k", hscene.clusters, hreach)):
        rays = ({"coherent": coherent_rays(n_engine), "incoherent": incoherent_rays(n_engine, rng)}
                if scene_label == "mesh200k" else
                dict(zip(("coherent", "incoherent"), frame_rays(hscene, hcam, n_engine, dev))))
        for ray_label, (o, d) in rays.items():
            modes[f"{scene_label} {ray_label}"] = engine_modes(cs, o, d, reach, dev, log,
                                                               f"{scene_label} {ray_label} {n_engine} rays")
    for key, per in modes.items():
        summary.append(f"summary phase 25 engine [{key}]: " + "; ".join(
            f"{m} closest {v['closest']['ms']:.1f} ms ({v['closest']['rounds']} rounds, "
            f"{v['closest']['continuations']} continuations, {v['closest']['pair_slots']} pair slots, "
            f"{v['closest']['host_syncs']} syncs, ovf {v['closest']['overflow']}), any {v['any']['ms']:.1f} ms "
            f"({v['any']['rounds']} rounds, ovf {v['any']['overflow']})"
            + (f", tri apart at ties {v['tri_apart_at_ties']}" if "tri_apart_at_ties" in v else "")
            for m, v in per.items()))
    log(f"phase 25 b (engine modes) wall time {time.perf_counter() - t0:.1f} s")

    # c. renders: the defaults, front to back, the pair key without its spatial part
    t0 = time.perf_counter()
    renders = {}
    renders["mesh200k id16"] = timed_passes(mscene, mmeta, mcam, dev, 2, log, "mesh200k_mis [wave2 id16]", size=size)
    renders["mesh200k ftb4"] = timed_passes(mscene, mmeta, mcam, dev, 2, log, "mesh200k_mis [wave2 ftb4]",
                                            env={"RT_WAVE2_FTB": "1"}, size=size)
    renders["mesh200k id16 2 passes"] = timed_passes(mscene, mmeta, mcam, dev, 1, log, "mesh200k_mis [wave2 id16]",
                                                     size=size)
    renders["mesh200k spatial_key 0"] = timed_passes(mscene, mmeta, mcam, dev, 1, log,
                                                     "mesh200k_mis [wave2 SPATIAL_KEY=0]",
                                                     env={"RT_WAVE2_SPATIAL_KEY": "0"}, size=size)
    renders["interior800k id16"] = timed_passes(hscene, hmeta, hcam, dev, 2, log, "interior800k_mis [wave2 id16]",
                                                size=size)
    renders["interior800k ftb4"] = timed_passes(hscene, hmeta, hcam, dev, 2, log, "interior800k_mis [wave2 ftb4]",
                                                env={"RT_WAVE2_FTB": "1"}, size=size)
    log(f"phase 25 c (renders) wall time {time.perf_counter() - t0:.1f} s")

    # d. CHUNK = 256 in a child process
    t0 = time.perf_counter()
    child = run_chunk_child(mscene, mesh_json, hscene.clusters, (ho, hd, hreach), dev, log,
                            work_dir or os.path.join(ROOT, "raytracer_tpu_torch", "_build", "phase25"), size=size,
                            n_rays=n_window)
    windows["mesh200k CHUNK 256"] = child["windows"]
    renders["mesh200k chunk 256"] = child["render"]
    log(f"phase 25 d (CHUNK {CHILD_CHUNK}) wall time {time.perf_counter() - t0:.1f} s")

    # e. the ablation switches, each set around one pass alone
    t0 = time.perf_counter()
    renders["mesh200k skip_kernel"] = timed_passes(mscene, mmeta, mcam, dev, 1, log,
                                                   "mesh200k_mis [RT_WAVE2_SKIP_KERNEL=1]",
                                                   env={"RT_WAVE2_SKIP_KERNEL": "1"}, size=size)
    check(renders["mesh200k skip_kernel"]["launches"] == 0, "RT_WAVE2_SKIP_KERNEL: the passes launched no kernel", log)
    renders["mesh200k skip_tri_frame"] = timed_passes(mscene, mmeta, mcam, dev, 1, log,
                                                      "mesh200k_mis [RT_SKIP_TRI_FRAME=1]",
                                                      env={"RT_SKIP_TRI_FRAME": "1"}, size=size)
    check_clean_environment(log, "after the ablations")
    log(f"phase 25 e (ablation switches) wall time {time.perf_counter() - t0:.1f} s")

    # each against the default render of the same scene, seed and pass count
    base = {("mesh200k", 3): renders["mesh200k id16"], ("mesh200k", 2): renders["mesh200k id16 2 passes"],
            ("interior800k", 3): renders["interior800k id16"]}
    for key, r in renders.items():
        check(r["finite"], f"{key}: radiance finite", log)
        if "id16" in key or "skip" in key:  # the ablations' films are not the renderer's
            continue
        check(r["radiance"].mean() > 0 and (r["launches"] > 0 or torch.device(dev).type == "cpu"),
              f"{key}: non-zero mean radiance, wave2_mt launched", log)
        ref = base[(key.split()[0], r["passes"])]
        eq, diff = against(r["radiance"], ref["radiance"])
        r["equal_pixels"], r["max_diff"] = eq, diff
        log(f"{key} against the default render at the same seed ({r['passes']} passes): {eq:.6f} of pixels equal, "
            f"largest difference {diff:.3e}")
        if "ftb" not in key:  # the same hits: front to back may differ only where two triangles tie in t
            check(diff == 0.0, f"{key}: the radiance is the default render's, bit for bit", log)
        else:  # a tie in t is rare: a pixel whose paths met one is the exception
            check(eq >= FTB_EQUAL_PIXELS, f"{key}: the radiance is the default render's on at least "
                                          f"{FTB_EQUAL_PIXELS:.0%} of pixels", log)
    for key in ("mesh200k ftb4", "interior800k ftb4"):
        launches[key] = renders[key]["launches"]
    launches["mesh200k chunk 256"] = renders["mesh200k chunk 256"]["launches"]
    launches["mesh200k spatial_key 0"] = renders["mesh200k spatial_key 0"]["launches"]
    for key, r in renders.items():
        summary.append(f"summary phase 25 render [{key}] {size}^2: {r['ms']:.1f} ms a pass, {r['mrays_per_sec']:.4f} "
                       f"Mray/s, wave2_mt launches {r['launches']} in {r['passes']} passes, overflow "
                       f"{r['overflow']:.0f}, finite {r['finite']}"
                       + (f", against the defaults: {r['equal_pixels']:.6f} of pixels equal, largest difference "
                          f"{r['max_diff']:.3e}" if "equal_pixels" in r else ""))
    return {"windows": windows, "launches": launches, "summary": summary, "renders": renders, "modes": modes}


def main():
    import bench_mesh
    from raytracer_tpu_torch.io.scene_loader import load_scene

    args = sys.argv[1:]
    if args and args[0] == "chunk-child":
        out_dir, mesh_json, hall_path, dev_name, size, n_rays = args[1:7]
        chunk_child(out_dir, mesh_json, hall_path, dev_name, int(size), int(n_rays))
        return
    on_card = not (args and args[0] == "cpu")
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to rehearse on the CPU at a small size")
    check_clean_environment()
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    work = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "phase25")
    bench_mesh.BENCH_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "bench_scene")
    if on_card:
        import torch_gen_interior

        mesh_json = bench_mesh.ensure_scene(200_000)
        hall = load_scene(torch_gen_interior.ensure_interior(os.path.join(ROOT, "raytracer_tpu_torch", "_build",
                                                                          "interior")), device=dev)
        sizes = {}
    else:
        mesh_json = bench_mesh.ensure_scene(2000)
        hall = load_scene(mesh_json, device=dev)
        sizes = dict(size=16, n_engine=4096, n_window=2048, reps=1)
        _host_timing()
    out = run(load_scene(mesh_json, device=dev), mesh_json, hall, dev, print, work_dir=work, **sizes)
    for line in out["summary"]:
        print(line)


if __name__ == "__main__":
    main()
