"""The frame-loop extras of the PyTorch port driven on one device:
``chip_smoke.py`` phase 21.

    python tools/torch_check_frameloop.py [cuda|cpu]

- ``adaptive_run`` (21 a): ``render/adaptive.py::AdaptiveViewport`` at
  512^2, depth 6, MIS, wave2, ``AdaptiveSettings()`` at the reference's
  defaults, 8 passes.  After pass 4, before any adaptation has changed what
  is traced, its radiance must equal the uniform ``Viewport``'s 4-pass
  radiance bit for bit (the same pixels, pass keys and hits, in block order
  rather than row order); then each pass's active blocks and pixels,
  converged share, error in dB, ms, rays and ``wave2_mt`` launches.
  ``wavefront_window`` gives the camera rays of an adapted pass's wavefront
  (the active blocks' pixels in block order, padded with pixel 0), on which
  ``chip_smoke.py`` holds ``wave2_mt`` against its twin.
- ``checkpoint_resume`` (21 b): 2 passes, ``save_checkpoint``, a fresh
  ``Viewport`` that loads it and renders 2 more: the film equal bit for bit
  to a straight 4-pass film; the seconds to save and to load, the file's
  size.
- ``path_replay`` (21 c): ``render/path_debug.py::debug_pixel_path`` of one
  pixel on the device against the CPU port: vertex count, ids, BSDF events
  and termination equal, floats within rtol 1e-5; the ms of one replay
  (its wave2 windows hold one ray).  On a large mesh the CPU side may run
  under ``bvh``, the port's exact walk: wave2's plain twin computes every
  super-cluster's chunk, sentinels too, and took 151 s for the 800k hall
  pixel's three one-ray traversals on the card host's 8 cores.
- ``packed_codecs`` (21 d): every codec of ``math/packed.py`` over 2^20
  seeded lanes, the device's codes and decoded values bit-equal to the
  CPU's; ms per codec.

A failed check raises SystemExit through ``check``.  ``main`` runs (b),
(c) on the Cornell box, (a) at 128^2 on it and (d), on the card; given
``cpu`` it rehearses them on the CPU at 32^2 (device and CPU are then the
same); with no argument and no card it exits without running anything.
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
from raytracer_tpu_torch.math import packed  # noqa: E402
from raytracer_tpu_torch.math.vec import Vec3  # noqa: E402
from raytracer_tpu_torch.ops import traverse  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.ops.cuda_build import launch_counts  # noqa: E402
from raytracer_tpu_torch.render.adaptive import AdaptiveSettings, AdaptiveViewport  # noqa: E402
from raytracer_tpu_torch.render.film import average_radiance  # noqa: E402
from raytracer_tpu_torch.render.path_debug import debug_pixel_path  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams  # noqa: E402
from raytracer_tpu_torch.sampler.sampler import blue_noise_for_pixels, halton_frame_vector, make_stream  # noqa: E402
from raytracer_tpu_torch.scene.camera import generate_rays  # noqa: E402

REPLAY_RTOL = 1e-5
PACKED_LANES = 1 << 20


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def adaptive_run(scene, meta, cam, dev, log, label, uniform4=None, size=512, passes=8, depth=6):
    """``AdaptiveViewport`` (reference defaults) for ``passes`` passes, one
    at a time.  ``uniform4``: the uniform Viewport's (H, W, 3) radiance
    after 4 passes, which the adaptive radiance after pass 4 must equal bit
    for bit.  Returns (the viewport, {per-pass figures, wave2_mt launches,
    ms a pass})."""
    av = AdaptiveViewport(scene, meta, cam, ViewportParams(size, size, seed=0), RenderParams(max_depth=depth, mis=True),
                          AdaptiveSettings(), device=dev)
    counts0 = launch_counts()
    per_pass = []
    for p in range(passes):
        rays0 = av.total_rays
        lanes = int(av._active_ids()[0].shape[0]) if av.blocks else 0
        _sync(dev)
        t0 = time.perf_counter()
        av.render(1)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        pr = av.progress()
        per_pass.append(dict(ms=ms, lanes=lanes, rays=pr["total_rays"] - rays0, **{
            k: pr[k] for k in ("active_blocks", "active_pixels", "converged_fraction", "error_db")}))
        log(f"{label} adaptive pass {p}: {ms:.1f} ms, wavefront {lanes} lanes, rays {pr['total_rays'] - rays0:.0f}; "
            f"after it: active blocks {pr['active_blocks']}, active pixels {pr['active_pixels']}, converged "
            f"{pr['converged_fraction']:.4f}, error {pr['error_db']:.2f} dB")
        if p == 3 and uniform4 is not None:
            got = av.radiance()
            same = np.array_equal(got, uniform4)
            log(f"{label}: adaptive radiance after pass 4 against the uniform Viewport's 4 passes: "
                f"{'bit-equal' if same else 'DIFFERENT'} ({int((got != uniform4).sum())} values apart, largest "
                f"difference {float(np.abs(got - uniform4).max()):.3e})")
            check(same, f"{label}: the adaptive render's first 4 passes equal the uniform render bit for bit", log)
    launches = (launch_counts() - counts0)["wave2_mt"]
    pr = av.progress()
    check(bool(np.isfinite(av.radiance()).all()) and av.radiance().mean() > 0, f"{label}: adaptive radiance finite",
          log)
    check(pr["passes_finished"] == passes, f"{label}: {passes} adaptive passes", log)
    adapted = [q["ms"] for q in per_pass[4:]]
    log(f"{label} adaptive: wave2_mt launches {launches} in {passes} passes; ms a full pass "
        f"{np.mean([q['ms'] for q in per_pass[:4]]):.1f}, an adapted pass {np.mean(adapted) if adapted else 0:.1f}; "
        f"total rays {pr['total_rays']:.0f}")
    return av, {"per_pass": per_pass, "launches": launches}


def wavefront_window(av, dev, n=w2.SUBWAVE):
    """Camera rays of the adaptive viewport's next wavefront (its active
    blocks' pixels in block order, padded with pixel 0; the first ``n``),
    with the pass's sample streams, as (n, 3) origins and directions."""
    ids = av._active_ids()[0][:n]
    vp = av.vp_params
    cx = ((ids % vp.width).to(torch.float32) + 0.5) / vp.width
    cy = 1.0 - ((ids // vp.width).to(torch.float32) + 0.5) / vp.height
    halton = torch.as_tensor(halton_frame_vector(av.passes), device=dev)
    stream = make_stream(ids, av.passes, seed=vp.seed, halton=halton, blue=blue_noise_for_pixels(ids, vp.width))
    rays, _ = generate_rays(av.cam, cx, cy, stream)
    return torch.stack(tuple(rays.origin), 1), torch.stack(tuple(rays.dir), 1)


def checkpoint_resume(scene, meta, cam, dev, log, out_dir, label, straight, size=512, depth=6):
    """2 passes, save, a fresh Viewport that loads and renders 2 more;
    ``straight``: a Viewport of the same scene after 4 passes, whose film
    the resumed one must equal bit for bit.  Returns the figures."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{label}.npz")
    make = lambda: Viewport(scene, meta, cam, ViewportParams(size, size, seed=0),
                            RenderParams(max_depth=depth, mis=True), device=dev)
    first = make().render(2)
    _sync(dev)
    t0 = time.perf_counter()
    first.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = make().load_checkpoint(path)
    _sync(dev)
    load_s = time.perf_counter() - t0
    resumed.render(2)
    same = all(torch.equal(getattr(resumed.film, f), getattr(straight.film, f)) for f in ("sum", "secondary_sum"))
    nbytes = os.path.getsize(path)
    log(f"{label} checkpoint: saved in {save_s:.3f} s ({nbytes} bytes), loaded in {load_s:.3f} s; resumed film after "
        f"4 passes {'bit-equal' if same else 'DIFFERENT'} to the straight film; rays {resumed.total_rays:.0f} "
        f"against {straight.total_rays:.0f}")
    check(same and resumed.film.num_passes == 4 == straight.film.num_passes,
          f"{label}: a resumed render equals the straight render bit for bit", log)
    check(resumed.total_rays == straight.total_rays, f"{label}: the resumed ray count is the straight one's", log)
    return {"save_s": save_s, "load_s": load_s, "bytes": nbytes}


def path_replay(scene, meta, cam, cpu_scene, cpu_cam, pixel, size, depth, dev, log, label, pass_idx=0,
                cpu_mode=None):
    """``debug_pixel_path`` of ``pixel`` on ``dev`` against the CPU port,
    whose traversal runs under ``cpu_mode`` when one is given (the device's
    under the mode set).  Returns (ms of one replay on ``dev``, the path)."""
    vp, params = ViewportParams(size, size, seed=0), RenderParams(max_depth=depth, mis=True)
    t0 = time.perf_counter()
    debug_pixel_path(scene, meta, cam, *pixel, vp, params, pass_idx)  # warm-up
    _sync(dev)
    t1 = time.perf_counter()
    got = debug_pixel_path(scene, meta, cam, *pixel, vp, params, pass_idx)
    t2 = time.perf_counter()
    ms = (t2 - t1) * 1e3
    mode = traverse.get_traversal_mode()
    traverse.set_traversal_mode(cpu_mode or mode)
    try:
        want = debug_pixel_path(cpu_scene, meta, cpu_cam, *pixel, vp, params, pass_idx)
    finally:
        traverse.set_traversal_mode(mode)
    log(f"{label} path replay: warm-up {t1 - t0:.2f} s, the CPU port's replay under {cpu_mode or mode} "
        f"{time.perf_counter() - t2:.2f} s ({torch.get_num_threads()} threads)")
    worst = 0.0
    same = got.termination == want.termination and len(got.vertices) == len(want.vertices)
    for a, b in zip(got.vertices, want.vertices):
        same &= all(getattr(a, f) == getattr(b, f)
                    for f in ("depth", "prim_id", "tri_id", "material_id", "bsdf_event_specular"))
        for f in ("origin", "direction", "hit_distance", "position", "normal", "base_color", "throughput", "bsdf_pdf"):
            x, y = np.atleast_1d(np.asarray(getattr(a, f), np.float64)), np.atleast_1d(np.asarray(getattr(b, f), np.float64))
            worst = max(worst, float((np.abs(x - y) / np.maximum(np.abs(y), 1e-30)).max()))
    log(f"{label} path replay of pixel {pixel} pass {pass_idx}: {ms:.1f} ms; {len(got.vertices)} vertices, tri ids "
        f"{[v.tri_id for v in got.vertices]}, ends {got.termination}; against the CPU port: "
        f"{'same vertices and end' if same else 'DIFFERENT'}, largest relative float difference {worst:.3e}")
    check(same and worst <= REPLAY_RTOL, f"{label}: the path replay on the device equals the CPU port's", log)
    check(len(got.vertices) >= 1, f"{label}: the replayed path hits the scene", log)
    return ms, got


def _codec_inputs(n):
    rng = np.random.default_rng(21)
    u = rng.normal(size=(n, 3))
    u = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    hdr = (rng.uniform(0, 1, (n, 3)) * 10.0 ** rng.uniform(-3, 3, (n, 3))).astype(np.float32)
    return {"oct": u, "rgbe": hdr, "r11g11b10": hdr, "ycocg": hdr, "half": hdr[:, 0] * np.sign(u[:, 0])}


def packed_codecs(dev, log, n=PACKED_LANES):
    """Every codec on ``dev`` against the CPU.  Returns {codec: ms}."""
    inputs = _codec_inputs(n)
    to = lambda a, d: Vec3(*(torch.as_tensor(a[:, i], device=d) for i in range(3))) if a.ndim == 2 \
        else torch.as_tensor(a, device=d)
    pairs = {"oct": ("oct_encode", "oct_decode"), "rgbe": ("rgbe_encode", "rgbe_decode"),
             "r11g11b10": ("r11g11b10_encode", "r11g11b10_decode"), "ycocg": ("rgb_to_ycocg", "ycocg_to_rgb"),
             "half": ("half_encode", "half_decode")}
    as_np = lambda x: np.stack([c.cpu().numpy() for c in x], -1) if isinstance(x, Vec3) else x.cpu().numpy()
    times = {}
    for codec, (enc, dec) in pairs.items():
        x_dev, x_cpu = to(inputs[codec], dev), to(inputs[codec], "cpu")
        getattr(packed, dec)(getattr(packed, enc)(x_dev))  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        code_dev = getattr(packed, enc)(x_dev)
        back_dev = getattr(packed, dec)(code_dev)
        _sync(dev)
        times[codec] = (time.perf_counter() - t0) * 1e3
        code_cpu = getattr(packed, enc)(x_cpu)
        back_cpu = getattr(packed, dec)(code_cpu)
        a, b = as_np(code_dev), as_np(code_cpu)
        bits = np.array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                              b.view(np.uint32) if b.dtype == np.float32 else b)
        da, db = as_np(back_dev), as_np(back_cpu)
        decoded_bits = np.array_equal(da.view(np.uint32), db.view(np.uint32))
        rel = float((np.abs(da - db) / np.maximum(np.abs(db), 1e-30)).max())
        log(f"packed {codec} over {n} lanes on {dev}: encode + decode {times[codec]:.3f} ms; codes "
            f"{'bit-equal' if bits else 'DIFFERENT'} to the CPU's ({a.dtype}); decoded "
            f"{'bit-equal' if decoded_bits else f'largest relative difference {rel:.3e}'}")
        check(bits, f"packed {codec}: the device's codes are the CPU's, bit for bit", log)
        check(decoded_bits, f"packed {codec}: the device's decoded values are the CPU's, bit for bit", log)
    return times


def main():
    arg = sys.argv[1] if len(sys.argv) > 1 else None
    if arg != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to rehearse on the CPU")
    dev = "cpu" if arg == "cpu" else "cuda"
    size = 32 if dev == "cpu" else 128
    scene, meta, cam = tci.port_cornell(dev)
    cpu_scene, _, cpu_cam = tci.port_cornell("cpu")
    straight = Viewport(scene, meta, cam, ViewportParams(size, size, seed=0), RenderParams(max_depth=6, mis=True),
                        device=dev).render(4)
    checkpoint_resume(scene, meta, cam, dev, print, os.path.join(ROOT, "raytracer_tpu_torch", "_build", "checkpoints"),
                      "cornell", straight, size=size)
    adaptive_run(scene, meta, cam, dev, print, "cornell", uniform4=average_radiance(straight.film).cpu().numpy(),
                 size=size, passes=6)
    path_replay(scene, meta, cam, cpu_scene, cpu_cam, (size // 2, size * 3 // 4), size, 6, dev, print, "cornell")
    packed_codecs(dev, print, n=PACKED_LANES if dev != "cpu" else 1 << 14)
    print("frame-loop checks passed")


if __name__ == "__main__":
    main()
