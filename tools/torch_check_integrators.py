"""The other integrators of the PyTorch port (light tracer, VCM, the debug
renderer, the traversal counters) and its command-line entry point, driven
on one device: ``chip_smoke.py`` phases 17 to 19.

    python tools/torch_check_integrators.py [cuda|cpu]

- ``entry_point`` (phase 17): ``cli.main`` in process on the Cornell box,
  ``--renderer`` mis, lt and vcm (``--max-depth 10``; the CLI gives VCM
  ``max_path_length`` 10): seconds, Mray/s as the CLI prints them, mean
  radiance; the PNG and BMP outputs decode to ``Viewport.image()``'s
  pixels; LT, and VCM without merging, against MIS (the full VCM's
  difference logged beside its photon grid's overfull cells); then LT and
  VCM on the device against the port on the CPU, and a VCM pass run twice
  on the device.
- ``hall_integrators`` (phase 18): one LT and one VCM pass on a mesh scene
  under wave2: time, rays and shadow rays, peak memory, ``wave2_mt``
  launches, photons stored and grid cells over ``max_per_cell``; a VCM
  pass profiled; the first 65,536 vertex-connection rays that need an
  answer, for ``wave2_mt`` against its twin.
- ``debug_and_counters`` (phase 19): ``render_debug`` in every mode,
  ``TriangleID`` on the device against the CPU on a crop of the rays (both
  under ``bvh``) and, under wave2, the kernel against its twin on the
  device, a MIS
  pass with ``count_traversal``, and the instanced scene's traversal cost
  beside the baked one's.

A failed check raises SystemExit through ``check``.  ``main`` runs phase 17
on the card at 512^2, or, given ``cpu``, at 32^2 on the CPU (a rehearsal
of its control flow; the CPU-against-CPU comparison is then trivial); with
no argument and no card it exits without running anything.

Two facts of the reference shape these checks.  The light tracer does not
render emitters the camera sees directly (a light path ends where it hits a
light), so LT is held against MIS on the pixels whose camera ray does not
meet a light, dilated by one pixel.  The Cornell box's walls lie on the
photon grid's cell boundaries (cell 0.1 at the default radius; the walls
at 0, +-1, 2), so a last-bit difference in a wall photon's position moves
it to the neighbouring cell and changes which ``max_per_cell`` photons a
query keeps: films with merging are compared between devices on the same
box shifted off the grid (``shifted_cornell``), and the unshifted box's
difference is logged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_check_traverse import check, twin_engine  # noqa: E402

from raytracer_tpu_torch import cli  # noqa: E402
from raytracer_tpu_torch.integrators import light_tracer as lt  # noqa: E402
from raytracer_tpu_torch.integrators import vcm as vcm_mod  # noqa: E402
from raytracer_tpu_torch.integrators.debug import ALL_MODES, MODE_TRIANGLE_ID, render_debug  # noqa: E402
from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.io.bmp import read_bmp  # noqa: E402
from raytracer_tpu_torch.io.png import read_png  # noqa: E402
from raytracer_tpu_torch.math.transform import RigidTransform  # noqa: E402
from raytracer_tpu_torch.ops import traverse as trv  # noqa: E402
from raytracer_tpu_torch.ops.cuda_build import launch_counts  # noqa: E402
from raytracer_tpu_torch.ops.traverse import scene_hit_frame, scene_traversal_cost, scene_traverse  # noqa: E402
from raytracer_tpu_torch.render.film import make_film  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams, pixel_grid  # noqa: E402
from raytracer_tpu_torch.sampler.sampler import make_stream  # noqa: E402
from raytracer_tpu_torch.scene import build, types as T  # noqa: E402
from raytracer_tpu_torch.scene.camera import Rays, generate_rays, make_camera  # noqa: E402
from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw  # noqa: E402

OFFSET = (0.0173, 0.0291, -0.0137)  # moves every wall of the Cornell box off the photon grid's cell boundaries
# the CPU parity tests' tolerance for films (tests/test_torch_light_tracer.py, test_torch_vcm.py)
FILM_RTOL, FILM_ATOL = 1e-4, 1e-6


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def shifted_cornell(build_mod, rigid_transform, types_mod, offset=OFFSET):
    """The Cornell box of ``scene/presets.py`` with every object and the
    light moved by ``offset``, as a builder of the package whose ``build``
    module, ``RigidTransform`` and ``types`` module are given (the tests
    build the JAX package's with the same code).  Returns (builder, camera
    transform kwargs, camera kwargs)."""
    b = build_mod.SceneBuilder()
    mat = lambda name, color: b.add_material(build_mod.MaterialDesc(name=name, bsdf="diffuse", base_color=color))
    white, red, green = mat("white", (0.73,) * 3), mat("red", (0.63, 0.065, 0.05)), mat("green", (0.14, 0.45, 0.09))
    at = lambda p, euler: rigid_transform(translation=tuple(a + o for a, o in zip(p, offset)), euler_deg=euler)
    b.add_rect(at((0, 0, 0), (-90, 0, 0)), (1.0, 1.0), white)
    b.add_rect(at((0, 2, 0), (90, 0, 0)), (1.0, 1.0), white)
    b.add_rect(at((0, 1, 1), (180, 0, 0)), (1.0, 1.0), white)
    b.add_rect(at((-1, 1, 0), (0, 90, 0)), (1.0, 1.0), red)
    b.add_rect(at((1, 1, 0), (0, -90, 0)), (1.0, 1.0), green)
    b.add_box(at((-0.35, 0.6, 0.35), (0, 20, 0)), (0.3, 0.6, 0.3), white)
    b.add_box(at((0.4, 0.3, -0.25), (0, -18, 0)), (0.3, 0.3, 0.3), white)
    b.add_light(build_mod.LightDesc(kind=types_mod.LIGHT_AREA, color=(18.0,) * 3,
                                    transform=at((0, 2 - 1e-3, 0), (90, 0, 0)),
                                    shape_kind=types_mod.SHAPE_RECT, shape_param=(0.25, 0.25, 0.0)))
    t_kw, c_kw = cornell_camera_kw()
    t_kw = dict(translation=tuple(a + o for a, o in zip(t_kw["translation"], offset)))
    return b, t_kw, c_kw


def port_cornell(dev, shifted=False):
    """(scene, meta, camera) of the Cornell box, or of ``shifted_cornell``."""
    if shifted:
        b, t_kw, c_kw = shifted_cornell(build, RigidTransform, T)
        scene, meta = b.build(dev)
    else:
        scene, meta = cornell_box(device=dev)
        t_kw, c_kw = cornell_camera_kw()
    return scene, meta, make_camera(RigidTransform(**t_kw), **c_kw, device=dev)


def scene_on(x, dev):
    """A copy of a scene (or any tree of NamedTuples, tuples and tensors)
    with every tensor on ``dev``."""
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [scene_on(y, dev) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: scene_on(getattr(x, f.name), dev) for f in dataclasses.fields(x)})
    return x


def camera_rays(cam, size, dev):
    """The frame's pixel-centre camera rays (no jitter, pass 0)."""
    cx, cy, pixel_ids = pixel_grid(size, size, device=dev)
    return generate_rays(cam, cx, cy, make_stream(pixel_ids.to(torch.int64), 0, seed=0))[0]


def sees_light(scene, cam, size, dev) -> np.ndarray:
    """(size, size) bool: pixels whose centre ray meets a light first,
    dilated by one pixel (the anti-aliasing jitter spreads a light's edge)."""
    rays = camera_rays(cam, size, dev)
    hits = scene_traverse(scene, rays.origin, rays.dir)
    frame = scene_hit_frame(scene, hits._replace(t=torch.clamp(hits.t, 0.0, 1e12)), rays.origin, rays.dir)
    lit = (frame.light_id >= 0).reshape(1, 1, size, size).float()
    return F.max_pool2d(lit, 3, 1, 1)[0, 0].bool().cpu().numpy()


def run_cli(argv, log):
    """``cli.main(argv)`` in process with ``--stats-json``: (return code,
    stats, the Viewport it rendered with, the image it wrote)."""
    seen = []
    image = Viewport.image

    def record(self):
        out = image(self)
        seen.append((self, out))
        return out

    buf = io.StringIO()
    Viewport.image = record
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--stats-json"])
    finally:
        Viewport.image = image
    out = buf.getvalue().strip().splitlines()
    stats = json.loads(out[-1]) if rc == 0 and out else None
    vp, img = seen[-1] if seen else (None, None)
    return rc, stats, vp, img


def films_agree(a, b, label, log):
    """Device film against the CPU film, per pixel within the CPU parity
    tests' tolerance; logs the worst pixel.  Returns whether they agree."""
    a, b = a.cpu().double(), b.cpu().double()
    excess = (a - b).abs() - (FILM_ATOL + FILM_RTOL * b.abs())
    worst = np.unravel_index(int(excess.argmax()), tuple(a.shape))
    ok = bool((excess <= 0).all())
    log(f"{label}: device vs CPU film sums, {int((excess > 0).sum())} of {excess.numel()} values outside rtol "
        f"{FILM_RTOL} / atol {FILM_ATOL}; worst pixel {worst[:2]} channel {worst[2]}: device {float(a[worst]):.9g}, "
        f"CPU {float(b[worst]):.9g}, max abs diff {float((a - b).abs().max()):.3e}")
    return ok


def device_against_cpu(dev, log, size=64):
    """Two passes (pass 0 and pass 1) of LT and of VCM at ``size``^2 on the
    device and on the CPU, film after film: on the shifted box within the
    CPU parity tests' tolerance, on the unshifted box logged (its walls lie
    on cell boundaries)."""
    params = RenderParams(max_depth=10, mis=True)
    vcm = vcm_mod.VcmParams(max_path_length=10)
    vpp = ViewportParams(size, size, seed=0)
    for shifted in (True, False):
        scenes = {d: port_cornell(d, shifted) for d in (dev, "cpu")}
        for name in ("lt", "vcm"):
            films = {d: make_film(size, size, d) for d in (dev, "cpu")}
            for pass_idx in (0, 1):
                for d, (scene, meta, cam) in scenes.items():
                    if name == "lt":
                        films[d] = lt.render_pass_light_tracer(scene, meta, cam, films[d], pass_idx, None, vpp, params)[0]
                    else:
                        films[d] = vcm_mod.render_pass_vcm(scene, meta, cam, films[d], pass_idx, None, vpp, params, vcm)
                label = f"{'shifted' if shifted else 'grid-aligned'} Cornell {size}^2 {name} after pass {pass_idx}"
                ok = films_agree(films[dev].sum, films["cpu"].sum, label, log)
                if shifted:
                    check(ok, f"{label}: the device's film equals the CPU's within rtol {FILM_RTOL} / atol {FILM_ATOL}")


def entry_point(dev, log, out_dir, size=512, passes=4, small=64):
    """Phase 17: the command-line entry point on the Cornell box.  Returns
    {renderer: stats}."""
    os.makedirs(out_dir, exist_ok=True)
    extra = ["--cpu"] if torch.device(dev).type == "cpu" else []
    scene, meta, cam = port_cornell(dev)
    mask = sees_light(scene, cam, size, dev)
    out = {}
    for name, ext in (("mis", ".bmp"), ("lt", ".png"), ("vcm", ".png")):
        path = os.path.join(out_dir, f"cornell_{name}{ext}")
        argv = ["--renderer", name, "--width", str(size), "--height", str(size), "--passes", str(passes),
                "--max-depth", "10", "--output", path, "--hdr-output", os.path.join(out_dir, f"cornell_{name}.exr")]
        rc, stats, vp, img = run_cli(argv + extra, log)
        check(rc == 0 and stats is not None, f"cli.main --renderer {name} exits 0 and prints its stats line")
        radiance = vp.radiance()
        decoded = (read_png if ext == ".png" else read_bmp)(path)
        stats.update(mean=float(radiance.mean()), mean_off_lights=float(radiance[~mask].mean()))
        log(f"cli [{name}] Cornell {size}^2, {passes} passes, --max-depth 10: {stats['seconds']} s "
            f"({stats['seconds'] / passes * 1e3:.1f} ms a pass), {stats['mrays_per_sec']} Mray/s as the CLI prints "
            f"it (rays {stats['total_rays']:.0f}, shadow rays {stats['total_shadow_rays']:.0f}), mean radiance "
            f"{stats['mean']:.6f}, off the {int(mask.sum())} pixels that see a light {stats['mean_off_lights']:.6f}")
        check(bool(np.isfinite(radiance).all()) and stats["mean"] > 0, f"cli [{name}]: radiance finite, mean > 0")
        check(decoded.shape == img.shape == (size, size, 3) and np.array_equal(decoded, img),
              f"cli [{name}]: the {ext} output decodes to Viewport.image()'s pixels")
        out[name] = stats
    mis, lt_, vc = out["mis"], out["lt"], out["vcm"]
    rel_lt = abs(lt_["mean_off_lights"] - mis["mean_off_lights"]) / mis["mean_off_lights"]
    log(f"cli: LT mean {lt_['mean']:.6f} against MIS {mis['mean']:.6f} over the whole frame (LT renders no emitter "
        f"the camera sees); off the lights {lt_['mean_off_lights']:.6f} against {mis['mean_off_lights']:.6f}: "
        f"relative difference {rel_lt:.4f}")
    check(rel_lt <= 0.05, "LT's mean off the lights within rtol 0.05 of MIS's (tests/test_light_tracer.py's bound)")

    # vertex connection alone (VCM without merging, the reference's BDPT
    # check) over the same passes; then the full VCM's grid
    vpp, params = ViewportParams(size, size, seed=0), RenderParams(max_depth=10, mis=True)
    film = make_film(size, size, dev)
    for i in range(passes):
        film = vcm_mod.render_pass_vcm(scene, meta, cam, film, i, None, vpp, params,
                                       vcm_mod.VcmParams(max_path_length=10, use_vertex_merging=False))
    bdpt = (film.sum / passes).cpu().numpy()
    rel_bdpt = abs(float(bdpt[~mask].mean()) - mis["mean_off_lights"]) / mis["mean_off_lights"]
    runs = []
    full = lambda: runs.append(vcm_mod.render_pass_vcm(scene, meta, cam, make_film(size, size, dev), 1, None, vpp,
                                                       params, vcm_mod.VcmParams(max_path_length=10)).sum)
    stored, over, most = grid_fill(full, 8)
    full()
    rel_vcm = abs(vc["mean"] - mis["mean"]) / mis["mean"]
    rel_vcm_off = abs(vc["mean_off_lights"] - mis["mean_off_lights"]) / mis["mean_off_lights"]
    out["bdpt"] = {"mean": float(bdpt.mean()), "mean_off_lights": float(bdpt[~mask].mean())}
    out["vcm"].update(photons=stored, cells_over=over, fullest_cell=most)
    log(f"VCM without merging, {passes} passes: mean {bdpt.mean():.6f}, off the lights {bdpt[~mask].mean():.6f} "
        f"against MIS's {mis['mean_off_lights']:.6f}: relative difference {rel_bdpt:.4f}")
    log(f"cli: VCM mean {vc['mean']:.6f} against MIS {mis['mean']:.6f}: relative difference {rel_vcm:.4f}; off the "
        f"lights {vc['mean_off_lights']:.6f} against {mis['mean_off_lights']:.6f}: {rel_vcm_off:.4f}.  Its photon grid "
        f"at pass 1: {stored} photons, {over} cells over max_per_cell = 8 (the fullest {most}); a query merges the "
        f"first 8 of a cell's run, as in the reference")
    check(rel_bdpt <= 0.03, "VCM without merging: mean off the lights within rtol 0.03 of MIS's "
                            "(tests/test_vcm.py::test_bdpt_matches_mis's bound)")

    merge_truncation(dev, log, size=small * 2)
    if torch.device(dev).type != "cpu":
        device_against_cpu(dev, log, small)
    # the same VCM pass twice on the device: the splat's sort and the grid's
    # stable sort make it repeat bit for bit
    check(torch.equal(runs[0], runs[1]), f"a VCM pass (pass 1, merging on) at {size}^2 repeats bit for bit on {dev}")
    return out


def merge_truncation(dev, log, size=128, passes=4, cells=(8, 64)):
    """The full VCM's mean off the lights against MIS's on the Cornell box
    at ``size``^2 with a query keeping ``max_photons_per_cell`` of each
    cell's run at each of ``cells``: the bias of the merge shrinks as the
    grid keeps more of the photons a query's radius holds."""
    scene, meta, cam = port_cornell(dev)
    mask = sees_light(scene, cam, size, dev)
    vpp, params = ViewportParams(size, size, seed=0), RenderParams(max_depth=10, mis=True)
    mis = Viewport(scene, meta, cam, vpp, params, device=dev).render(passes).radiance()
    rel = {}
    for m in cells:
        film = make_film(size, size, dev)
        for i in range(passes):
            film = vcm_mod.render_pass_vcm(scene, meta, cam, film, i, None, vpp, params,
                                           vcm_mod.VcmParams(max_path_length=10, max_photons_per_cell=m))
        got = (film.sum / passes).cpu().numpy()
        rel[m] = float(got[~mask].mean()) / float(mis[~mask].mean()) - 1.0
        log(f"VCM at {size}^2, {passes} passes, max_photons_per_cell {m}: mean off the lights {got[~mask].mean():.6f} "
            f"against MIS's {mis[~mask].mean():.6f}: {rel[m]:+.4f}")
    check(abs(rel[cells[-1]]) < abs(rel[cells[0]]), "the full VCM's bias shrinks when a query keeps more photons a cell")
    return rel


def traced_rays(run, n_pixels, window=65_536):
    """``run()`` with the integrators' traversals counted: (rays of the
    closest-hit queries, rays of the shadow queries with a positive limit,
    the vertex-connection queries' rays with a positive limit, up to
    ``window`` of them, as (origin, direction, limit))."""
    count = {"rays": 0, "shadow": 0, "connection": []}

    def traverse(scene, origin, direction, *a, **kw):
        count["rays"] += origin.x.shape[0]
        return trv.scene_traverse(scene, origin, direction, *a, **kw)

    def occluded(scene, origin, direction, t_max):
        live = t_max > 0
        count["shadow"] += int(live.sum())
        have = sum(c[2].shape[0] for c in count["connection"])
        if origin.x.shape[0] > n_pixels and have < window:  # D x pixels lanes: a connection
            keep = torch.nonzero(live).squeeze(1)[:window - have]
            count["connection"].append((torch.stack(tuple(c[keep] for c in origin), 1),
                                        torch.stack(tuple(c[keep] for c in direction), 1), t_max[keep]))
        return trv.scene_occluded(scene, origin, direction, t_max)

    for m in (lt, vcm_mod):
        m.scene_traverse, m.scene_occluded = traverse, occluded
    try:
        run()
    finally:
        for m in (lt, vcm_mod):
            m.scene_traverse, m.scene_occluded = trv.scene_traverse, trv.scene_occluded
    return count


def grid_fill(run, max_per_cell):
    """``run()`` with VCM's photon grid kept: (photons stored, cells that
    hold more than ``max_per_cell`` photons, the fullest cell's count)."""
    kept = []
    build_grid = vcm_mod.build_hash_grid

    def keep(positions, radius):
        grid = build_grid(positions, radius)
        kept.append((grid, positions))
        return grid

    vcm_mod.build_hash_grid = keep
    try:
        run()
    finally:
        vcm_mod.build_hash_grid = build_grid
    grid, positions = kept[-1]
    stored = positions.x < vcm_mod.PARK * 0.5
    ids = grid.cell_ids[stored[grid.order]]
    _, counts = torch.unique_consecutive(ids, return_counts=True)
    return int(stored.sum()), int((counts > max_per_cell).sum()), int(counts.max()) if counts.numel() else 0


def hall_integrators(scene, meta, cam, dev, log, smi, profiled, size=512, label="interior800k"):
    """Phase 18: one LT pass and one VCM pass (``VcmParams()``, max path
    length 8; LT ``max_depth`` 8) at ``size``^2 under wave2.  Returns
    {"lt": numbers, "vcm": numbers, "window": the connection window's rays}."""
    vpp = ViewportParams(size, size, seed=0)
    params = RenderParams(max_depth=8, mis=True)
    vcm = vcm_mod.VcmParams()
    n = size * size
    out = {}
    for name in ("lt", "vcm"):
        film = [make_film(size, size, dev)]

        def one_pass():
            if name == "lt":
                film[0] = lt.render_pass_light_tracer(scene, meta, cam, film[0], 0, None, vpp, params)[0]
            else:
                film[0] = vcm_mod.render_pass_vcm(scene, meta, cam, film[0], 0, None, vpp, params, vcm)
            _sync(dev)

        counts0 = launch_counts()
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        count = traced_rays(one_pass, n)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if torch.device(dev).type == "cuda" else float("nan")
        radiance = film[0].sum.cpu().numpy()
        numbers = {"s_per_pass": dt, "rays": count["rays"], "shadow_rays": count["shadow"], "peak_gib": peak,
                   "wave2_mt_launches": (launch_counts() - counts0)["wave2_mt"], "mean": float(radiance.mean())}
        log(f"{label} [{name}] {size}^2, one pass: {dt:.3f} s, rays {count['rays']}, shadow rays with a positive "
            f"limit {count['shadow']}, {(count['rays'] + count['shadow']) / dt / 1e6:.4f} Mray/s, wave2_mt launches "
            f"{numbers['wave2_mt_launches']}, peak {peak:.2f} GiB, mean radiance {numbers['mean']:.6f} ({smi})")
        check(bool(np.isfinite(radiance).all()) and numbers["mean"] > 0, f"{label} [{name}]: radiance finite, mean > 0")
        if name == "vcm":
            out["window"] = tuple(torch.cat(parts) for parts in zip(*count["connection"]))
        out[name] = numbers

    stored, over, most = grid_fill(
        lambda: vcm_mod.render_pass_vcm(scene, meta, cam, make_film(size, size, dev), 1, None, vpp, params, vcm),
        vcm.max_photons_per_cell)
    out["vcm"].update(photons=stored, cells_over=over, fullest_cell=most)
    log(f"{label} [vcm]: {stored} photons stored of {vcm.max_path_length * n} vertices; {over} grid cells hold more "
        f"than max_per_cell = {vcm.max_photons_per_cell} photons (the fullest {most}); a query keeps the first "
        f"{vcm.max_photons_per_cell} of a cell's run (computed here from the grid, not a package feature)")

    # one VCM pass under the profiler, beside an unprofiled one
    run = lambda: vcm_mod.render_pass_vcm(scene, meta, cam, make_film(size, size, dev), 0, None, vpp, params, vcm)
    _sync(dev)
    t0 = time.perf_counter()
    run()
    _sync(dev)
    wall = time.perf_counter() - t0
    device_ms = profiled(run, f"{label} [vcm] pass", named=("wave2_mt",))
    out["vcm"].update(pass_s=wall, device_ms=device_ms, idle=1 - device_ms / (wall * 1e3))
    log(f"{label} [vcm] pass: {wall * 1e3:.1f} ms unprofiled, device time {device_ms:.1f} ms: idle "
        f"{1 - device_ms / (wall * 1e3):.3f}")
    return out


def debug_and_counters(scene, meta, cam, dev, log, inst_scene=None, size=512, crop=64, label="interior800k"):
    """Phase 19: every debug mode on the frame's camera rays, TriangleID on
    the device against the CPU (a copy of the scene's tables) on a
    ``crop``^2 block of the same rays, both under ``bvh``, and the
    device's wave2 crop against wave2 with the kernel's plain twin, one
    MIS pass with ``count_traversal``, and the instanced scene's traversal
    cost beside the baked one's.  Returns the counters' numbers."""
    rays = camera_rays(cam, size, dev)
    hits = scene_traverse(scene, rays.origin, rays.dir)
    hit = hits.t < 1.5e38
    frame = scene_hit_frame(scene, hits._replace(t=torch.clamp(hits.t, 0.0, 1e12)), rays.origin, rays.dir)
    mats = frame.material_id[hit].long()
    table = scene.materials
    columns = {"BaseColor": (table.base_color.x, table.base_color.y, table.base_color.z),
               "Emission": (table.emission.x, table.emission.y, table.emission.z),
               "Roughness": (table.roughness,), "Metalness": (table.metalness,), "IoR": (table.ior,)}
    times = {}
    for mode in ALL_MODES:
        _sync(dev)
        t0 = time.perf_counter()
        out = render_debug(scene, meta, rays, mode)
        img = torch.stack(tuple(out), -1)
        _sync(dev)
        times[mode] = time.perf_counter() - t0
        constant = bool((img == img[:1]).all())
        # a material column the frame sees may hold one value, as may the
        # texture coordinates of a scene without them; a miss shows 0
        if mode in columns:
            seen = [c[mats] for c in columns[mode]]
        elif mode == "TexCoords":
            seen = [frame.tex_u[hit], frame.tex_v[hit]]
        else:
            seen = None
        expect_constant = seen is not None and all(bool((v == v[:1]).all()) for v in seen) and (
            bool(hit.all()) or all(bool((v[:1] == 0).all()) for v in seen))
        log(f"debug [{mode}] {size}^2: {times[mode] * 1e3:.1f} ms, min {float(img.min()):.4g}, max "
            f"{float(img.max()):.4g}, mean {float(img.mean()):.4g}, constant {constant}"
            + (" (as the scene's own table or texture coordinates are)" if expect_constant else ""))
        check(bool(torch.isfinite(img).all()) and constant == expect_constant,
              f"debug [{mode}]: finite, and constant only where the scene's own data is")

    # TriangleID of a crop of the same rays on the CPU, both sides under
    # `bvh`: wave2's plain twin on the CPU pays for every super's filler
    # chunks whatever the crop (minutes for the hall's 1,563 supers)
    lo = (size - crop) // 2
    sel = torch.zeros(size, size, dtype=torch.bool, device=dev)
    sel[lo:lo + crop, lo:lo + crop] = True
    sel = sel.reshape(-1)
    crop_rays = Rays(*(type(v)(*(c[sel] for c in v)) for v in rays))
    cpu_rays = Rays(*(type(v)(*(c.cpu() for c in v)) for v in crop_rays))
    t0 = time.perf_counter()
    scene_cpu = scene_on(scene, "cpu")
    t1 = time.perf_counter()
    wave2_ids = torch.stack(tuple(render_debug(scene, meta, crop_rays, MODE_TRIANGLE_ID)), -1).cpu()
    with twin_engine():
        twin_ids = torch.stack(tuple(render_debug(scene, meta, crop_rays, MODE_TRIANGLE_ID)), -1).cpu()
    saved_mode = trv.get_traversal_mode()
    trv.set_traversal_mode("bvh")
    try:
        got = torch.stack(tuple(render_debug(scene, meta, crop_rays, MODE_TRIANGLE_ID)), -1).cpu()
        t2 = time.perf_counter()
        want = torch.stack(tuple(render_debug(scene_cpu, meta, cpu_rays, MODE_TRIANGLE_ID)), -1)
    finally:
        trv.set_traversal_mode(saved_mode)
    log(f"debug [TriangleID] {crop}^2 crop under bvh: device against CPU ({torch.get_num_threads()} threads; the "
        f"copy {t1 - t0:.1f} s, the CPU's render {time.perf_counter() - t2:.1f} s), "
        f"{int((got != want).any(-1).sum())} of {crop * crop} pixels differ; under wave2 the kernel differs from its "
        f"twin on {int((wave2_ids != twin_ids).any(-1).sum())}, and from bvh on "
        f"{int((wave2_ids != want).any(-1).sum())}")
    check(torch.equal(got, want), f"debug [TriangleID] on the {crop}^2 crop under bvh equals the CPU's")
    check(torch.equal(wave2_ids, twin_ids),
          f"debug [TriangleID] on the {crop}^2 crop under wave2: wave2_mt equals its plain twin on the device")

    # one MIS pass with the traversal counters
    vp = Viewport(scene, meta, cam, ViewportParams(size, size, seed=0),
                  RenderParams(max_depth=6, mis=True, count_traversal=True), device=dev)
    t0 = time.perf_counter()
    vp.render(1)
    _sync(dev)
    dt = time.perf_counter() - t0
    prog = vp.progress()
    log(f"{label} MIS {size}^2 depth 6 with count_traversal, one pass: {dt:.3f} s; total_box_tests "
        f"{prog['total_box_tests']:.0f}, total_tri_tests {prog['total_tri_tests']:.0f} for {prog['total_rays']:.0f} "
        f"rays ({prog['total_tri_tests'] / max(prog['total_rays'], 1):.1f} triangle tests a ray)")
    check(prog["total_box_tests"] > 0 and prog["total_tri_tests"] > 0, "count_traversal counts box and tri tests")
    out = {"s_per_pass": dt, "box_tests": prog["total_box_tests"], "tri_tests": prog["total_tri_tests"],
           "debug_s": times}

    if inst_scene is not None:
        baked = scene_traversal_cost(scene, rays.origin, rays.dir)
        inst = scene_traversal_cost(inst_scene, rays.origin, rays.dir)
        same = [float((a == b).float().mean()) for a, b in zip(baked, inst)]
        log(f"{label} TraversalCost on the same {size}^2 rays: baked box tests a ray {float(baked[0].mean()):.1f}, "
            f"tri tests mean {float(baked[1].mean()):.1f}; instanced {float(inst[0].mean()):.1f}, "
            f"{float(inst[1].mean()):.1f}; equal on {same[0]:.4f} / {same[1]:.4f} of rays")
        out.update(baked=[float(x.mean()) for x in baked], instanced=[float(x.mean()) for x in inst], equal=same)
    return out


def main():
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to rehearse on the CPU")
    small = torch.device(dev).type == "cpu"
    build_dir = os.path.join(ROOT, "raytracer_tpu_torch", "_build")
    entry_point(dev, print, os.path.join(build_dir, "cli_out"), size=32 if small else 512, passes=2 if small else 4)
    if small:  # phases 18 and 19's control flow on the 2k-triangle bench mesh
        import bench_mesh
        from raytracer_tpu_torch.io.scene_loader import load_scene

        bench_mesh.BENCH_DIR = os.path.join(build_dir, "bench_scene")
        scene, meta, cam = load_scene(bench_mesh.ensure_scene(2000), device=dev)
        wall_ms = lambda run, label, **kw: (lambda t0: (run(), (time.perf_counter() - t0) * 1e3)[1])(time.perf_counter())
        out = hall_integrators(scene, meta, cam, dev, print, "cpu", wall_ms, size=32, label="mesh2k")
        print("connection window", [tuple(x.shape) for x in out["window"]])
        debug_and_counters(scene, meta, cam, dev, print, inst_scene=scene, size=32, crop=8, label="mesh2k")


if __name__ == "__main__":
    main()
