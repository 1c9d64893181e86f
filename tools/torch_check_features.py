"""The scene effects of the PyTorch port (motion blur of prims, instances
and the camera; bokeh shapes; decals; spectral rendering with dispersive
materials) driven on one device: ``chip_smoke.py`` phase 20.

    python tools/torch_check_features.py [cuda|cpu]

The small scenes are built by functions that take the package's ``build``
module, its ``RigidTransform`` and its ``types`` module, so that the CPU
parity tests (``tests/test_torch_motion_blur.py``, ``test_torch_decals.py``)
build the JAX package's copy with the same code:

- ``moving_prims``: a red sphere and a box that move over the shutter, on
  a floor before a wall, under a rect light and a dim background;
- ``moving_instance``: a pyramid mesh placed twice, one instance moving,
  beside a moving sphere, under a background and a directional light;
- ``decaled_cornell``: the Cornell box shifted off the photon grid
  (``torch_check_integrators.shifted_cornell``) with three decals on its
  back wall and floor, one sampling the atlas for colour and alpha when
  an atlas builder is given;
- ``dispersive_cornell``: the Cornell box with a dispersive glass sphere
  (the abbe form) on its floor.

``device_against_cpu`` (phase 20 a) renders each feature alone at 64^2 on
the device and on the CPU, film after pass 0 and after pass 1, within the
CPU parity tests' rtol 1e-4 / atol 1e-6: the moving prims, the moving
instance (strength 1), the moving camera; each bokeh shape; the decals
with an atlas; the spectral Cornell box.  Where a value lies outside, it
must be one that the same scene without the feature's effect (held still,
a pinhole aperture, no decals, no dispersion) has apart by the same amount:
on the Cornell box the two devices' last-bit differences flip a few
shadow rays at the boxes' edges with the feature and without it.  ``spectral_brightness`` holds
the spectral box's mean within 2% of its RGB render's (256^2, 16 passes),
the JAX package's own bound.  ``fx_hall`` (phase 20 b) is the 800k hall
with every effect at once (``torch_gen_interior.ensure_interior_fx``).

A failed check raises SystemExit through ``check``.  ``main`` runs phase
20 a on the card, or at 16^2 on the CPU when given ``cpu`` (a rehearsal of
its control flow; the comparison is then CPU against CPU); with no
argument and no card it exits without running anything.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from functools import partial

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_check_integrators as tci  # noqa: E402
from torch_check_traverse import check  # noqa: E402

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.math.transform import RigidTransform, parse_transform  # noqa: E402
from raytracer_tpu_torch.math.vec import Vec3  # noqa: E402
from raytracer_tpu_torch.ops.textures import AtlasBuilder  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams  # noqa: E402
from raytracer_tpu_torch.scene import build, types as T  # noqa: E402
from raytracer_tpu_torch.scene.camera import BOKEH_CIRCLE, BOKEH_HEXAGON, BOKEH_NGON, BOKEH_SQUARE, make_camera  # noqa: E402

FILM_RTOL, FILM_ATOL = tci.FILM_RTOL, tci.FILM_ATOL
# the shutter-close pose of the moving camera: a small translation and yaw
CAMERA_END = dict(translation=(0.25, 0.05, 0.1), euler_deg=(0.0, 4.0, 0.0))


def pyramid():
    """The 4-face pyramid of tests/test_instancing.py (object space, apex
    +Y): vertices, faces, vertex normals."""
    v = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], [0, 1.5, 0]], np.float64)
    f = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], np.int64)
    n = np.zeros_like(v)
    for a, b, c in f:
        n[[a, b, c]] += np.cross(v[b] - v[a], v[c] - v[a])
    return v, f, n / np.linalg.norm(n, axis=1, keepdims=True)


def moving_prims(build_mod, rigid, types_mod):
    """(builder, camera transform kwargs, camera kwargs)."""
    b = build_mod.SceneBuilder()
    grey = b.add_material(build_mod.MaterialDesc(name="grey", base_color=(0.6, 0.6, 0.6)))
    red = b.add_material(build_mod.MaterialDesc(name="red", base_color=(0.8, 0.2, 0.2)))
    blue = b.add_material(build_mod.MaterialDesc(name="blue", bsdf="roughPlastic", base_color=(0.2, 0.3, 0.8),
                                                 roughness=0.3))
    b.add_rect(rigid(euler_deg=(-90, 0, 0)), (4.0, 4.0), grey)
    b.add_rect(rigid(translation=(0, 2.0, 3.0), euler_deg=(180, 0, 0)), (4.0, 2.0), grey)
    b.add_sphere(rigid(translation=(-0.6, 0.5, 1.0)), 0.5, red, velocity=(0.8, 0.0, 0.0))
    b.add_box(rigid(translation=(0.9, 0.4, 1.4), euler_deg=(0, 25, 0)), (0.3, 0.4, 0.3), blue,
              velocity=(0.0, 0.3, -0.2))
    b.add_light(build_mod.LightDesc(kind=types_mod.LIGHT_AREA, color=(10.0, 10.0, 10.0),
                                    transform=rigid(translation=(0.0, 3.0, 0.8), euler_deg=(90, 0, 0)),
                                    shape_kind=types_mod.SHAPE_RECT, shape_param=(0.6, 0.6, 0.0)))
    b.add_light(build_mod.LightDesc(kind=types_mod.LIGHT_BACKGROUND, color=(0.2, 0.25, 0.3)))
    return b, dict(translation=(0.0, 1.2, -2.5), euler_deg=(15, 0, 0)), dict(fov_deg=50.0)


def moving_instance(build_mod, rigid, types_mod):
    """(builder, camera transform kwargs, camera kwargs).  Only infinite
    lights: a shadow ray's limit is then as long as the scene, so the
    port's cap of fused any-hit lanes (ROADMAP "Decisions") and the JAX
    package's agree."""
    b = build_mod.SceneBuilder()
    grey = b.add_material(build_mod.MaterialDesc(name="grey", base_color=(0.6, 0.6, 0.65)))
    red = b.add_material(build_mod.MaterialDesc(name="red", bsdf="roughPlastic", base_color=(0.7, 0.3, 0.2),
                                                roughness=0.3))
    b.add_rect(rigid(euler_deg=(-90, 0, 0)), (5.0, 5.0), grey)
    v, f, n = pyramid()
    mid = b.add_mesh_geometry(v, f, n, None, np.full(len(f), red))
    b.add_mesh_instance(mid, rigid(translation=(-0.9, 0.0, 1.5), euler_deg=(0, 30, 0)), velocity=(0.9, 0.0, 0.3))
    b.add_mesh_instance(mid, rigid(translation=(1.3, 0.0, 2.5), euler_deg=(0, -20, 0)))
    b.add_sphere(rigid(translation=(0.9, 0.4, 0.6)), 0.4, grey, velocity=(0.0, 0.0, 0.6))
    b.add_light(build_mod.LightDesc(kind=types_mod.LIGHT_BACKGROUND, color=(0.7, 0.8, 0.9)))
    b.add_light(build_mod.LightDesc(kind=types_mod.LIGHT_DIRECTIONAL, color=(2.5, 2.4, 2.2),
                                    transform=rigid(euler_deg=(50.0, 20.0, 0.0))))
    return b, dict(translation=(0.0, 1.5, -3.5), euler_deg=(15, 0, 0)), dict(fov_deg=50.0)


def decal_atlas(atlas_builder):
    """Texture 0: a 16x8 colour bitmap; 1: a 16x8 alpha ramp along u; 2: a
    checkerboard (an ``AtlasBuilder`` of either package, not yet built)."""
    a = atlas_builder
    a.add_bitmap(np.random.default_rng(8).random((8, 16, 3)).astype(np.float32))
    a.add_bitmap(np.ascontiguousarray(np.broadcast_to(
        np.linspace(0.0, 1.0, 16, dtype=np.float32)[None, :, None], (8, 16, 3))))
    a.add_checkerboard((0.9, 0.9, 0.9), (0.2, 0.2, 0.2))
    return a


def decaled_cornell(build_mod, rigid, types_mod, atlas=None):
    """The shifted Cornell box with a decal on the back wall that takes its
    colour and alpha from textures 0 and 1 of ``atlas`` (a built atlas, or
    None for constant decals), a constant one beside it (order 1) and one
    on the floor.  (builder, camera transform kwargs, camera kwargs)."""
    b, t_kw, c_kw = tci.shifted_cornell(build_mod, rigid, types_mod)
    b.textures = atlas
    at = lambda p, e=(0.0, 0.0, 0.0): rigid(translation=tuple(a + d for a, d in zip(p, tci.OFFSET)), euler_deg=e)
    tex = dict(base_color_tex=0, alpha_tex=1, alpha_min=0.0, alpha_max=1.0) if atlas is not None else \
        dict(alpha_min=0.6, alpha_max=0.6)
    b.add_decal(build_mod.DecalDesc(transform=at((-0.3, 1.3, 1.0), (0, 0, 20)), half_size=(0.35, 0.3, 0.1),
                                    base_color=(1.0, 0.9, 0.8), roughness=0.3, **tex))
    b.add_decal(build_mod.DecalDesc(transform=at((0.3, 0.8, 1.0)), half_size=(0.3, 0.25, 0.1),
                                    base_color=(0.1, 0.2, 0.9), roughness=0.6, alpha_min=0.8, alpha_max=0.8, order=1))
    b.add_decal(build_mod.DecalDesc(transform=at((0.0, 0.0, 0.0), (90, 0, 0)), half_size=(0.5, 0.4, 0.05),
                                    base_color=(0.9, 0.7, 0.1), roughness=0.2, alpha_min=1.0, alpha_max=1.0))
    return b, t_kw, c_kw


def dispersive_cornell(build_mod, rigid, types_mod):
    """The Cornell box of ``scene/presets.py`` with a dispersive glass
    sphere (IoR 1.6, Abbe number 20) on the floor before its tall box.
    (builder, camera transform kwargs, camera kwargs)."""
    b, t_kw, c_kw = tci.shifted_cornell(build_mod, rigid, types_mod, offset=(0.0, 0.0, 0.0))
    glass = b.add_material(build_mod.MaterialDesc(name="glass", bsdf="dielectric", ior=1.6, dispersive=True,
                                                  abbe=20.0, disp_use_abbe=True))
    b.add_sphere(rigid(translation=(-0.3, 0.25, -0.5)), 0.25, glass)
    return b, t_kw, c_kw


def port_scene(make, dev, camera_end=None, **cam_kw):
    """(scene, meta, camera) of one of the scene functions above, built by
    the port on ``dev``; ``camera_end`` (RigidTransform kwargs) gives the
    camera a shutter-close pose, ``cam_kw`` adds camera arguments."""
    b, t_kw, c_kw = make(build, RigidTransform, T)
    scene, meta = b.build(dev)
    end = None if camera_end is None else RigidTransform(**camera_end)
    return scene, meta, make_camera(RigidTransform(**t_kw), **c_kw, **cam_kw, transform_end=end, device=dev)


def held_still(scene, meta, cam):
    """(scene, meta, camera) without motion: velocities zero, the camera
    without its shutter-close pose.  Rendered at the same strength it
    draws the same sample streams."""
    zero = lambda v: Vec3(*(torch.zeros_like(c) for c in v))
    inst = scene.instances
    scene = scene._replace(prims=scene.prims._replace(vel=zero(scene.prims.vel)),
                           instances=None if inst is None else dataclasses.replace(inst, vel=zero(inst.vel)))
    return scene, meta, dataclasses.replace(cam, enable_motion_blur=False)


def _features():
    """{label: (scene(device) -> (scene, meta, camera), ViewportParams
    arguments, RenderParams arguments, the same scene without the feature's
    effect on the same sample streams)} of phase 20 a."""
    mb = dict(motion_blur_strength=1.0)
    pinhole = lambda s, m, c: (s, m, dataclasses.replace(c, aperture=torch.zeros_like(c.aperture)))
    no_decals = lambda s, m, c: (s._replace(decals=None), m, c)
    flat = lambda s, m, c: (s._replace(materials=s.materials._replace(
        dispersive=torch.zeros_like(s.materials.dispersive))), m, c)
    out = {
        "moving prims": (lambda d: port_scene(moving_prims, d), mb, {}, held_still),
        "moving instance": (lambda d: port_scene(moving_instance, d), mb, {}, held_still),
        # the camera alone moves: the prims held still
        "moving camera": (lambda d: (lambda s, m, c: (held_still(s, m, c)[0], m, c))(
            *port_scene(moving_prims, d, camera_end=CAMERA_END)), mb, {}, held_still),
    }
    for name, shape, blades in (("circle", BOKEH_CIRCLE, 5), ("hexagon", BOKEH_HEXAGON, 5),
                                ("square", BOKEH_SQUARE, 5), ("5-gon", BOKEH_NGON, 5), ("7-gon", BOKEH_NGON, 7)):
        dof = dict(enable_dof=True, aperture=0.15, focal_distance=2.8, bokeh_shape=shape, aperture_blades=blades)
        out[f"bokeh {name}"] = (lambda d, dof=dof: port_scene(moving_prims, d, **dof), {}, {}, pinhole)
    out["decals with an atlas"] = (lambda d: port_scene(
        partial(decaled_cornell, atlas=decal_atlas(AtlasBuilder()).build(d)), d), {}, {}, no_decals)
    out["spectral Cornell box"] = (lambda d: port_scene(dispersive_cornell, d), {}, dict(spectral=True), flat)
    return out


def _apart(a, b):
    """(device film sum, CPU film sum) -> bool mask of the values outside
    rtol 1e-4 / atol 1e-6, and the differences."""
    a, b = a.cpu().double(), b.cpu().double()
    return (a - b).abs() > FILM_ATOL + FILM_RTOL * b.abs(), a - b


def device_against_cpu(dev, log, size=64, depth=4):
    """Phase 20 a: each feature alone at ``size``^2, depth ``depth``, MIS,
    on the device and on the CPU: the film after pass 0 and after pass 1
    within rtol 1e-4 / atol 1e-6.  The card's transcendental functions may
    differ from the CPU's by an ulp, and a shadow ray that grazes a box's
    edge may then be blocked on one and not on the other; so a value
    outside the tolerance passes only where the same scene without the
    feature's effect, on the same sample streams, differs between the two
    devices at the same value by the same amount (within the tolerance):
    the feature adds no difference of its own.  Returns ({label: seconds a
    device pass}, {label: values apart})."""
    seconds, apart_counts = {}, {}
    for label, (make, vp_kw, rp_kw, without) in _features().items():
        vp, params = ViewportParams(size, size, seed=0, **vp_kw), RenderParams(max_depth=depth, mis=True, **rp_kw)
        scenes = {d: make(d) for d in (dev, "cpu")}
        views = {d: Viewport(*scenes[d], vp, params, device=d) for d in (dev, "cpu")}
        for pass_idx in (0, 1):
            t0 = time.perf_counter()
            views[dev].render(1)
            tci._sync(dev)
            seconds[label] = time.perf_counter() - t0
            views["cpu"].render(1)
            name = f"{label} {size}^2 after pass {pass_idx}"
            if tci.films_agree(views[dev].film.sum, views["cpu"].film.sum, name, log):
                continue
            mask, diff = _apart(views[dev].film.sum, views["cpu"].film.sum)
            base = {d: Viewport(*without(*scenes[d]), vp, params, device=d).render(pass_idx + 1) for d in (dev, "cpu")}
            base_mask, base_diff = _apart(base[dev].film.sum, base["cpu"].film.sum)
            same = bool(torch.equal(mask, base_mask)) and bool(
                ((diff - base_diff)[mask].abs() <= FILM_ATOL + FILM_RTOL * views["cpu"].film.sum.double()[mask].abs()).all())
            apart_counts[label] = int(mask.sum())
            log(f"{name}: {int(mask.sum())} values apart; without the feature's effect {int(base_mask.sum())}, at "
                f"{'the same values by the same amounts' if same else 'other values or by other amounts'}")
            check(same, f"{name}: the values outside rtol {FILM_RTOL} / atol {FILM_ATOL} are those of the scene "
                        f"without the feature, apart by the same amounts (the feature adds no device difference)")
        rad = views[dev].radiance()
        check(bool(np.isfinite(rad).all()) and rad.mean() > 0, f"{label}: radiance finite with a non-zero mean")
        check(views[dev].progress()["total_traversal_overflow"] == 0, f"{label}: traversal overflow 0")
    return seconds, apart_counts


def spectral_brightness(dev, log, size=256, passes=16, smi=""):
    """The spectral Cornell box against its RGB render, ``passes`` passes
    at ``size``^2, depth 6: the means within 2% (E[rgb_resolve] = 1: the
    JAX package's own bound, tests/test_spectral.py).  Returns (spectral
    mean, RGB mean, seconds a spectral pass)."""
    scene, meta, cam = port_scene(dispersive_cornell, dev)
    means, seconds = {}, {}
    for spectral in (True, False):
        vp = Viewport(scene, meta, cam, ViewportParams(size, size, seed=0),
                      RenderParams(max_depth=6, mis=True, spectral=spectral), device=dev)
        t0 = time.perf_counter()
        rad = vp.render(passes).radiance()
        seconds[spectral] = (time.perf_counter() - t0) / passes
        means[spectral] = float(rad.mean())
        check(bool(np.isfinite(rad).all()), f"spectral={spectral}: finite radiance")
    ratio = means[True] / means[False]
    log(f"spectral Cornell box {size}^2, {passes} passes: mean {means[True]:.6f} against the RGB render's "
        f"{means[False]:.6f}: ratio {ratio:.4f}; {seconds[True] * 1e3:.1f} ms a spectral pass, "
        f"{seconds[False] * 1e3:.1f} ms an RGB pass ({smi})")
    check(abs(ratio - 1.0) < 0.02, "the spectral render's mean within 2% of the RGB render's")
    return means[True], means[False], seconds[True]


# --- phase 20 b: the 800k hall with every effect ------------------------------------
FX_KNOT_VELOCITY = (0.0, 0.35, 0.25)  # each knot's motion over the shutter
FX_SPHERE_VELOCITY = (0.6, 0.0, 0.0)  # the dispersive glass sphere's
FX_CAMERA_MOVE = dict(translation=(0.3, 0.05, 0.5), yaw_deg=2.0)  # the shutter-close pose, relative


def fx_effects(scene, meta, cam, path, dev):
    """What the JSON schema cannot hold, set on the loaded fx hall
    (``torch_gen_interior.ensure_interior_fx``): velocities on the 3 knot
    instances (those on the aisle, x = 0) and on the dispersive sphere; a
    shutter-close camera pose (``FX_CAMERA_MOVE``) and a hexagonal
    aperture; three decals, two on the floor before the camera (one takes
    its colour and alpha from the slab's base-colour and roughness
    textures) and one on the left wall.  Returns (scene, camera)."""
    rows_moving = lambda mask, v: Vec3(*(torch.where(mask, x, 0.0) for x in v))  # v on the rows of mask, else 0
    knots = scene.instances.trans.x.abs() < 1e-6
    check(int(knots.sum()) == 3, "the fx hall has 3 knot instances on the aisle")
    glass = scene.materials.dispersive[scene.prims.material_id.long()]
    check(int(glass.sum()) == 1, "the fx hall has one prim of a dispersive material")
    scene = scene._replace(instances=dataclasses.replace(scene.instances, vel=rows_moving(knots, FX_KNOT_VELOCITY)),
                           prims=scene.prims._replace(vel=rows_moving(glass, FX_SPHERE_VELOCITY)))

    with open(path) as f:
        doc = json.load(f)["camera"]
    start = parse_transform(doc["transform"])
    tr, (pitch, yaw, roll) = doc["transform"]["translation"], doc["transform"]["orientation"]
    end = RigidTransform(translation=tuple(a + b for a, b in zip(tr, FX_CAMERA_MOVE["translation"])),
                         euler_deg=(pitch, yaw + FX_CAMERA_MOVE["yaw_deg"], roll))
    fx_cam = make_camera(start, fov_deg=doc["fieldOfView"], enable_dof=True, aperture=doc["aperture"],
                         focal_distance=doc["focalPlaneDistance"], bokeh_shape=BOKEH_HEXAGON, transform_end=end,
                         device=dev)
    same = all(torch.equal(a, b) for f in ("origin", "right", "up", "forward") for a, b in
               zip(getattr(fx_cam, f), getattr(cam, f)))
    check(same, "the fx camera's shutter-open pose is the loaded camera's")

    slab = int((scene.materials.normal_tex >= 0).nonzero()[0])  # the one normal-mapped material
    tiles, cloud = int(scene.materials.base_color_tex[slab]), int(scene.materials.roughness_tex[slab])
    b = build.SceneBuilder()
    b.add_decal(build.DecalDesc(transform=RigidTransform(translation=(-1.5, 0.09, -31.5), euler_deg=(-90, 0, 15)),
                                half_size=(2.5, 2.0, 0.25), base_color=(1.0, 0.95, 0.9), base_color_tex=tiles,
                                alpha_tex=cloud, roughness=0.2, alpha_min=0.0, alpha_max=1.0))
    b.add_decal(build.DecalDesc(transform=RigidTransform(translation=(-0.5, 0.09, -30.0), euler_deg=(-90, 0, 0)),
                                half_size=(1.0, 0.8, 0.25), base_color=(0.8, 0.1, 0.1), roughness=0.6,
                                alpha_min=0.7, alpha_max=0.7, order=1))
    b.add_decal(build.DecalDesc(transform=RigidTransform(translation=(-15.95, 3.0, -5.0), euler_deg=(0, 90, 0)),
                                half_size=(6.0, 3.0, 0.5), base_color=(0.1, 0.3, 0.8), roughness=0.8,
                                alpha_min=0.9, alpha_max=0.9))
    return scene._replace(decals=b._build_decals(dev)), fx_cam


def shutter_times(n, dev, strength=1.0, seed=13):
    """Seeded per-lane shutter times in [0, strength)."""
    return torch.as_tensor(np.random.default_rng(seed).random(n, dtype=np.float32) * strength, device=dev)


def zero_strength_is_still(scene, meta, cam, dev, log, size=128):
    """At strength 0, spectral off, one pass: the fx hall renders bit for
    bit as the same hall held still (``held_still``)."""
    params = RenderParams(max_depth=6, mis=True)
    vp = ViewportParams(size, size, seed=0, motion_blur_strength=0.0)
    a = Viewport(scene, meta, cam, vp, params, device=dev).render(1).radiance()
    b = Viewport(*held_still(scene, meta, cam), vp, params, device=dev).render(1).radiance()
    log(f"fx hall {size}^2 at strength 0: mean {a.mean():.6f} against {b.mean():.6f} held still; "
        f"{int((a != b).sum())} values differ")
    check(bool(np.array_equal(a, b)), "at strength 0 the fx hall renders bit for bit as the hall held still")
    return float(a.mean())


def main():
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to rehearse on the CPU")
    small = torch.device(dev).type == "cpu"
    device_against_cpu(dev, print, size=16 if small else 64)
    spectral_brightness(dev, print, size=32 if small else 256, passes=4 if small else 16)


if __name__ == "__main__":
    main()
