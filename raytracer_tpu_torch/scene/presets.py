"""Built-in scenes (port of ``raytracer_tpu/scene/presets.py``)."""

from __future__ import annotations

import numpy as np

from ..math.transform import RigidTransform
from . import types as T
from .build import LightDesc, MaterialDesc, SceneBuilder


def cornell_box(light_radiance=(18.0, 18.0, 18.0), *, device):
    """Analytic Cornell box: 5 rect walls, 2 boxes, rect area light at the
    ceiling.  Camera: ``cornell_camera_kw()``."""
    b = SceneBuilder()
    white = b.add_material(MaterialDesc(name="white", bsdf="diffuse", base_color=(0.73, 0.73, 0.73)))
    red = b.add_material(MaterialDesc(name="red", bsdf="diffuse", base_color=(0.63, 0.065, 0.05)))
    green = b.add_material(MaterialDesc(name="green", bsdf="diffuse", base_color=(0.14, 0.45, 0.09)))

    s = 1.0  # half-size of the box interior
    b.add_rect(RigidTransform(translation=(0, 0, 0), euler_deg=(-90, 0, 0)), (s, s), white)
    b.add_rect(RigidTransform(translation=(0, 2 * s, 0), euler_deg=(90, 0, 0)), (s, s), white)
    b.add_rect(RigidTransform(translation=(0, s, s), euler_deg=(180, 0, 0)), (s, s), white)
    b.add_rect(RigidTransform(translation=(-s, s, 0), euler_deg=(0, 90, 0)), (s, s), red)
    b.add_rect(RigidTransform(translation=(s, s, 0), euler_deg=(0, -90, 0)), (s, s), green)
    b.add_box(RigidTransform(translation=(-0.35, 0.6, 0.35), euler_deg=(0, 20, 0)), (0.3, 0.6, 0.3), white)
    b.add_box(RigidTransform(translation=(0.4, 0.3, -0.25), euler_deg=(0, -18, 0)), (0.3, 0.3, 0.3), white)
    b.add_light(
        LightDesc(
            kind=T.LIGHT_AREA,
            color=light_radiance,
            transform=RigidTransform(translation=(0, 2 * s - 1e-3, 0), euler_deg=(90, 0, 0)),
            shape_kind=T.SHAPE_RECT,
            shape_param=(0.25, 0.25, 0.0),
        )
    )
    return b.build(device)


def cornell_camera_kw():
    return dict(translation=(0.0, 1.0, -3.6)), dict(fov_deg=35.0)


def sphere_grid(nx=8, ny=8, with_mesh=False, *, device):
    """Grid of ``nx`` x ``ny`` spheres cycling through 8 BSDFs under a
    background light (the materials-test scene).  ``with_mesh`` is accepted
    and unused, as in the reference."""
    b = SceneBuilder()
    bsdfs = ["diffuse", "roughDiffuse", "metal", "roughMetal", "dielectric",
             "roughDielectric", "plastic", "roughPlastic"]
    for i in range(nx):
        for j in range(ny):
            m = b.add_material(
                MaterialDesc(
                    name=f"m{i}_{j}",
                    bsdf=bsdfs[(i * ny + j) % len(bsdfs)],
                    base_color=(0.9, 0.6 + 0.4 * j / max(ny - 1, 1), 0.4),
                    roughness=0.05 + 0.9 * i / max(nx - 1, 1),
                    ior=1.5,
                    k=3.0,
                )
            )
            b.add_sphere(RigidTransform(translation=(1.2 * (i - nx / 2), 1.2 * (j - ny / 2), 6.0)), 0.5, m)
    b.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.8, 0.9, 1.0)))
    return b.build(device)


def random_mesh_scene(n_tris=5000, seed=0, *, device):
    """Triangle-soup mesh + env light."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.add_material(MaterialDesc(name="mesh", bsdf="diffuse", base_color=(0.7, 0.7, 0.7)))
    centers = rng.uniform(-4, 4, (n_tris, 1, 3))
    centers[..., 2] += 8.0
    offs = rng.normal(0, 0.25, (n_tris, 3, 3))
    v = (centers + offs).astype(np.float32)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    normals = np.repeat(n[:, None, :], 3, axis=1)
    vertices = v.reshape(-1, 3)
    indices = np.arange(3 * n_tris).reshape(-1, 3)
    b.add_mesh(vertices, indices, normals.reshape(-1, 3), None, np.full(n_tris, m))
    b.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.7, 0.8, 1.0)))
    return b.build(device)
