"""JSON scene loading in the reference renderer's schema (port of
``raytracer_tpu/io/scene_loader.py``).

This slice loads what the bench-mesh and Cornell-style scenes use:
materials, analytic objects (sphere, box, rect/plane), baked OBJ meshes
(through the port's ``io/obj.py``), area / sphere / point /
spot / directional / background lights, and the camera.  Textures, and a
mesh placed more than once (instancing), raise: they wait for ROADMAP
queue 1, items 13 and 16.  Box/rect ``size`` are HALF-extents.
"""

from __future__ import annotations

import json
import os
from collections import Counter

import numpy as np

from .obj import load_obj

from ..math.transform import RigidTransform, parse_transform
from ..scene import types as T
from ..scene.build import LightDesc, MaterialDesc, SceneBuilder
from ..scene.camera import make_camera

_SHAPE_KINDS = {"plane": T.SHAPE_RECT, "rect": T.SHAPE_RECT, "sphere": T.SHAPE_SPHERE, "box": T.SHAPE_BOX}
_TEXTURE_KEYS = ("baseColorTexture", "emissionTexture", "roughnessTexture",
                 "metalnessTexture", "normalMap", "maskMap")


class SceneLoadError(RuntimeError):
    pass


def _no_textures(where: str):
    raise SceneLoadError(
        f"{where}: textures are not ported yet (ROADMAP queue 1, item 13: "
        "ops/textures.py and the loader's texture path)"
    )


def _parse_materials(doc: dict, builder: SceneBuilder):
    for m in doc.get("materials", []):
        name = m.get("name")
        if not name:
            raise SceneLoadError("material missing 'name'")
        if any(k in m for k in _TEXTURE_KEYS):
            _no_textures(f"material '{name}'")
        bsdf = m.get("bsdf", "diffuse")
        if bsdf not in T.BSDF_NAMES:
            raise SceneLoadError(
                f"unknown bsdf '{bsdf}' in material '{name}' "
                f"(known: {', '.join(sorted(T.BSDF_NAMES))})"
            )
        builder.add_material(
            MaterialDesc(
                name=name,
                bsdf=bsdf,
                base_color=tuple(m.get("baseColor", (0.7, 0.7, 0.7))),
                emission=tuple(m.get("emissionColor", (0, 0, 0))),
                roughness=float(m.get("roughness", 0.1)),
                metalness=float(m.get("metalness", 0.0)),
                ior=float(m.get("IoR", 1.5)),
                k=float(m.get("K", 4.0)),
            )
        )


def _parse_objects(doc: dict, builder: SceneBuilder, data_path: str):
    path_uses = Counter(
        (o.get("path"), float(o.get("scale", 1.0)))
        for o in doc.get("objects", [])
        if o.get("type") == "mesh"
    )
    for o in doc.get("objects", []):
        typ = o.get("type")
        tf = parse_transform(o.get("transform"))
        mat_name = o.get("material")
        mat_id = builder.material_id(mat_name) if mat_name else builder.default_material_id()
        if typ == "sphere":
            builder.add_sphere(tf, float(o.get("radius", 1.0)), mat_id)
        elif typ == "box":
            builder.add_box(tf, tuple(o["size"]), mat_id)
        elif typ in ("rect", "plane"):
            ts = o.get("textureScale", [1.0, 1.0])
            size = o.get("size", (3.0e37, 3.0e37))
            builder.add_rect(tf, (float(size[0]), float(size[1])), mat_id,
                             uv_scale=(float(ts[0]), float(ts[1])))
        elif typ == "mesh":
            path = o["path"]
            if path_uses[(path, float(o.get("scale", 1.0)))] > 1 and tf.scale == 1.0:
                raise SceneLoadError(
                    f"mesh '{path}' is placed more than once: instancing is not "
                    "ported yet (ROADMAP queue 1, item 16)"
                )
            full = path if os.path.isabs(path) else os.path.join(data_path, path)
            mesh = load_obj(full, scale=float(o.get("scale", 1.0)))
            if any(om.diffuse_map or om.bump_map or om.alpha_map for om in mesh.materials):
                _no_textures(f"mesh '{path}'")
            # OBJ materials map onto the scene table: Kd/Ke + roughness 0.075
            remap = [
                builder.add_material(
                    MaterialDesc(
                        name=f"{os.path.basename(path)}:{om.name}",
                        bsdf="diffuse",
                        base_color=om.diffuse,
                        emission=om.emission,
                        roughness=0.075,
                        ior=om.ior,
                    )
                )
                for om in mesh.materials
            ]
            fm = np.asarray([remap[i] for i in mesh.face_materials], np.int64)
            builder.add_mesh(mesh.vertices, mesh.faces, mesh.normals, mesh.uvs, fm, tf)
        elif typ == "csg":
            raise SceneLoadError("csg objects not supported yet")
        else:
            raise SceneLoadError(f"unknown object type '{typ}'")


def _parse_lights(doc: dict, builder: SceneBuilder):
    for l in doc.get("lights", []):
        typ = l.get("type")
        if "texture" in l:
            _no_textures(f"{typ} light")
        color = tuple(l.get("color", (1, 1, 1)))
        tf = parse_transform(l.get("transform"))
        if typ == "area":
            shape = l.get("shape")
            if shape is not None:
                skind = _SHAPE_KINDS.get(shape.get("type", "plane"))
                if skind is None:
                    raise SceneLoadError(f"unknown area light shape '{shape.get('type')}'")
                if skind == T.SHAPE_SPHERE:
                    sp = (float(shape.get("radius", 1.0)), 0.0, 0.0)
                else:
                    size = shape.get("size", (1.0, 1.0))
                    sp = (float(size[0]), float(size[1]), float(size[2]) if len(size) > 2 else 0.0)
                builder.add_light(LightDesc(kind=T.LIGHT_AREA, color=color, transform=tf,
                                            shape_kind=skind, shape_param=sp))
            else:
                # legacy parallelogram: position + edge0 + edge1
                pos = np.asarray(l["position"], np.float64)
                e0 = np.asarray(l["edge0"], np.float64)
                e1 = np.asarray(l["edge1"], np.float64)
                center = pos + 0.5 * (e0 + e1)
                half0 = 0.5 * np.linalg.norm(e0)
                half1 = 0.5 * np.linalg.norm(e1)
                x = e0 / max(np.linalg.norm(e0), 1e-12)
                y = e1 / max(np.linalg.norm(e1), 1e-12)
                z = np.cross(x, y)
                z /= max(np.linalg.norm(z), 1e-12)
                tf = RigidTransform(translation=center)
                tf.rot = np.stack([x, y, z])
                builder.add_light(LightDesc(kind=T.LIGHT_AREA, color=color, transform=tf,
                                            shape_kind=T.SHAPE_RECT, shape_param=(half0, half1, 0.0)))
        elif typ == "sphere":
            tf = RigidTransform(translation=tuple(l.get("position", (0, 0, 0))))
            builder.add_light(LightDesc(kind=T.LIGHT_AREA, color=color, transform=tf,
                                        shape_kind=T.SHAPE_SPHERE,
                                        shape_param=(float(l.get("radius", 1.0)), 0.0, 0.0)))
        elif typ == "point":
            builder.add_light(LightDesc(kind=T.LIGHT_POINT, color=color, transform=tf))
        elif typ == "spot":
            builder.add_light(LightDesc(kind=T.LIGHT_SPOT, color=color, transform=tf,
                                        angle_rad=np.deg2rad(float(l.get("angle", 0.0)))))
        elif typ == "directional":
            builder.add_light(LightDesc(kind=T.LIGHT_DIRECTIONAL, color=color, transform=tf,
                                        angle_rad=np.deg2rad(float(l.get("angle", 0.0)))))
        elif typ == "background":
            builder.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=color))
        else:
            raise SceneLoadError(f"unknown light type '{typ}'")


def load_scene(path: str, data_path: str | None = None, aspect: float = 1.0, *, device):
    """Load a reference-format JSON scene onto ``device``.

    Returns (scene_data, scene_meta, camera).  ``data_path`` is the asset
    root for mesh paths; defaults to the scene file's directory."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("textures"):
        _no_textures(path)
    data_path = data_path or os.path.dirname(os.path.abspath(path))

    builder = SceneBuilder()
    _parse_materials(doc, builder)
    _parse_objects(doc, builder, data_path)
    _parse_lights(doc, builder)
    scene, meta = builder.build(device)

    cam_doc = doc.get("camera", {})
    camera = make_camera(
        parse_transform(cam_doc.get("transform")),
        fov_deg=float(cam_doc.get("fieldOfView", 60.0)),
        aspect=aspect,
        enable_dof=bool(cam_doc.get("enableDOF", False)),
        aperture=float(cam_doc.get("aperture", 0.1)),
        focal_distance=float(cam_doc.get("focalPlaneDistance", 2.0)),
        device=device,
    )
    return scene, meta, camera
