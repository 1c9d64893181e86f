"""JSON scene loading in the reference renderer's schema (port of
``raytracer_tpu/io/scene_loader.py``).

Loads the ``textures`` block (bitmap, checkerboard, noise, mix), materials
with their six texture references and the dispersion keys (``dispersive``,
``abbe``, ``dispersionC``, ``dispersionD``), analytic objects (sphere, box,
rect/plane), baked OBJ meshes (through the port's ``io/obj.py``), area /
sphere / point / spot / directional / background lights with an optional
``texture``, and the camera.  Uncompressed 24-bit BMP files are read with
numpy and EXR files through the port's ``io/exr.py``; any other bitmap
format needs PIL, which is imported only then.  The texture maps an OBJ's
``.mtl`` names (``map_Kd``, ``map_bump``, ``map_d``) are ignored, as the
reference loader ignores them.  A mesh path placed more than once at scale
1 becomes one shared object-space geometry and one rigid instance per
placement.  ``csg`` objects raise.  Box/rect ``size`` are HALF-extents.
"""

from __future__ import annotations

import json
import os
import warnings
from collections import Counter

import numpy as np
import torch

from .bmp import UnsupportedBmp, read_bmp
from .obj import load_obj

from ..color.colorhelpers import srgb_to_linear
from ..math.transform import RigidTransform, parse_transform
from ..ops.textures import AtlasBuilder, FILTER_BILINEAR_SMOOTHSTEP
from ..scene import types as T
from ..scene.build import LightDesc, MaterialDesc, SceneBuilder
from ..scene.camera import make_camera
from ..utils.profiler import span

_SHAPE_KINDS = {"plane": T.SHAPE_RECT, "rect": T.SHAPE_RECT, "sphere": T.SHAPE_SPHERE, "box": T.SHAPE_BOX}


class SceneLoadError(RuntimeError):
    pass


class TextureNotFound(SceneLoadError):
    """A texture file that does not exist: without ``strict`` the loader puts
    a white placeholder in its place.  A file that exists and cannot be read
    is always an error."""


def _load_bitmap(data_path: str, rel: str) -> np.ndarray:
    """Load a bitmap as linear float32 (H, W, 3) (a ``load.textures``
    span)."""
    with span("load.textures", stage="decode", path=os.path.basename(rel)):
        path = rel if os.path.isabs(rel) else os.path.join(data_path, rel)
        if not os.path.exists(path):
            raise TextureNotFound(f"texture not found: {path}")
        lower = path.lower()
        if lower.endswith(".exr"):
            from .exr import read_exr

            return read_exr(path)
        img8 = None
        if lower.endswith(".bmp"):
            try:
                img8 = read_bmp(path)
            except UnsupportedBmp:
                pass  # another BMP variant (palette, 32-bit, compressed): left to PIL
            except ValueError as e:
                raise SceneLoadError(f"cannot read texture: {e}") from e
        if img8 is None:
            try:
                from PIL import Image
            except ImportError as e:
                raise SceneLoadError(f"{path}: reading this bitmap format needs PIL "
                                     "(uncompressed 24-bit BMP and EXR do not)") from e
            img8 = np.asarray(Image.open(path).convert("RGB"))
        if lower.endswith(".bmp"):
            # the reference renderer reads the BMP pixel array raw, without
            # undoing the format's bottom-up row order, so its v axis is flipped
            # against the authored image: flip the top-down image to match
            img8 = img8[::-1]
        img = np.ascontiguousarray(img8, np.float32) / np.float32(255.0)
        return srgb_to_linear(torch.from_numpy(img)).numpy()


def _parse_textures(doc: dict, data_path: str, strict: bool = False):
    atlas = AtlasBuilder()
    names: dict[str, int] = {}
    missing: list[str] = []
    pending_mix = []
    for tex in doc.get("textures", []):
        name = tex.get("name")
        if not name:
            raise SceneLoadError("texture missing 'name'")
        typ = tex.get("type", "bitmap")
        if typ == "bitmap":
            try:
                img = _load_bitmap(data_path, tex["path"].replace("\\", "/"))
            except TextureNotFound:
                if strict:
                    raise
                missing.append(tex["path"])
                names[name] = atlas.add_const((1.0, 1.0, 1.0))
                continue
            names[name] = atlas.add_bitmap(img, FILTER_BILINEAR_SMOOTHSTEP)
        elif typ == "checkerboard":
            names[name] = atlas.add_checkerboard(tuple(tex["colorA"]), tuple(tex["colorB"]))
        elif typ == "noise":
            names[name] = atlas.add_noise(tuple(tex["colorA"]), tuple(tex["colorB"]), int(tex.get("octaves", 1)))
        elif typ == "mix":
            # sub-textures may be declared later; patch after the loop
            names[name] = atlas.add_mix(0, 0, 0)
            pending_mix.append((names[name], tex))
        else:
            raise SceneLoadError(f"unknown texture type '{typ}'")
    for tid, tex in pending_mix:
        atlas.rows[tid]["sa"] = names[tex["textureA"]]
        atlas.rows[tid]["sb"] = names[tex["textureB"]]
        atlas.rows[tid]["sw"] = names[tex["weight"]]
    return atlas, names, missing


class _TexResolver:
    """Texture reference resolution: a declared texture name, else a bitmap
    path relative to the data directory.  A missing file resolves to a white
    constant with a warning, unless ``strict``."""

    def __init__(self, atlas: AtlasBuilder, names: dict[str, int], data_path: str, strict: bool):
        self.atlas = atlas
        self.names = names
        self.data_path = data_path
        self.strict = strict
        self.missing: list[str] = []

    def get(self, obj: dict, key: str) -> int:
        name = obj.get(key)
        if name is None:
            return T.INVALID_ID
        if name in self.names:
            return self.names[name]
        rel = name.replace("\\", "/")
        try:
            img = _load_bitmap(self.data_path, rel)
        except TextureNotFound:
            if self.strict:
                raise
            self.missing.append(rel)
            self.names[name] = self.atlas.add_const((1.0, 1.0, 1.0))
            return self.names[name]
        self.names[name] = self.atlas.add_bitmap(img, FILTER_BILINEAR_SMOOTHSTEP)
        return self.names[name]


def _parse_materials(doc: dict, builder: SceneBuilder, tex: _TexResolver):
    for m in doc.get("materials", []):
        name = m.get("name")
        if not name:
            raise SceneLoadError("material missing 'name'")
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
                base_color_tex=tex.get(m, "baseColorTexture"),
                emission_tex=tex.get(m, "emissionTexture"),
                roughness_tex=tex.get(m, "roughnessTexture"),
                metalness_tex=tex.get(m, "metalnessTexture"),
                normal_tex=tex.get(m, "normalMap"),
                mask_tex=tex.get(m, "maskMap"),
                normal_strength=float(m.get("normalMapStrength", 1.0)),
                dispersive=bool(m.get("dispersive", False)),
                abbe=float(m.get("abbe", 30.0)),
                dispersion_c=float(m.get("dispersionC", 0.00420)),
                dispersion_d=float(m.get("dispersionD", 0.0)),
                disp_use_abbe="abbe" in m,
            )
        )


def _parse_objects(doc: dict, builder: SceneBuilder, data_path: str):
    # a mesh path used by several objects becomes one shared object-space
    # geometry plus one instance per object; as in the reference, each use
    # registers the OBJ's materials again, and the geometry keeps the
    # material ids of its first use
    path_uses = Counter(
        (o.get("path"), float(o.get("scale", 1.0)))
        for o in doc.get("objects", [])
        if o.get("type") == "mesh"
    )
    mesh_geom_cache: dict = {}
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
            full = path if os.path.isabs(path) else os.path.join(data_path, path)
            mesh = load_obj(full, scale=float(o.get("scale", 1.0)))
            # OBJ materials map onto the scene table: Kd/Ke + roughness 0.075
            # (their map_Kd / map_bump / map_d files are not read)
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
            key = (path, float(o.get("scale", 1.0)))
            if path_uses[key] > 1 and tf.scale == 1.0:
                if key not in mesh_geom_cache:
                    mesh_geom_cache[key] = builder.add_mesh_geometry(
                        mesh.vertices, mesh.faces, mesh.normals, mesh.uvs, fm)
                builder.add_mesh_instance(mesh_geom_cache[key], tf)
            else:
                builder.add_mesh(mesh.vertices, mesh.faces, mesh.normals, mesh.uvs, fm, tf)
        elif typ == "csg":
            raise SceneLoadError("csg objects not supported yet")
        else:
            raise SceneLoadError(f"unknown object type '{typ}'")


def _parse_lights(doc: dict, builder: SceneBuilder, tex: _TexResolver):
    for l in doc.get("lights", []):
        typ = l.get("type")
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
                                            shape_kind=skind, shape_param=sp,
                                            env_tex=tex.get(l, "texture")))
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
            builder.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=color,
                                        env_tex=tex.get(l, "texture")))
        else:
            raise SceneLoadError(f"unknown light type '{typ}'")


def load_scene(path: str, data_path: str | None = None, aspect: float = 1.0,
               strict: bool = False, *, device):
    """Load a reference-format JSON scene onto ``device``.

    Returns (scene_data, scene_meta, camera).  ``data_path`` is the asset
    root for texture and mesh paths; defaults to the scene file's directory.
    ``strict``: a texture file that is not found raises instead of becoming
    a white placeholder."""
    with span("load.scene", path=os.path.basename(path)):
        return _load_scene(path, data_path, aspect, strict, device)


def _load_scene(path, data_path, aspect, strict, device):
    with span("load.parse"):
        with open(path) as f:
            doc = json.load(f)
        data_path = data_path or os.path.dirname(os.path.abspath(path))

        builder = SceneBuilder()
        atlas_builder, tex_names, missing0 = _parse_textures(doc, data_path, strict)
        tex = _TexResolver(atlas_builder, tex_names, data_path, strict)
        tex.missing.extend(missing0)
        _parse_materials(doc, builder, tex)
        _parse_objects(doc, builder, data_path)
        _parse_lights(doc, builder, tex)
    if tex.missing:
        warnings.warn(
            f"{path}: {len(tex.missing)} texture file(s) not found, using white "
            f"placeholders: {tex.missing[:3]}..."
        )
    if atlas_builder.rows:
        with span("load.textures", stage="atlas"):
            builder.textures = atlas_builder.build(device)
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
