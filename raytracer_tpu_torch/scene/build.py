"""Host-side scene construction: python objects -> SoA tensors on a device
(port of ``raytracer_tpu/scene/build.py``).

``SceneBuilder.build(device)`` takes the device explicitly.  Baked meshes
get their skip-link BVH and cluster set; a mesh registered with
``add_mesh_geometry`` is stored once in object space and placed by rigid
instances.  Prims and instances carry a linear velocity over the shutter
(motion blur); decals are sorted by descending ``order``.
"""

from __future__ import annotations

import math as _math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..math.transform import RigidTransform
from ..math.vec import Vec3
from ..utils.profiler import span
from . import types as T


@dataclass
class MaterialDesc:
    name: str = "default"
    bsdf: str = "diffuse"
    base_color: tuple = (0.7, 0.7, 0.7)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.1
    metalness: float = 0.0
    ior: float = 1.5
    k: float = 4.0
    base_color_tex: int = T.INVALID_ID
    emission_tex: int = T.INVALID_ID
    roughness_tex: int = T.INVALID_ID
    metalness_tex: int = T.INVALID_ID
    normal_tex: int = T.INVALID_ID
    mask_tex: int = T.INVALID_ID
    normal_strength: float = 1.0
    dispersive: bool = False  # wavelength-dependent IoR (spectral mode only)
    abbe: float = 30.0  # Abbe number V_d (lower = stronger dispersion)
    dispersion_c: float = 0.00420  # Cauchy C, the BK7 default
    dispersion_d: float = 0.0
    disp_use_abbe: bool = False  # True => the (IoR, abbe) Cauchy form


@dataclass
class PrimDesc:
    kind: int  # PRIM_*
    transform: RigidTransform
    param: tuple  # (radius,0,0) or half-size
    material_id: int
    light_id: int = T.INVALID_ID
    velocity: tuple = (0.0, 0.0, 0.0)  # linear motion over the shutter (t in [0, 1])
    uv_scale: tuple = (1.0, 1.0)


@dataclass
class DecalDesc:
    """A projected-texture decal: a box (``half_size`` about the
    transform) whose inside gets the decal's base color and roughness."""

    transform: RigidTransform
    half_size: tuple = (0.5, 0.5, 0.5)
    base_color: tuple = (1.0, 1.0, 1.0)
    base_color_tex: int = T.INVALID_ID
    alpha_tex: int = T.INVALID_ID
    roughness: float = 0.5
    alpha_min: float = 0.0
    alpha_max: float = 1.0
    order: int = 0  # applied from the highest order to the lowest: the lowest ends on top


@dataclass
class LightDesc:
    kind: int  # LIGHT_*
    color: tuple
    transform: RigidTransform = field(default_factory=RigidTransform)
    shape_kind: int = T.SHAPE_RECT
    shape_param: tuple = (0.5, 0.5, 0.0)
    angle_rad: float = 0.0  # spot / directional cone half-angle
    env_tex: int = T.INVALID_ID

    def surface_area(self) -> float:
        sx, sy, sz = self.shape_param
        if self.shape_kind == T.SHAPE_RECT:
            return 4.0 * sx * sy
        if self.shape_kind == T.SHAPE_SPHERE:
            return 4.0 * _math.pi * sx * sx
        if self.shape_kind == T.SHAPE_BOX:
            return 8.0 * (sx * sy + sy * sz + sz * sx)
        return 0.0

    def flags(self) -> tuple[bool, bool]:
        """(is_delta, is_finite) per light kind."""
        cos_eps = 0.9999
        if self.kind == T.LIGHT_AREA:
            return False, True
        if self.kind == T.LIGHT_BACKGROUND:
            return False, False
        if self.kind == T.LIGHT_POINT:
            return True, True
        if self.kind == T.LIGHT_SPOT:
            return _math.cos(self.angle_rad) > cos_eps, True
        if self.kind == T.LIGHT_DIRECTIONAL:
            return _math.cos(self.angle_rad) > cos_eps, False
        raise ValueError(self.kind)


def _f32(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def _i32(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int32), device=device)


def _vec3(rows: list, device) -> Vec3:
    a = np.asarray(rows, dtype=np.float32).reshape(-1, 3)
    return Vec3(_f32(a[:, 0], device), _f32(a[:, 1], device), _f32(a[:, 2], device))


def _rot3(transforms: list[RigidTransform], device) -> T.Rot3:
    rows = np.stack([t.rot for t in transforms], 0).astype(np.float32)
    mk = lambda i: Vec3(_f32(rows[:, i, 0], device), _f32(rows[:, i, 1], device), _f32(rows[:, i, 2], device))
    return T.Rot3(mk(0), mk(1), mk(2))


def _mesh_tables(tri_v, tri_n, tri_uv, tri_mat, device):
    """One mesh's device tables in BVH leaf order: (Triangles, BVHFlat,
    ClusterSet, (v0, e1, e2) on the host)."""
    from .bvh import build_bvh_over_triangles
    from .clusters import build_clusters

    with span("load.bvh", triangles=len(tri_v)):
        (v0, e1, e2, nrm, uv, mat), bvh = build_bvh_over_triangles(tri_v, tri_n, tri_uv, tri_mat, device=device)
    v3 = lambda a: Vec3(_f32(a[:, 0], device), _f32(a[:, 1], device), _f32(a[:, 2], device))
    with span("load.upload"):
        tris = T.Triangles(
            v0=v3(v0), e1=v3(e1), e2=v3(e2),
            n0=v3(nrm[:, 0]), n1=v3(nrm[:, 1]), n2=v3(nrm[:, 2]),
            uv0_u=_f32(uv[:, 0, 0], device), uv0_v=_f32(uv[:, 0, 1], device),
            uv1_u=_f32(uv[:, 1, 0], device), uv1_v=_f32(uv[:, 1, 1], device),
            uv2_u=_f32(uv[:, 2, 0], device), uv2_v=_f32(uv[:, 2, 1], device),
            material_id=_i32(mat, device),
        )
    with span("load.clusters"):
        clusters = build_clusters(v0, e1, e2, normals=nrm, uvs=uv, material_ids=mat, device=device)
    return tris, bvh, clusters, (v0, e1, e2)


class SceneBuilder:
    """Accumulates scene content then freezes it to a SceneData."""

    def __init__(self):
        self.materials: list[MaterialDesc] = []
        self.prims: list[PrimDesc] = []
        self.lights: list[LightDesc] = []
        self.decals: list[DecalDesc] = []
        self._mat_index: dict[str, int] = {}
        self._tri_v = []  # (n,3,3) world-space vertex positions
        self._tri_n = []  # (n,3,3) vertex normals
        self._tri_uv = []  # (n,3,2)
        self._tri_mat = []  # (n,)
        # shared object-space meshes and their instances (two-level structure)
        self._mesh_geoms = []
        self._mesh_instances = []
        self.textures = None  # a TextureAtlas on the build device, set by the loader

    # --- materials -------------------------------------------------------------
    def add_material(self, desc: MaterialDesc) -> int:
        idx = len(self.materials)
        self.materials.append(desc)
        if desc.name:
            self._mat_index[desc.name] = idx
        return idx

    def material_id(self, name: str) -> int:
        if name not in self._mat_index:
            raise KeyError(f"unknown material '{name}'")
        return self._mat_index[name]

    def default_material_id(self) -> int:
        if "__default__" not in self._mat_index:
            return self.add_material(MaterialDesc(name="__default__"))
        return self._mat_index["__default__"]

    # --- geometry ----------------------------------------------------------------
    def add_sphere(self, transform: RigidTransform, radius: float, material_id: int, light_id=T.INVALID_ID,
                   velocity=(0.0, 0.0, 0.0)):
        self.prims.append(PrimDesc(T.PRIM_SPHERE, transform, (radius, 0.0, 0.0), material_id, light_id, velocity))

    def add_box(self, transform: RigidTransform, half_size, material_id: int, light_id=T.INVALID_ID,
                velocity=(0.0, 0.0, 0.0)):
        self.prims.append(PrimDesc(T.PRIM_BOX, transform, tuple(half_size), material_id, light_id, velocity))

    def add_rect(self, transform: RigidTransform, half_size2, material_id: int, light_id=T.INVALID_ID,
                 velocity=(0.0, 0.0, 0.0), uv_scale=(1.0, 1.0)):
        sx, sy = half_size2
        self.prims.append(PrimDesc(T.PRIM_RECT, transform, (sx, sy, 0.0), material_id, light_id, velocity,
                                   tuple(uv_scale)))

    def add_mesh(self, vertices, indices, normals, uvs, material_ids, transform: RigidTransform | None = None):
        """Add a triangle mesh, pre-transformed to world space: vertices
        (V,3), indices (F,3), normals (V,3), uvs (V,2), material_ids (F,)."""
        vertices = np.asarray(vertices, np.float64)
        normals = np.asarray(normals, np.float64)
        if transform is not None:
            vertices = vertices * transform.scale @ transform.rot + transform.translation
            normals = normals @ transform.rot
        indices = np.asarray(indices, np.int64)
        self._tri_v.append(vertices[indices])
        self._tri_n.append(normals[indices])
        self._tri_uv.append(
            np.asarray(uvs, np.float64)[indices] if uvs is not None else np.zeros((len(indices), 3, 2))
        )
        self._tri_mat.append(np.asarray(material_ids, np.int64))

    def add_mesh_geometry(self, vertices, indices, normals, uvs, material_ids) -> int:
        """Register a shared OBJECT-SPACE mesh; returns a mesh id for
        :meth:`add_mesh_instance`.  The geometry is stored once however many
        instances place it."""
        self._mesh_geoms.append((
            np.asarray(vertices, np.float64), np.asarray(indices, np.int64),
            np.asarray(normals, np.float64),
            np.asarray(uvs, np.float64) if uvs is not None else None,
            np.asarray(material_ids, np.int64),
        ))
        return len(self._mesh_geoms) - 1

    def add_mesh_instance(self, mesh_id: int, transform: RigidTransform, velocity=(0.0, 0.0, 0.0)) -> int:
        """Place an instance of a registered mesh: a rigid transform, and a
        linear velocity over the shutter (motion blur)."""
        if getattr(transform, "scale", 1.0) != 1.0:
            raise ValueError(
                "instances are rigid (rotation+translation); bake scaled "
                "meshes with add_mesh or pre-scale the geometry"
            )
        self._mesh_instances.append((mesh_id, transform, tuple(velocity)))
        return len(self._mesh_instances) - 1

    # --- lights ------------------------------------------------------------------
    def add_light(self, desc: LightDesc) -> int:
        light_id = len(self.lights)
        self.lights.append(desc)
        # finite area lights are hit-testable scene geometry
        if desc.kind == T.LIGHT_AREA:
            null_mat = self._light_material_id()
            prim_kind = {T.SHAPE_RECT: T.PRIM_RECT, T.SHAPE_SPHERE: T.PRIM_SPHERE, T.SHAPE_BOX: T.PRIM_BOX}[desc.shape_kind]
            self.prims.append(PrimDesc(prim_kind, desc.transform, tuple(desc.shape_param), null_mat, light_id))
        return light_id

    def _light_material_id(self) -> int:
        if "__light__" not in self._mat_index:
            return self.add_material(MaterialDesc(name="__light__", bsdf="null", base_color=(0, 0, 0)))
        return self._mat_index["__light__"]

    # --- decals ------------------------------------------------------------------
    def add_decal(self, desc: DecalDesc) -> int:
        self.decals.append(desc)
        return len(self.decals) - 1

    # --- freeze --------------------------------------------------------------------
    def build(self, device) -> tuple[T.SceneData, T.SceneMeta]:
        if not self.materials:
            self.default_material_id()
        mats = self.materials
        materials = T.Materials(
            bsdf=_i32([T.BSDF_NAMES[m.bsdf] for m in mats], device),
            base_color=_vec3([m.base_color for m in mats], device),
            emission=_vec3([m.emission for m in mats], device),
            roughness=_f32([m.roughness for m in mats], device),
            metalness=_f32([m.metalness for m in mats], device),
            ior=_f32([m.ior for m in mats], device),
            k=_f32([m.k for m in mats], device),
            base_color_tex=_i32([m.base_color_tex for m in mats], device),
            emission_tex=_i32([m.emission_tex for m in mats], device),
            roughness_tex=_i32([m.roughness_tex for m in mats], device),
            metalness_tex=_i32([m.metalness_tex for m in mats], device),
            normal_tex=_i32([m.normal_tex for m in mats], device),
            mask_tex=_i32([m.mask_tex for m in mats], device),
            normal_strength=_f32([m.normal_strength for m in mats], device),
            dispersive=torch.as_tensor([m.dispersive for m in mats], dtype=torch.bool, device=device),
            abbe=_f32([m.abbe for m in mats], device),
            dispersion_c=_f32([m.dispersion_c for m in mats], device),
            dispersion_d=_f32([m.dispersion_d for m in mats], device),
            disp_use_abbe=torch.as_tensor([m.disp_use_abbe for m in mats], dtype=torch.bool, device=device),
        )

        prim_list = self.prims
        if not prim_list:
            # a radius-0 sphere can never be hit; keeps every shape static
            prim_list = [PrimDesc(T.PRIM_SPHERE, RigidTransform(), (0.0, 0.0, 0.0), 0)]
        prims = T.Primitives(
            kind=_i32([p.kind for p in prim_list], device),
            rot=_rot3([p.transform for p in prim_list], device),
            trans=_vec3([tuple(p.transform.translation) for p in prim_list], device),
            param=_vec3([p.param for p in prim_list], device),
            material_id=_i32([p.material_id for p in prim_list], device),
            light_id=_i32([p.light_id for p in prim_list], device),
            vel=_vec3([p.velocity for p in prim_list], device),
            uv_scale=_vec3([(p.uv_scale[0], p.uv_scale[1], 1.0) for p in prim_list], device),
        )

        tris, bvh, clusters, tri_verts = self._build_tris(device)
        mesh_geoms, instances, inst_radii = self._build_instances(device)
        scene = T.SceneData(prims=prims, tris=tris, materials=materials,
                            lights=self._build_lights(device), clusters=clusters,
                            textures=self.textures, env_dist=self._build_env_dist(device),
                            bvh=bvh, decals=self._build_decals(device), mesh_geoms=mesh_geoms,
                            instances=instances)
        return scene, self._build_meta(prim_list, tri_verts, inst_radii)

    def _build_env_dist(self, device):
        """2-D luminance x sin(theta) distribution over the background
        light's lat-long bitmap, for NEE importance sampling (a
        ``load.textures`` span)."""
        if self.textures is None:
            return None
        bg = next((l for l in self.lights if l.kind == T.LIGHT_BACKGROUND), None)
        if bg is None or bg.env_tex < 0:
            return None
        with span("load.textures", stage="env_dist"):
            atlas = self.textures
            if int(atlas.kind[bg.env_tex]) != T.TEX_BITMAP:
                return None
            y0 = int(atlas.y0[bg.env_tex])
            h = int(atlas.height[bg.env_tex])
            w = int(atlas.width[bg.env_tex])
            img = atlas.data[y0:y0 + h, :w, :].cpu().numpy()
            lum = img @ np.array([0.2126, 0.7152, 0.0722], np.float64)
            theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
            from ..math.distribution import make_distribution_2d

            return make_distribution_2d(lum * np.sin(theta)[:, None], device=device)

    def _build_decals(self, device):
        """The decal table, sorted by descending ``order`` (the sort is
        stable: equal orders keep their insertion order); None if there
        are no decals."""
        if not self.decals:
            return None
        ds = sorted(self.decals, key=lambda d: -d.order)
        return T.Decals(
            rot=_rot3([d.transform for d in ds], device),
            trans=_vec3([tuple(d.transform.translation) for d in ds], device),
            half_size=_vec3([d.half_size for d in ds], device),
            base_color=_vec3([d.base_color for d in ds], device),
            base_color_tex=_i32([d.base_color_tex for d in ds], device),
            alpha_tex=_i32([d.alpha_tex for d in ds], device),
            roughness=_f32([d.roughness for d in ds], device),
            alpha_min=_f32([d.alpha_min for d in ds], device),
            alpha_max=_f32([d.alpha_max for d in ds], device),
        )

    def _build_tris(self, device):
        """The baked world-space triangles: (Triangles, BVHFlat, ClusterSet,
        (v0, e1, e2) on the host), or Nones."""
        if not self._tri_v:
            return None, None, None, None
        return _mesh_tables(
            np.concatenate(self._tri_v, 0).astype(np.float32),
            np.concatenate(self._tri_n, 0).astype(np.float32),
            np.concatenate(self._tri_uv, 0).astype(np.float32),
            np.concatenate(self._tri_mat, 0).astype(np.int32),
            device,
        )

    def _build_instances(self, device):
        """The shared object-space meshes (each with its own triangle table
        and cluster set; its BVH is built for the leaf order and dropped, as
        in the reference) and the instance table.  Returns (mesh_geoms,
        instances, the instances' bounding radii about the origin)."""
        if not self._mesh_instances:
            return (), None, []
        geoms, obj_radius = [], []
        for verts, idxs, norms, uvs, mats in self._mesh_geoms:
            tri_uv = uvs[idxs] if uvs is not None else np.zeros((len(idxs), 3, 2))
            tris, _bvh, clusters, (v0, e1, e2) = _mesh_tables(
                verts[idxs].astype(np.float32), norms[idxs].astype(np.float32),
                tri_uv.astype(np.float32), mats.astype(np.int32), device)
            geoms.append(T.MeshGeom(tris=tris, clusters=clusters))
            obj_radius.append(max(float(np.max(np.linalg.norm(v, axis=1))) for v in (v0, v0 + e1, v0 + e2)))
        insts = self._mesh_instances
        instances = T.Instances(
            rot=_rot3([t for _, t, _ in insts], device),
            trans=_vec3([tuple(t.translation) for _, t, _ in insts], device),
            vel=_vec3([v for _, _, v in insts], device),
            mesh_ids=tuple(int(m) for m, _, _ in insts),
        )
        # each instance's bounding sphere about the origin: |translation| +
        # the object-space radius (rotation-free bound), in float32 as the
        # reference computes it
        trans = np.asarray([t.translation for _, t, _ in insts], np.float32)
        ic = np.sqrt(trans[:, 0] ** 2 + trans[:, 1] ** 2 + trans[:, 2] ** 2)
        radii = [ic[i] + obj_radius[m] for i, (m, _, _) in enumerate(insts)]
        return tuple(geoms), instances, radii

    @staticmethod
    def _scene_radius(prim_list, tri_verts, inst_radii=()) -> float:
        """World bounding-sphere radius about the origin (replaces the
        reference renderer's hardcoded 30); conservative norm bounds."""
        r = 0.0

        def acc(dist):
            nonlocal r
            if dist.size:
                m = float(np.max(dist))
                if np.isfinite(m):
                    r = max(r, m)

        param = np.asarray([p.param for p in prim_list], np.float32)
        trans = np.asarray([p.transform.translation for p in prim_list], np.float32)
        px, py, pz = param[:, 0], param[:, 1], param[:, 2]
        extent = np.sqrt(px * px + py * py + pz * pz)
        center = np.sqrt(trans[:, 0] ** 2 + trans[:, 1] ** 2 + trans[:, 2] ** 2)
        real = extent > 0.0  # skip the radius-0 placeholder sphere
        acc((center + extent)[real])
        if tri_verts is not None:
            v0, e1, e2 = tri_verts
            for v in (v0, v0 + e1, v0 + e2):
                acc(np.linalg.norm(v, axis=1))
        for radius in inst_radii:
            acc(np.asarray([radius]))
        if r <= 0.0:
            return 30.0
        return float(max(1.05 * r, 1e-3))

    def _build_meta(self, prim_list, tri_verts, inst_radii=()) -> T.SceneMeta:
        ls = self.lights
        kinds = tuple(l.kind for l in ls) if ls else (T.LIGHT_POINT,)
        deltas = tuple(l.flags()[0] for l in ls) if ls else (True,)
        bg = next((i for i, l in enumerate(ls) if l.kind == T.LIGHT_BACKGROUND), -1)
        return T.SceneMeta(
            light_kinds=kinds,
            light_is_delta=deltas,
            n_lights=len(ls),
            background_light_index=bg,
            scene_radius=self._scene_radius(prim_list, tri_verts, inst_radii),
        )

    def _build_lights(self, device) -> T.Lights:
        # one dummy light keeps shapes static when the scene has none
        ls = self.lights or [LightDesc(kind=T.LIGHT_POINT, color=(0.0, 0.0, 0.0))]
        flags = [l.flags() for l in ls]
        return T.Lights(
            kind=_i32([l.kind for l in ls], device),
            color=_vec3([l.color for l in ls], device),
            rot=_rot3([l.transform for l in ls], device),
            trans=_vec3([tuple(l.transform.translation) for l in ls], device),
            shape_kind=_i32([l.shape_kind for l in ls], device),
            shape_param=_vec3([l.shape_param for l in ls], device),
            area=_f32([l.surface_area() for l in ls], device),
            cos_angle=_f32([_math.cos(l.angle_rad) for l in ls], device),
            is_delta=torch.as_tensor([f[0] for f in flags], device=device),
            is_finite=torch.as_tensor([f[1] for f in flags], device=device),
            env_tex=_i32([l.env_tex for l in ls], device),
        )
