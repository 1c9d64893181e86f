"""Wavefront OBJ + MTL mesh loading (role of `Demo/MeshLoader.cpp` which
wraps tinyobjloader; fresh pure-numpy implementation).

Produces the flattened per-face arrays `SceneBuilder.add_mesh` consumes:
vertices, triangle indices (fan-triangulated polygons), per-vertex normals
(generated from face normals when absent, like `MeshLoader.cpp` tangent/
normal generation), uvs, and per-face material ids resolved through an MTL
library + the scene's material table.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ObjMaterial:
    """Subset of MTL the reference maps onto its Material (`MeshLoader.cpp`)."""

    name: str
    diffuse: tuple = (0.8, 0.8, 0.8)  # Kd
    emission: tuple = (0.0, 0.0, 0.0)  # Ke
    specular: tuple = (0.0, 0.0, 0.0)  # Ks
    shininess: float = 0.0  # Ns
    ior: float = 1.5  # Ni
    dissolve: float = 1.0  # d (1 = opaque)
    diffuse_map: str | None = None  # map_Kd
    bump_map: str | None = None  # map_bump / bump
    alpha_map: str | None = None  # map_d


@dataclass
class ObjMesh:
    vertices: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32 per-vertex
    uvs: np.ndarray  # (V, 2) f32
    faces: np.ndarray  # (F, 3) int64 vertex indices
    face_materials: np.ndarray  # (F,) int32 index into .materials
    materials: list = field(default_factory=list)


def load_mtl(path: str) -> dict[str, ObjMaterial]:
    mats: dict[str, ObjMaterial] = {}
    cur: ObjMaterial | None = None
    if not os.path.exists(path):
        return mats
    for line in open(path, errors="replace"):
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0]
        if key == "newmtl":
            cur = ObjMaterial(name=parts[1] if len(parts) > 1 else "")
            mats[cur.name] = cur
        elif cur is None:
            continue
        elif key == "Kd" and len(parts) >= 4:
            cur.diffuse = tuple(float(v) for v in parts[1:4])
        elif key == "Ke" and len(parts) >= 4:
            cur.emission = tuple(float(v) for v in parts[1:4])
        elif key == "Ks" and len(parts) >= 4:
            cur.specular = tuple(float(v) for v in parts[1:4])
        elif key == "Ns":
            cur.shininess = float(parts[1])
        elif key == "Ni":
            cur.ior = float(parts[1])
        elif key == "d":
            cur.dissolve = float(parts[1])
        elif key == "map_Kd":
            cur.diffuse_map = parts[-1]
        elif key in ("map_bump", "bump"):
            cur.bump_map = parts[-1]
        elif key == "map_d":
            cur.alpha_map = parts[-1]
    return mats


def load_obj(path: str, scale: float = 1.0) -> ObjMesh:
    """Parse OBJ into flat arrays.

    Deduplicates (v, vt, vn) index triples into unique vertices like the
    reference's unique-vertex pass (`MeshLoader.cpp:90-130`); generates
    area-weighted smooth normals when the file has none.
    """
    positions: list = []
    texcoords: list = []
    normals: list = []
    faces: list = []
    face_mats: list = []
    materials: list[ObjMaterial] = []
    mat_index: dict[str, int] = {}
    mtl: dict[str, ObjMaterial] = {}
    cur_mat = -1

    vert_cache: dict[tuple, int] = {}
    out_pos: list = []
    out_uv: list = []
    out_nrm_idx: list = []

    def resolve(token: str) -> int:
        nonlocal vert_cache
        comp = token.split("/")
        vi = int(comp[0])
        ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
        ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
        # negative indices are relative to current count
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ti - 1 if ti > 0 else (len(texcoords) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(normals) + ni if ni else -1)
        key = (vi, ti, ni)
        idx = vert_cache.get(key)
        if idx is None:
            idx = len(out_pos)
            vert_cache[key] = idx
            out_pos.append(positions[vi])
            out_uv.append(texcoords[ti] if ti >= 0 else (0.0, 0.0))
            out_nrm_idx.append(ni)
        return idx

    base_dir = os.path.dirname(path)
    for line in open(path, errors="replace"):
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0]
        if key == "v":
            positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "vt":
            texcoords.append((float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0))
        elif key == "vn":
            normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "f":
            idx = [resolve(t) for t in parts[1:]]
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append((idx[0], idx[k], idx[k + 1]))
                face_mats.append(cur_mat)
        elif key == "mtllib" and len(parts) > 1:
            mtl.update(load_mtl(os.path.join(base_dir, " ".join(parts[1:]))))
        elif key == "usemtl" and len(parts) > 1:
            name = parts[1]
            if name not in mat_index:
                mat_index[name] = len(materials)
                materials.append(mtl.get(name, ObjMaterial(name=name)))
            cur_mat = mat_index[name]

    if not materials:
        materials.append(ObjMaterial(name="default"))
    v = np.asarray(out_pos, np.float64) * scale
    uv = np.asarray(out_uv, np.float32) if out_uv else np.zeros((len(out_pos), 2), np.float32)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    fm = np.maximum(np.asarray(face_mats, np.int32), 0)

    # per-vertex normals: from file, or area-weighted face-normal accumulation
    n = np.zeros((len(out_pos), 3), np.float64)
    have_any = False
    for i, ni in enumerate(out_nrm_idx):
        if ni >= 0:
            n[i] = normals[ni]
            have_any = True
    if not have_any or (np.linalg.norm(n, axis=1) < 1e-9).any():
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        fn = np.cross(e1, e2)  # area-weighted
        acc = np.zeros_like(n)
        for c in range(3):
            np.add.at(acc, f[:, c], fn)
        missing = np.linalg.norm(n, axis=1) < 1e-9
        n[missing] = acc[missing]
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)

    return ObjMesh(
        vertices=v.astype(np.float32),
        normals=n.astype(np.float32),
        uvs=uv,
        faces=f,
        face_materials=fm,
        materials=materials,
    )
