"""Material parameter resolution (port of ``raytracer_tpu/ops/materials.py``).

A per-ray gather of the material table.  The reference fetches the columns
with a one-hot matmul on the TPU's matrix unit (``ops/smallgather.py``);
plain indexing gives the same values on a GPU.  Without textures the
reference's ``apply_normal_map`` is the identity, so the port has none yet;
textures, normal maps and decals wait (ROADMAP queue 0).
"""

from __future__ import annotations

import torch

from ..math.vec import Vec3
from ..scene.types import SceneData
from .bsdf import MatParams


def _gather_vec3(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def resolve_material(scene: SceneData, material_id) -> MatParams:
    """Material table rows at ``material_id``."""
    mats = scene.materials
    idx = torch.clamp_min(material_id, 0).long()
    return MatParams(
        bsdf=mats.bsdf[idx],
        base_color=_gather_vec3(mats.base_color, idx),
        emission=_gather_vec3(mats.emission, idx),
        roughness=mats.roughness[idx],
        metalness=mats.metalness[idx],
        ior=mats.ior[idx],
        k=mats.k[idx],
    )
