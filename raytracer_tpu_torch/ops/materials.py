"""Material parameter resolution (port of ``raytracer_tpu/ops/materials.py``).

A per-ray gather of the material table, modulated by optional textures.
The reference fetches the columns with a one-hot matmul on the TPU's matrix
unit (``ops/smallgather.py``); plain indexing gives the same values on a
GPU.  A scene without textures pays for none of the texture work.  Decals
and the wavelength-dependent IoR wait (ROADMAP queue 0).
"""

from __future__ import annotations

import torch

from ..math.vec import Vec3, cross, dot, normalize, where as vwhere
from ..scene.types import SceneData
from .bsdf import MatParams
from .textures import sample_texture_many


def _gather_vec3(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def apply_normal_map(scene: SceneData, frame):
    """Perturb the shading frame by the material's tangent-space normal map:
    fetch, [0,1] -> [-1,1], reconstruct z, lerp toward +Z by
    ``normal_strength``, rotate into the frame, then re-orthogonalize the
    tangent against the new normal.  (``mask_tex`` is stored and never read,
    as in the reference.)"""
    if scene.textures is None:
        return frame
    mats = scene.materials
    idx = torch.clamp_min(frame.material_id, 0).long()
    ntex = mats.normal_tex[idx]
    has = ntex >= 0
    t = sample_texture_many(scene.textures, ntex, frame.tex_u, frame.tex_v)
    nx = 2.0 * t.x - 1.0
    ny = 2.0 * t.y - 1.0
    nz = torch.sqrt(torch.clamp_min(1.0 - nx * nx - ny * ny, 1e-12))
    s = mats.normal_strength[idx]
    # lerp(+Z, n, strength)
    nx = nx * s
    ny = ny * s
    nz = nz * s + (1.0 - s)
    world_n = normalize(frame.tangent * nx + frame.bitangent * ny + frame.normal * nz, eps=1e-20)
    new_n = vwhere(has, world_n, frame.normal)
    # orthogonalize the tangent, rebuild the bitangent with build_onb's handedness
    new_t = normalize(frame.tangent - new_n * dot(frame.tangent, new_n), eps=1e-20)
    new_b = cross(new_n, new_t)
    return frame._replace(normal=new_n, tangent=new_t, bitangent=new_b)


def resolve_material(scene: SceneData, material_id, tex_u=None, tex_v=None) -> MatParams:
    """Material table rows at ``material_id``; with a texture atlas and
    UVs, base color, emission, roughness and metalness are modulated by
    their textures (a parameter is ``constant * texture``)."""
    mats = scene.materials
    idx = torch.clamp_min(material_id, 0).long()
    base_color = _gather_vec3(mats.base_color, idx)
    emission = _gather_vec3(mats.emission, idx)
    roughness = mats.roughness[idx]
    metalness = mats.metalness[idx]
    if scene.textures is not None and tex_u is not None:
        tex = lambda column: sample_texture_many(scene.textures, column[idx], tex_u, tex_v)
        base_color = base_color * tex(mats.base_color_tex)
        emission = emission * tex(mats.emission_tex)
        roughness = roughness * tex(mats.roughness_tex).x
        metalness = metalness * tex(mats.metalness_tex).x
    return MatParams(
        bsdf=mats.bsdf[idx],
        base_color=base_color,
        emission=emission,
        roughness=roughness,
        metalness=metalness,
        ior=mats.ior[idx],
        k=mats.k[idx],
    )
