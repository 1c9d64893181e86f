"""Material parameter resolution (port of ``raytracer_tpu/ops/materials.py``).

A per-ray gather of the material table, modulated by optional textures,
then the wavelength-dependent IoR of dispersive materials (spectral mode)
and the scene's decals.  The reference fetches the columns with a one-hot
matmul on the TPU's matrix unit (``ops/smallgather.py``); plain indexing
gives the same values on a GPU.  A scene without textures pays for none of
the texture work.
"""

from __future__ import annotations

import torch

from ..color.spectrum import cauchy_ior
from ..math.vec import Vec3, cross, dot, normalize, sqrt_rn, where as vwhere
from ..scene.types import Rot3, SceneData
from .bsdf import MatParams
from .textures import sample_texture_many


def _gather_vec3(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _apply_decals(scene: SceneData, position: Vec3, base_color: Vec3, roughness):
    """Alpha-blend the decals (sorted by descending order) onto base color
    and roughness at the shading points ``position``.  A point is inside a
    decal when its local coordinates, mapped to [0, 1]^3 over the box, all
    lie in [0, 1]; (u, v) are its texture coordinates.  D is small and
    known on the host: one pass of lane-wise work per decal, two texture
    lookups each when the scene has an atlas."""
    d = scene.decals
    for i in range(d.count):
        rot = Rot3(_gather_vec3(d.rot.r0, i), _gather_vec3(d.rot.r1, i), _gather_vec3(d.rot.r2, i))
        local = rot.to_local(position - _gather_vec3(d.trans, i))
        hs = _gather_vec3(d.half_size, i)
        u = 0.5 * (local.x / torch.clamp_min(hs.x, 1e-8) + 1.0)
        v = 0.5 * (local.y / torch.clamp_min(hs.y, 1e-8) + 1.0)
        w = 0.5 * (local.z / torch.clamp_min(hs.z, 1e-8) + 1.0)
        inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & (w >= 0.0) & (w <= 1.0)
        color = _gather_vec3(d.base_color, i)
        alpha_t = torch.ones_like(u)
        if scene.textures is not None:
            # INVALID_ID lanes read 1.0
            tid = torch.zeros_like(u, dtype=torch.int32) + d.base_color_tex[i]
            color = color * sample_texture_many(scene.textures, tid, u, v, site="decal")
            aid = torch.zeros_like(tid) + d.alpha_tex[i]
            alpha_t = sample_texture_many(scene.textures, aid, u, v, site="decal").x
        alpha = d.alpha_min[i] + (d.alpha_max[i] - d.alpha_min[i]) * alpha_t
        a = torch.where(inside, alpha, 0.0)
        base_color = base_color * (1.0 - a) + color * a
        roughness = roughness * (1.0 - a) + d.roughness[i] * a
    return base_color, roughness


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
    t = sample_texture_many(scene.textures, ntex, frame.tex_u, frame.tex_v, site="normal")
    nx = 2.0 * t.x - 1.0
    ny = 2.0 * t.y - 1.0
    nz = sqrt_rn(torch.clamp_min(1.0 - nx * nx - ny * ny, 1e-12))
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


def resolve_material(scene: SceneData, material_id, tex_u=None, tex_v=None,
                     wavelength=None, position=None) -> MatParams:
    """Material table rows at ``material_id``; with a texture atlas and
    UVs, base color, emission, roughness and metalness are modulated by
    their textures (a parameter is ``constant * texture``).
    ``wavelength`` (N,) nm, spectral mode: dispersive materials get the
    IoR at that wavelength, by the Cauchy C / D terms or, where
    ``disp_use_abbe``, the (IoR, abbe) form.  ``position`` (N,) world
    shading points: the scene's decals are applied there."""
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
    ior = mats.ior[idx]
    dispersive = mats.dispersive[idx]
    if wavelength is not None:
        lam_um = wavelength * 1e-3
        l2 = torch.clamp_min(lam_um * lam_um, 1e-6)
        ior_cd = ior + mats.dispersion_c[idx] / l2 + mats.dispersion_d[idx] / (l2 * l2)
        ior_ab = cauchy_ior(ior, mats.abbe[idx], wavelength)
        ior = torch.where(dispersive, torch.where(mats.disp_use_abbe[idx], ior_ab, ior_cd), ior)
    if scene.decals is not None and position is not None:
        base_color, roughness = _apply_decals(scene, position, base_color, roughness)
    return MatParams(
        bsdf=mats.bsdf[idx],
        base_color=base_color,
        emission=emission,
        roughness=roughness,
        metalness=metalness,
        ior=ior,
        k=mats.k[idx],
        dispersive=dispersive,
    )
