"""Branchless wavefront BSDF sampling / evaluation (port of
``raytracer_tpu/ops/bsdf.py``).

Every lobe family is evaluated masked over the whole wavefront and selected
by the per-ray material kind.  Local shading space (+Z = normal); ``wo``
points to the viewer, ``wi`` to the light / next bounce, both away from the
surface.  ``sample()`` returns the throughput weight f·cos/pdf;
``evaluate()`` returns f·cos and the forward pdf.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..math.fresnel import fresnel_dielectric, fresnel_metal
from ..math.microfacet import ggx_d, ggx_g, ggx_pdf, ggx_sample
from ..math.sampling import sample_hemisphere_cos
from ..math.vec import Vec3, dot, max_component, normalize, sqrt_rn, where as vwhere
from ..scene.types import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_METAL,
    BSDF_NULL,
    BSDF_PLASTIC,
    BSDF_ROUGH_DIELECTRIC,
    BSDF_ROUGH_DIFFUSE,
    BSDF_ROUGH_METAL,
    BSDF_ROUGH_PLASTIC,
    SPECULAR_ROUGHNESS_THRESHOLD,
)

INV_PI = 1.0 / math.pi
COS_EPS = 1.0e-5


class MatParams(NamedTuple):
    """Per-ray resolved material parameters."""

    bsdf: torch.Tensor  # (N,) int32
    base_color: Vec3
    emission: Vec3
    roughness: torch.Tensor
    metalness: torch.Tensor
    ior: torch.Tensor
    k: torch.Tensor
    # lanes whose IoR depends on the wavelength (the path's hero wavelength
    # collapses when it scatters off one, in spectral mode)
    dispersive: torch.Tensor = None


class BsdfSample(NamedTuple):
    wi: Vec3  # sampled direction (local space, away from surface)
    pdf: torch.Tensor  # solid-angle pdf of the sampled lobe
    weight: Vec3  # f * cos / pdf
    specular: torch.Tensor  # bool: Dirac event (MIS bookkeeping)
    valid: torch.Tensor  # bool: sampling succeeded


def _select(conds, vals, default):
    """``jnp.select``: the value of the first true condition, else default."""
    out = default
    for c, v in reversed(list(zip(conds, vals))):
        out = torch.where(c, v, out)
    return out


def effective_kind(mp: MatParams) -> torch.Tensor:
    """Rough BSDFs below the roughness threshold act as their specular twin."""
    k = mp.bsdf
    smooth = mp.roughness < SPECULAR_ROUGHNESS_THRESHOLD
    k = torch.where(smooth & (k == BSDF_ROUGH_METAL), BSDF_METAL, k)
    k = torch.where(smooth & (k == BSDF_ROUGH_DIELECTRIC), BSDF_DIELECTRIC, k)
    k = torch.where(smooth & (k == BSDF_ROUGH_PLASTIC), BSDF_PLASTIC, k)
    return k


def _mirror_z(wo: Vec3) -> Vec3:
    return Vec3(-wo.x, -wo.y, wo.z)


def _reflect_about(wo: Vec3, m: Vec3) -> Vec3:
    return m * (2.0 * dot(wo, m)) - wo


def _refract_through(wo: Vec3, m: Vec3, ior):
    """Refract ``-wo`` through normal ``m``; returns (wi, valid)."""
    i = -wo
    cosi = dot(i, m)
    eta = torch.where(cosi < 0.0, 1.0 / ior, ior)
    n_opp = vwhere(cosi < 0.0, m, -m)
    c = torch.abs(cosi)
    k = 1.0 - eta * eta * (1.0 - c * c)
    t = i * eta + n_opp * (eta * c - sqrt_rn(torch.clamp_min(k, 1e-12)))
    return normalize(t, eps=1e-6), k > 0.0


def _oren_nayar(n_dot_l, n_dot_v, l_dot_v, roughness):
    """Improved Oren-Nayar internal term."""
    s2 = roughness * roughness
    a = 1.0 - 0.5 * s2 / (0.33 + s2)
    b = 0.45 * s2 / (0.09 + s2)
    s = l_dot_v - n_dot_l * n_dot_v
    stinv = torch.where(s > 0.0, s / torch.clamp_min(torch.maximum(n_dot_l, n_dot_v), 1e-7), 0.0)
    return torch.clamp_min(a + b * stinv, 0.0)


def _plastic_probs(f_i, base_max):
    """Fresnel-balanced lobe probabilities (evaluate path)."""
    spec_w = f_i
    diff_w = (1.0 - f_i) * base_max
    p_spec = spec_w / torch.clamp_min(spec_w + diff_w, 1e-6)
    return p_spec, 1.0 - p_spec


def sample(mp: MatParams, wo: Vec3, u1, u2, u3) -> BsdfSample:
    """Sample every lobe family masked, select by kind."""
    kind = effective_kind(mp)
    n_dot_v = wo.z
    alpha_sq = (mp.roughness * mp.roughness) ** 2
    zero = torch.zeros_like(n_dot_v)
    one = torch.ones_like(n_dot_v)

    cos_wi = sample_hemisphere_cos(u1, u2)  # shared by diffuse-family lobes
    m = ggx_sample(alpha_sq, u1, u2)  # shared by GGX lobes
    m_pdf = ggx_pdf(alpha_sq, m.z)
    base_max = max_component(mp.base_color)

    # diffuse / roughDiffuse
    diff_pdf = cos_wi.z * INV_PI
    l_dot_v = torch.clamp_min(dot(wo, cos_wi), 0.0)
    on = _oren_nayar(cos_wi.z, n_dot_v, l_dot_v, mp.roughness)
    diff_weight = vwhere(kind == BSDF_ROUGH_DIFFUSE, mp.base_color * on, mp.base_color)
    diff_valid = n_dot_v > COS_EPS

    # metal
    f_metal = fresnel_metal(torch.abs(n_dot_v), mp.ior, mp.k)
    metal_wi = _mirror_z(wo)
    metal_weight = mp.base_color * f_metal
    metal_valid = n_dot_v > COS_EPS

    # roughMetal
    rm_wi = _reflect_about(wo, m)
    v_dot_h = dot(m, wo)
    rm_d = ggx_d(alpha_sq, m.z)
    rm_g = ggx_g(alpha_sq, n_dot_v, rm_wi.z)
    rm_f = fresnel_metal(v_dot_h, mp.ior, mp.k)
    rm_pdf = m_pdf / torch.clamp_min(4.0 * v_dot_h, 1e-6)
    rm_weight = mp.base_color * (v_dot_h * rm_f * rm_g * rm_d / torch.clamp_min(m_pdf * n_dot_v, 1e-6))
    rm_valid = (n_dot_v > COS_EPS) & (rm_wi.z > COS_EPS)

    # dielectric
    f_d = fresnel_dielectric(n_dot_v, mp.ior)
    min_refl_p = 0.25
    refl_p = min_refl_p + (1.0 - min_refl_p) * f_d
    d_reflect = (refl_p >= 1.0) | (u3 < refl_p)
    d_refr_wi, d_refr_ok = _refract_through(wo, Vec3(zero, zero, one), mp.ior)
    d_wi = vwhere(d_reflect, _mirror_z(wo), d_refr_wi)
    d_side_ok = (n_dot_v * d_wi.z > 0.0) == d_reflect
    d_pdf = torch.where(d_reflect, refl_p, 1.0 - refl_p)
    d_weight = vwhere(
        d_reflect,
        Vec3.full(f_d / refl_p),
        mp.base_color * ((1.0 - f_d) / torch.clamp_min(1.0 - refl_p, 1e-6)),
    )
    d_valid = (torch.abs(n_dot_v) > COS_EPS) & d_side_ok & (d_reflect | d_refr_ok)

    # roughDielectric
    rd_f = fresnel_dielectric(v_dot_h, mp.ior)
    rd_reflect = u3 < rd_f
    rd_refr_wi, rd_refr_ok = _refract_through(wo, m, mp.ior)
    rd_wi = vwhere(rd_reflect, _reflect_about(wo, m), rd_refr_wi)
    rd_side_ok = (n_dot_v * rd_wi.z > 0.0) == rd_reflect
    rd_l_dot_h = dot(m, rd_wi)
    rd_d = ggx_d(alpha_sq, m.z)
    rd_g = ggx_g(alpha_sq, n_dot_v, rd_wi.z)
    rd_common = torch.abs(v_dot_h) * rd_g * rd_d / torch.clamp_min(m_pdf * torch.abs(n_dot_v), 1e-6)
    eta = torch.where(n_dot_v < 0.0, mp.ior, 1.0 / mp.ior)
    rd_denom = torch.square(eta * v_dot_h + rd_l_dot_h)
    rd_pdf = torch.where(
        rd_reflect,
        rd_f * m_pdf / torch.clamp_min(4.0 * torch.abs(v_dot_h), 1e-6),
        (1.0 - rd_f) * m_pdf * torch.abs(rd_l_dot_h) / torch.clamp_min(rd_denom, 1e-6),
    )
    rd_weight = vwhere(rd_reflect, Vec3.full(rd_common), mp.base_color * rd_common)
    rd_valid = (torch.abs(n_dot_v) > COS_EPS) & rd_side_ok & (rd_reflect | rd_refr_ok)

    # plastic
    min_spec = 0.25
    p_spec_w = min_spec + f_d * (1.0 - min_spec)
    p_diff_w = (1.0 - f_d) * base_max
    p_spec_p = p_spec_w / torch.clamp_min(p_spec_w + p_diff_w, 1e-6)
    p_is_spec = (p_spec_p >= 1.0) | (u3 < p_spec_p)
    f_o_pl = fresnel_dielectric(cos_wi.z, mp.ior)
    pl_wi = vwhere(p_is_spec, _mirror_z(wo), cos_wi)
    pl_pdf = torch.where(p_is_spec, p_spec_p, cos_wi.z * INV_PI * (1.0 - p_spec_p))
    pl_weight = vwhere(
        p_is_spec,
        Vec3.full(f_d / torch.clamp_min(p_spec_p, 1e-6)),
        mp.base_color * ((1.0 - f_d) * (1.0 - f_o_pl) / torch.clamp_min(1.0 - p_spec_p, 1e-6)),
    )
    pl_valid = n_dot_v > COS_EPS

    # roughPlastic
    rp_spec_p, rp_diff_p = _plastic_probs(f_d, base_max)
    rp_is_spec = u3 < rp_spec_p
    rp_wi = vwhere(rp_is_spec, rm_wi, cos_wi)
    rp_f = fresnel_dielectric(v_dot_h, mp.ior)
    rp_spec_pdf = m_pdf / torch.clamp_min(4.0 * v_dot_h, 1e-6) * rp_spec_p
    rp_spec_weight = v_dot_h * rp_f * rm_g * rm_d / torch.clamp_min(m_pdf * n_dot_v * rp_spec_p, 1e-6)
    rp_pdf = torch.where(rp_is_spec, rp_spec_pdf, cos_wi.z * INV_PI * rp_diff_p)
    rp_weight = vwhere(
        rp_is_spec,
        Vec3.full(rp_spec_weight),
        mp.base_color * ((1.0 - f_d) * (1.0 - f_o_pl) / torch.clamp_min(rp_diff_p, 1e-6)),
    )
    rp_valid = (n_dot_v > COS_EPS) & torch.where(rp_is_spec, (rm_wi.z > COS_EPS) & (v_dot_h > COS_EPS), True)

    # select by kind
    conds = [kind == BSDF_DIFFUSE, kind == BSDF_ROUGH_DIFFUSE, kind == BSDF_DIELECTRIC,
             kind == BSDF_ROUGH_DIELECTRIC, kind == BSDF_METAL, kind == BSDF_ROUGH_METAL,
             kind == BSDF_PLASTIC, kind == BSDF_ROUGH_PLASTIC]

    def sel3(*vecs_and_default) -> Vec3:
        vecs, dflt = vecs_and_default[:-1], vecs_and_default[-1]
        return Vec3(*(_select(conds, [v[i] for v in vecs], dflt[i]) for i in range(3)))

    f_b, t_b = torch.zeros_like(zero, dtype=torch.bool), torch.ones_like(zero, dtype=torch.bool)
    wi = sel3(cos_wi, cos_wi, d_wi, rd_wi, metal_wi, rm_wi, pl_wi, rp_wi, Vec3(zero, zero, one))
    pdf = _select(conds, [diff_pdf, diff_pdf, d_pdf, rd_pdf, one, rm_pdf, pl_pdf, rp_pdf], zero)
    weight = sel3(diff_weight, diff_weight, d_weight, rd_weight, metal_weight, rm_weight,
                  pl_weight, rp_weight, Vec3.full(zero))
    valid = _select(conds, [diff_valid, diff_valid, d_valid, rd_valid, metal_valid, rm_valid,
                            pl_valid, rp_valid], f_b) & (kind != BSDF_NULL)
    specular = _select(conds, [f_b, f_b, t_b, f_b, t_b, f_b, p_is_spec, f_b], f_b)
    return BsdfSample(wi=wi, pdf=pdf, weight=weight, specular=specular, valid=valid)


def evaluate(mp: MatParams, wo: Vec3, wi: Vec3):
    """f·cos and forward pdf for NEE/MIS; Dirac lobes return zero."""
    kind = effective_kind(mp)
    n_dot_v = wo.z
    n_dot_l = wi.z
    zero = torch.zeros_like(n_dot_v)
    alpha_sq = (mp.roughness * mp.roughness) ** 2
    base_max = max_component(mp.base_color)

    front = (n_dot_v > COS_EPS) & (n_dot_l > COS_EPS)

    # diffuse / roughDiffuse
    l_dot_v = torch.clamp_min(dot(wo, wi), 0.0)
    on = _oren_nayar(n_dot_l, n_dot_v, l_dot_v, mp.roughness)
    diff_f = mp.base_color * (n_dot_l * INV_PI)
    rdiff_f = diff_f * on
    diff_pdf = n_dot_l * INV_PI

    # roughMetal
    m = normalize(wo + wi, eps=1e-6)
    v_dot_h = dot(m, wo)
    gg_ok = front & (v_dot_h > COS_EPS)
    d_term = ggx_d(alpha_sq, m.z)
    g_term = ggx_g(alpha_sq, n_dot_v, n_dot_l)
    f_metal = fresnel_metal(v_dot_h, mp.ior, mp.k)
    rm_f = mp.base_color * (f_metal * g_term * d_term / torch.clamp_min(4.0 * n_dot_v, 1e-6))
    rm_pdf = ggx_pdf(alpha_sq, m.z) / torch.clamp_min(4.0 * v_dot_h, 1e-6)

    # roughDielectric (reflection + transmission)
    both = (torch.abs(n_dot_v) > COS_EPS) & (torch.abs(n_dot_l) > COS_EPS)
    reflection = n_dot_v * n_dot_l >= 0.0
    eta = torch.where(n_dot_v < 0.0, mp.ior, 1.0 / mp.ior)
    m_rd_raw = vwhere(reflection, wo + wi, wo * eta + wi)
    m_rd = normalize(m_rd_raw * torch.where(m_rd_raw.z < 0.0, -1.0, 1.0), eps=1e-6)
    vh = dot(m_rd, wo)
    lh = dot(m_rd, wi)
    f_rd = fresnel_dielectric(vh, mp.ior)
    d_rd = ggx_d(alpha_sq, m_rd.z)
    g_rd = ggx_g(alpha_sq, n_dot_v, n_dot_l)
    mpdf_rd = ggx_pdf(alpha_sq, m_rd.z)
    denom = torch.square(eta * vh + lh)
    rd_refl_pdf = f_rd * mpdf_rd / torch.clamp_min(4.0 * torch.abs(vh), 1e-6)
    rd_refl_f = f_rd * g_rd * d_rd / torch.clamp_min(4.0 * torch.abs(n_dot_v), 1e-6)
    rd_tran_pdf = (1.0 - f_rd) * mpdf_rd * torch.abs(lh) / torch.clamp_min(denom, 1e-6)
    rd_tran_f = (torch.abs(vh * lh) * (1.0 - f_rd) * g_rd * d_rd
                 / torch.clamp_min(denom * torch.abs(n_dot_v), 1e-6))
    rd_ok = both & (torch.abs(m_rd.z) > COS_EPS)
    rd_f_scalar = torch.where(rd_ok, torch.where(reflection, rd_refl_f, rd_tran_f), 0.0)
    rd_pdf = torch.where(rd_ok, torch.where(reflection, rd_refl_pdf, rd_tran_pdf), 0.0)
    rd_f = Vec3.full(rd_f_scalar)

    # plastic
    f_i = fresnel_dielectric(n_dot_v, mp.ior)
    f_o = fresnel_dielectric(n_dot_l, mp.ior)
    p_spec_p, p_diff_p = _plastic_probs(f_i, base_max)
    pl_f = mp.base_color * (n_dot_l * INV_PI * (1.0 - f_i) * (1.0 - f_o))
    pl_pdf = n_dot_l * INV_PI * p_diff_p

    # roughPlastic
    rp_spec_pdf = torch.where(gg_ok, rm_pdf, 0.0)
    rp_spec_f = torch.where(
        gg_ok,
        fresnel_dielectric(v_dot_h, mp.ior) * g_term * d_term / torch.clamp_min(4.0 * n_dot_v, 1e-6),
        0.0,
    )
    rp_f = pl_f + Vec3.full(rp_spec_f)
    rp_pdf = pl_pdf + rp_spec_f * 0.0 + rp_spec_pdf * p_spec_p

    conds = [kind == BSDF_DIFFUSE, kind == BSDF_ROUGH_DIFFUSE, kind == BSDF_ROUGH_DIELECTRIC,
             kind == BSDF_ROUGH_METAL, kind == BSDF_PLASTIC, kind == BSDF_ROUGH_PLASTIC]
    masks = [front, front, rd_ok, gg_ok, front, front]
    f_vals = [diff_f, rdiff_f, rd_f, rm_f, pl_f, rp_f]
    pdf_vals = [diff_pdf, diff_pdf, rd_pdf, rm_pdf, pl_pdf, rp_pdf]
    f = Vec3(*(
        _select(conds, [torch.where(mk, v[i], 0.0) for mk, v in zip(masks, f_vals)], zero)
        for i in range(3)
    ))
    pdf = _select(conds, [torch.where(mk, p, 0.0) for mk, p in zip(masks, pdf_vals)], zero)
    return f, pdf


def evaluate_with_rev(mp: MatParams, wo: Vec3, wi: Vec3):
    """``evaluate`` plus the REVERSE pdf (the pdf of sampling ``wo`` when
    shading from ``wi``), which bidirectional MIS needs: the forward pdf
    with the roles swapped."""
    f, pdf = evaluate(mp, wo, wi)
    _, rev = evaluate(mp, wi, wo)
    return f, pdf, rev
