"""Wavefront ray / analytic-primitive intersection (port of
``raytracer_tpu/ops/intersect.py``).

Rays are transformed into each primitive's local space, intersected
branchlessly, and the closest hit is kept.  The reference scans over
primitives with ``lax.scan``; here it is a python loop (P is small).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..math.vec import Vec3, normalize, sqrt_rn, where as vwhere, dot
from ..scene.types import PRIM_BOX, PRIM_SPHERE, Primitives, Rot3

BIG = 3.0e38
HIT_EPS = 1e-4


class Hits(NamedTuple):
    """Closest-hit record (SoA)."""

    t: torch.Tensor  # (N,) distance, BIG if miss
    prim_id: torch.Tensor  # (N,) int32 index into Primitives, -1 = miss/tri
    tri_id: torch.Tensor  # (N,) int32 triangle index, -1 unless triangle hit
    u: torch.Tensor  # (N,) barycentric / local coords
    v: torch.Tensor
    overflow: torch.Tensor = None  # (N,) bool: traversal may have truncated
    # instance index for hits on instanced meshes; -1 = baked geometry,
    # analytic prim or miss
    inst_id: torch.Tensor = None
    # winner's interpolated shading frame for triangle hits: 6-tuple
    # (nx, ny, nz, tex_u, tex_v, material_id as f32), in the mesh's space
    # (object space for instanced hits)
    attr: tuple = None


def _local_ray(prim_rot: Rot3, prim_trans: Vec3, origin: Vec3, direction: Vec3):
    return prim_rot.to_local(origin - prim_trans), prim_rot.to_local(direction)


def _intersect_sphere(o: Vec3, d: Vec3, radius):
    """Stable quadratic; returns (near, far, valid)."""
    v = dot(d, -o)
    det = radius * radius - dot(o, o) + v * v
    s = sqrt_rn(torch.clamp_min(det, 1e-12))
    return v - s, v + s, det > 0.0


def _safe_inv(d):
    return 1.0 / torch.where(torch.abs(d) > 1e-9, d, 1e-9)


def _intersect_box(o: Vec3, d: Vec3, half: Vec3):
    """Slab test; returns (near, far, valid)."""
    ix, iy, iz = _safe_inv(d.x), _safe_inv(d.y), _safe_inv(d.z)
    t1 = Vec3((-half.x - o.x) * ix, (-half.y - o.y) * iy, (-half.z - o.z) * iz)
    t2 = Vec3((half.x - o.x) * ix, (half.y - o.y) * iy, (half.z - o.z) * iz)
    tmin = torch.maximum(torch.maximum(torch.minimum(t1.x, t2.x), torch.minimum(t1.y, t2.y)), torch.minimum(t1.z, t2.z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1.x, t2.x), torch.maximum(t1.y, t2.y)), torch.maximum(t1.z, t2.z))
    return tmin, tmax, tmax >= tmin


def _intersect_rect(o: Vec3, d: Vec3, half: Vec3):
    """Finite plane at local z=0."""
    dz = torch.where(torch.abs(d.z) > 1e-9, d.z, 1e-9)
    t = -o.z / dz
    px = o.x + d.x * t
    py = o.y + d.y * t
    valid = (t > 1e-7) & (torch.abs(px) < half.x) & (torch.abs(py) < half.y)
    return t, t, valid


def _prim_hit_distance(kind, o, d, param, t_min, t_max):
    """Closest valid distance for one primitive: nearDist if in range, else
    farDist (rays starting inside glass hit the back face)."""
    sn, sf, sv = _intersect_sphere(o, d, param.x)
    bn, bf, bv = _intersect_box(o, d, param)
    rn, rf, rv = _intersect_rect(o, d, param)
    is_s, is_b = kind == PRIM_SPHERE, kind == PRIM_BOX
    near = torch.where(is_s, sn, torch.where(is_b, bn, rn))
    far = torch.where(is_s, sf, torch.where(is_b, bf, rf))
    valid = torch.where(is_s, sv, torch.where(is_b, bv, rv))
    near_ok = valid & (near > t_min) & (near < t_max)
    far_ok = valid & (far > t_min) & (far < t_max)
    return torch.where(near_ok, near, torch.where(far_ok, far, BIG))


def _prim_at(v: Vec3, i: int) -> Vec3:
    return Vec3(v.x[i], v.y[i], v.z[i])


def intersect_prims(prims: Primitives, origin: Vec3, direction: Vec3, t_max, time=None):
    """Closest hit over all analytic prims. Returns (t, prim_id).  ``time``
    (N,) is each ray's shutter time: a prim's translation is then
    ``trans + vel * time`` (motion blur); None = static."""
    n = origin.x.shape
    dev = origin.x.device
    best_t = torch.full(n, BIG, dtype=torch.float32, device=dev)
    best_id = torch.full(n, -1, dtype=torch.int32, device=dev)
    for i in range(prims.count):
        rot = Rot3(_prim_at(prims.rot.r0, i), _prim_at(prims.rot.r1, i), _prim_at(prims.rot.r2, i))
        trans = _prim_at(prims.trans, i)
        if time is not None:
            trans = trans + _prim_at(prims.vel, i) * time
        o, d = _local_ray(rot, trans, origin, direction)
        t = _prim_hit_distance(prims.kind[i], o, d, _prim_at(prims.param, i), HIT_EPS,
                               torch.minimum(best_t, t_max))
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_id = torch.where(closer, i, best_id)
    return best_t, best_id


def occluded_prims(prims: Primitives, origin: Vec3, direction: Vec3, t_max, time=None):
    """Any-hit shadow query over the analytic prims."""
    return intersect_prims(prims, origin, direction, t_max, time)[0] < t_max


class PrimFrame(NamedTuple):
    """World-space shading frame at a hit."""

    position: Vec3
    normal: Vec3
    tangent: Vec3
    bitangent: Vec3
    tex_u: torch.Tensor
    tex_v: torch.Tensor
    material_id: torch.Tensor
    light_id: torch.Tensor


def merge_frames(is_tri, a: PrimFrame, b: PrimFrame) -> PrimFrame:
    """Per-lane select between two frames (``a`` where ``is_tri``)."""
    w = lambda x, y: torch.where(is_tri, x, y)
    return PrimFrame(
        position=vwhere(is_tri, a.position, b.position),
        normal=vwhere(is_tri, a.normal, b.normal),
        tangent=vwhere(is_tri, a.tangent, b.tangent),
        bitangent=vwhere(is_tri, a.bitangent, b.bitangent),
        tex_u=w(a.tex_u, b.tex_u),
        tex_v=w(a.tex_v, b.tex_v),
        material_id=w(a.material_id, b.material_id),
        light_id=w(a.light_id, b.light_id),
    )


def _gather_vec3(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def gather_prim(prims: Primitives, idx):
    """The primitives ``idx`` (clamped at 0, so a miss's -1 reads prim 0):
    (kind, rotation, translation, params, material id, light id)."""
    idx = torch.clamp_min(idx, 0).long()
    rot = Rot3(_gather_vec3(prims.rot.r0, idx), _gather_vec3(prims.rot.r1, idx), _gather_vec3(prims.rot.r2, idx))
    return (prims.kind[idx], rot, _gather_vec3(prims.trans, idx), _gather_vec3(prims.param, idx),
            prims.material_id[idx], prims.light_id[idx])


def eval_prim_frame(prims: Primitives, prim_id, origin: Vec3, direction: Vec3, t, time=None) -> PrimFrame:
    """Position / normal / uv / tangent frame at the closest analytic hits:
    sphere normal p/r with spherical uv, box face normal by dominant axis,
    rect +Z.  Miss lanes (t = BIG) are clamped so every path stays finite.
    ``time`` (N,): each ray's shutter time, so that the frame is taken in
    the prim's pose at that time (``trans + vel * time``)."""
    from ..math.sampling import build_onb

    idx = torch.clamp_min(prim_id, 0).long()
    kind, rot, trans, param, material_id, light_id = gather_prim(prims, idx)
    if time is not None:
        trans = trans + _gather_vec3(prims.vel, idx) * time
    t = torch.clamp(t, 0.0, 1e12)
    pos_world = origin + direction * t
    p_local = rot.to_local(pos_world - trans)

    inv_r = 1.0 / torch.clamp_min(param.x, 1e-8)
    sph_n = p_local * inv_r
    horiz2 = p_local.x * p_local.x + p_local.z * p_local.z
    safe_px = torch.where(horiz2 < 1e-12, 1.0, -p_local.x)
    sph_u = torch.atan2(-p_local.z, safe_px) / (2.0 * math.pi) + 0.5
    sph_v = torch.arccos(torch.clamp(-sph_n.y, -0.999999, 0.999999)) / math.pi

    q = Vec3(p_local.x / torch.clamp_min(param.x, 1e-8), p_local.y / torch.clamp_min(param.y, 1e-8),
             p_local.z / torch.clamp_min(param.z, 1e-8))
    ax, ay, az = torch.abs(q.x), torch.abs(q.y), torch.abs(q.z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    box_n = Vec3(
        torch.where(is_x, torch.sign(q.x), 0.0),
        torch.where(is_y, torch.sign(q.y), 0.0),
        torch.where(is_x | is_y, 0.0, torch.sign(q.z)),
    )
    box_u = torch.where(is_x, q.z, q.x)
    box_v = torch.where(is_x, q.y, torch.where(is_y, q.z, q.y))

    zero = torch.zeros_like(t)
    rect_n = Vec3(zero, zero, torch.ones_like(t))

    is_s, is_b = kind == PRIM_SPHERE, kind == PRIM_BOX
    n_local = vwhere(is_s, sph_n, vwhere(is_b, box_n, rect_n))
    u = torch.where(is_s, sph_u, torch.where(is_b, box_u, p_local.x))
    v = torch.where(is_s, sph_v, torch.where(is_b, box_v, p_local.y))
    us = _gather_vec3(prims.uv_scale, idx)
    u = u * us.x
    v = v * us.y

    normal = normalize(rot.to_world(n_local), eps=1e-20)
    tangent, bitangent = build_onb(normal)
    return PrimFrame(
        position=pos_world,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        tex_u=u,
        tex_v=v,
        material_id=material_id,
        light_id=light_id,
    )
