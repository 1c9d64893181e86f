"""Unified scene traversal: analytic prims, the baked triangle mesh and
instanced meshes (port of ``raytracer_tpu/ops/traverse.py``).

Closest hit across all geometry kinds, and an any-hit occlusion query for
shadow rays.  A mesh goes to the backend that ``set_traversal_mode`` or the
``RT_TRAVERSAL_MODE`` environment variable selects:

- ``"wave2"``: the sort-join engine (``ops/wave2_traverse.py``), exact, with
  per-lane any-hit early exit and interpolated shading attributes.  What
  ``"auto"`` (the default) resolves to.
- ``"bvh"``: the stackless skip-link BVH walk (``ops/bvh_traverse.py``),
  exact, the reference's correctness oracle.  It needs the scene's BVH and
  raises ``ValueError`` without one.  Instanced meshes keep no BVH, so
  under ``bvh`` they go to the port's ``auto`` engine, ``wave2``.
- ``"sorted-pallas"``: octant + Morton ray sort, per-1024-ray-block BFS
  candidates, the stream kernel (``ops/pallas_traverse.py``).  Its per-block
  candidate union truncates on incoherent wavefronts: rays it may have cut
  short are reported as overflow, never silently trusted.
- ``"cluster"``: the per-ray dense two-phase path
  (``ops/cluster_traverse.py``), a second orthogonal implementation for
  validation.
- ``"wave"``: the binned-wavefront engine (``ops/wave_traverse.py``),
  exact, plain PyTorch; what the reference's ``"auto"`` resolves to off the
  TPU.
- ``"null"``: diagnostics only, skips mesh traversal.

Every mode but wave2 runs closest hit on ``|t_cap|`` (same answer, no
early exit).  wave2 and wave return the winners' interpolated attributes;
the others none, so their shading frames are gathered from the triangle
tables.  Every engine sees detached rays (the reference's
``stop_gradient``): hits carry no gradient, and the shading that follows
re-derives the smooth quantities from them.  Instances are traced one at a time: the ray is
moved into the instance's object space and traced through its shared mesh
(``_instance_local_ray``), and the hits fold into one record with the
instance id.
"""

from __future__ import annotations

import os

import torch

from ..math.sampling import build_onb
from ..math.vec import Vec3, normalize, where as vwhere
from ..scene.types import Rot3, SceneData
from ..utils.profiler import span
from .bvh_traverse import bvh_any_hit, bvh_closest_hit, eval_tri_frame
from .cluster_traverse import cluster_any_hit, cluster_closest_hit
from .intersect import BIG, Hits, PrimFrame, eval_prim_frame, intersect_prims, merge_frames
from .pallas_traverse import pallas_sorted_any_hit, pallas_sorted_closest_hit
from .wave2_traverse import ablation_switch, interp_tri_attr, wave2_any_hit, wave2_closest_hit
from .wave_traverse import wave_any_hit, wave_closest_hit

_MODE = "auto"
# ray x cluster pairs one block of scene_traversal_cost holds (each of its
# slab-test temporaries is this many floats)
COST_BLOCK_PAIRS = 1 << 24
_VALID_MODES = ("auto", "wave2", "wave", "sorted-pallas", "cluster", "bvh", "null")


def set_traversal_mode(mode: str) -> None:
    """Select the mesh traversal backend (see the module docstring)."""
    global _MODE
    if mode not in _VALID_MODES:
        raise ValueError(f"traversal mode {mode!r} not in {_VALID_MODES}")
    _MODE = mode


def get_traversal_mode() -> str:
    return _MODE


def _resolved_mode(scene: SceneData = None) -> str:
    """The mode in force: the environment override goes through the same
    validation as ``set_traversal_mode``, so a typo raises.  With a scene,
    ``bvh`` on a scene without a BVH raises too."""
    mode = _MODE
    env = os.environ.get("RT_TRAVERSAL_MODE")
    if env:
        if env not in _VALID_MODES:
            raise ValueError(f"RT_TRAVERSAL_MODE={env!r} not in {_VALID_MODES}")
        mode = env
    if mode == "bvh" and scene is not None and scene.bvh is None:
        # a user selecting the exact oracle must not silently get another path
        raise ValueError(
            "traversal mode 'bvh' requested but the scene has no skip-link BVH "
            "(it holds no baked triangle mesh); use 'wave2'"
        )
    return "wave2" if mode == "auto" else mode


def _detached(*xs):
    """The reference's ``stop_gradient`` before a mesh engine, on each
    ``Vec3`` or tensor of ``xs``: no engine can pass a gradient or record a
    graph."""
    return tuple(Vec3(*(c.detach() for c in x)) if isinstance(x, Vec3) else
                 x.detach() if torch.is_tensor(x) else x for x in xs)


def _cs_closest(mode, clusters, bvh, tris, origin: Vec3, direction: Vec3, t_cap):
    """Closest hit over ONE mesh by the selected backend.  ``t_cap`` may be
    sign-encoded per ray (negative = any-hit lane with limit |t_cap|):
    wave2 honours the early exit per lane, the others trace |t_cap|.
    Returns (t, tri_id, u, v, overflow, attr or None)."""
    origin, direction, t_cap = _detached(origin, direction, t_cap)
    if mode == "wave2":
        return wave2_closest_hit(clusters, origin, direction, t_cap, with_attrs=True)
    t_cap = torch.abs(t_cap)
    if mode == "wave":
        t, tri, u, v, ovf = wave_closest_hit(clusters, origin, direction, t_cap)
        return t, tri, u, v, ovf, interp_tri_attr(clusters, tri, u, v)
    if mode == "null":
        z = torch.zeros_like(origin.x)
        return (torch.full_like(z, BIG), torch.full_like(z, -1, dtype=torch.int32), z, z,
                torch.zeros_like(z, dtype=torch.bool), None)
    if mode == "bvh":
        t, tri, u, v = bvh_closest_hit(bvh, tris, origin, direction, t_cap)
        return t, tri, u, v, torch.zeros_like(origin.x, dtype=torch.bool), None
    if mode == "sorted-pallas":
        return pallas_sorted_closest_hit(clusters, origin, direction, t_cap) + (None,)
    return cluster_closest_hit(clusters, origin, direction, t_cap) + (None,)


def _cs_occluded(mode, clusters, bvh, tris, origin: Vec3, direction: Vec3, t_max):
    """Any-hit over ONE mesh. Returns (occluded, overflow)."""
    origin, direction, t_max = _detached(origin, direction, t_max)
    if mode == "wave2":
        return wave2_any_hit(clusters, origin, direction, t_max)
    if mode == "wave":
        return wave_any_hit(clusters, origin, direction, t_max)
    z = torch.zeros_like(origin.x, dtype=torch.bool)
    if mode == "null":
        return z, z
    if mode == "bvh":
        return bvh_any_hit(bvh, tris, origin, direction, t_max), z
    if mode == "sorted-pallas":
        return pallas_sorted_any_hit(clusters, origin, direction, t_max)
    return cluster_any_hit(clusters, origin, direction, t_max)


def _instance_rot(scene: SceneData, i: int):
    """Instance i's rotation (object -> world rows) and translation, as 0-d
    tensors on the scene's device."""
    inst = scene.instances
    at = lambda v: Vec3(v.x[i], v.y[i], v.z[i])
    return Rot3(at(inst.rot.r0), at(inst.rot.r1), at(inst.rot.r2)), at(inst.trans)


def _instance_local_ray(scene: SceneData, i: int, origin: Vec3, direction: Vec3, time=None):
    """World ray -> instance i's object space: the rigid inverse of its
    pose at each ray's shutter ``time`` (translation ``trans + vel *
    time``; None = static)."""
    rot, trans = _instance_rot(scene, i)
    if time is not None:
        vel = scene.instances.vel
        trans = trans + Vec3(vel.x[i], vel.y[i], vel.z[i]) * time
    return rot.to_local(origin - trans), rot.to_local(direction)


def scene_traverse(scene: SceneData, origin: Vec3, direction: Vec3, t_max=None, time=None, any_hit=None) -> Hits:
    """Closest hit.  ``time`` (N,): each ray's shutter time (motion blur of
    analytic prims and instances; baked world-space triangles are static);
    None = static.  ``any_hit`` (N,) bool, optional: lanes that only need
    an occlusion answer (shadow rays in a fused wavefront) — under wave2
    their mesh query keeps any-hit early exit (t collapses to 0 on the
    first hit)."""
    with span("traverse"):
        return _traverse(scene, origin, direction, t_max, time, any_hit)


def _traverse(scene: SceneData, origin: Vec3, direction: Vec3, t_max, time, any_hit) -> Hits:
    n = origin.x.shape
    dev = origin.x.device
    if t_max is None:
        t_max = torch.full(n, BIG, dtype=torch.float32, device=dev)
    with span("traverse.prims"):
        t_p, pid = intersect_prims(scene.prims, origin, direction, t_max, time)
    mode = _resolved_mode(scene)
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    best = {"t": t_p, "prim": pid, "tri": torch.full(n, -1, dtype=torch.int32, device=dev), "u": z, "v": z,
            "inst": torch.full(n, -1, dtype=torch.int32, device=dev), "attr": (z,) * 6, "have_attr": True}
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)

    def fold(t_t, tid, tu, tv, inst_id, attr):
        """Keep the closer hit per lane; attributes only while every mesh
        returned them."""
        closer = (t_t < best["t"]) & (tid >= 0)
        best["t"] = torch.where(closer, t_t, best["t"])
        best["prim"] = torch.where(closer, -1, best["prim"])
        best["tri"] = torch.where(closer, tid, best["tri"])
        best["u"] = torch.where(closer, tu, best["u"])
        best["v"] = torch.where(closer, tv, best["v"])
        best["inst"] = torch.where(closer, inst_id, best["inst"])
        if attr is None or not best["have_attr"]:
            best["have_attr"] = False
        else:
            best["attr"] = tuple(torch.where(closer, a, b) for a, b in zip(attr, best["attr"]))

    def signed(cap):
        return torch.where(any_hit, -cap, cap) if any_hit is not None else cap

    if scene.tris is not None and scene.clusters is not None:
        with span("traverse.mesh"):
            t_t, tid, tu, tv, ovf, attr = _cs_closest(mode, scene.clusters, scene.bvh, scene.tris, origin,
                                                      direction, signed(torch.minimum(t_p, t_max)))
            overflow = overflow | ovf
            fold(t_t, tid, tu, tv, -1, attr)
    if scene.instances is not None:
        # two-level traversal: each instance's shared mesh, traced in its
        # object space against the best t so far; any-hit lanes never past
        # their t_max.  (The reference caps every lane by the best t alone,
        # which is BIG on a lane nothing has hit yet: a shadow ray is then
        # occluded by an instance BEHIND its light.  Closest-hit lanes keep
        # the reference's cap, so the ray counters agree with it.  Under
        # motion blur each lane meets the instance at its own time.)
        inst_mode = "wave2" if mode == "bvh" else mode  # instanced meshes keep no BVH: the auto engine
        with span("traverse.instances"):
            o_w, d_w = _detached(origin, direction)
            for i, mid in enumerate(scene.instances.mesh_ids):
                geom = scene.mesh_geoms[mid]
                o_l, d_l = _instance_local_ray(scene, i, o_w, d_w, time)
                cap = best["t"] if any_hit is None else torch.where(any_hit, torch.minimum(best["t"], t_max),
                                                                    best["t"])
                t_t, tid, tu, tv, ovf, attr = _cs_closest(inst_mode, geom.clusters, None, geom.tris, o_l, d_l,
                                                          signed(cap))
                overflow = overflow | ovf
                fold(t_t, tid, tu, tv, i, attr)

    has_mesh = (scene.tris is not None and scene.clusters is not None) or scene.instances is not None
    return Hits(t=best["t"], prim_id=best["prim"], tri_id=best["tri"], u=best["u"], v=best["v"],
                overflow=overflow, inst_id=best["inst"],
                attr=best["attr"] if best["have_attr"] and has_mesh else None)


def _cluster_cost(cs, o: Vec3, inv_d: Vec3):
    """(box tests, tri tests) of each ray against one cluster set: a slab
    test of every cluster box, and K triangle tests per box the ray's line
    overlaps ahead of its origin.  Rays go in blocks of
    ``COST_BLOCK_PAIRS // C``; the counts are integers, so blocking changes
    nothing."""
    n = o.x.shape[0]
    lo = (cs.box_min_x, cs.box_min_y, cs.box_min_z)
    hi = (cs.box_max_x, cs.box_max_y, cs.box_max_z)
    step = max(1, COST_BLOCK_PAIRS // max(cs.num_clusters, 1))
    overlapped = []
    for a in range(0, n, step):
        t_near = t_far = None
        for axis in range(3):
            oa, ia = o[axis][a:a + step, None], inv_d[axis][a:a + step, None]
            t1 = (lo[axis][None, :] - oa) * ia
            t2 = (hi[axis][None, :] - oa) * ia
            near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
            t_near = near if t_near is None else torch.maximum(t_near, near)
            t_far = far if t_far is None else torch.minimum(t_far, far)
        overlapped.append((t_far >= torch.clamp_min(t_near, 0.0)).sum(1).to(torch.float32))
    tri = torch.cat(overlapped) * cs.tris_per_cluster if overlapped else o.x.new_zeros((0,))
    return torch.full_like(o.x, float(cs.num_clusters)), tri


def scene_traversal_cost(scene: SceneData, origin: Vec3, direction: Vec3, time=None):
    """Per-ray traversal work: (box tests, tri tests).  Box tests are the
    analytic prims plus every cluster's slab test; tri tests are K for each
    cluster whose box the ray overlaps (the Möller-Trumbore work of the
    wave engines), over the baked mesh and every instance's shared mesh in
    its object space."""
    origin, direction = _detached(origin, direction)
    box_tests = torch.full_like(origin.x, float(scene.prims.count))
    tri_tests = torch.zeros_like(origin.x)
    tiny = 1e-12
    inv = lambda d: 1.0 / torch.where(torch.abs(d) > tiny, d, torch.where(d >= 0, tiny, -tiny))
    if scene.clusters is not None:
        b, t = _cluster_cost(scene.clusters, origin, Vec3(*(inv(c) for c in direction)))
        box_tests = box_tests + b
        tri_tests = tri_tests + t
    if scene.instances is not None:
        for i, mid in enumerate(scene.instances.mesh_ids):
            o_l, d_l = _instance_local_ray(scene, i, origin, direction, time)
            b, t = _cluster_cost(scene.mesh_geoms[mid].clusters, o_l, Vec3(*(inv(c) for c in d_l)))
            box_tests = box_tests + b
            tri_tests = tri_tests + t
    return box_tests, tri_tests


def scene_hit_frame(scene: SceneData, hits: Hits, origin: Vec3, direction: Vec3, time=None) -> PrimFrame:
    """Shading frame for any hit kind: analytic prim, baked triangle or
    instanced triangle.  Triangle frames come from the traversal's
    interpolated ``attr`` channels when every mesh's backend emitted them
    (wave2; object-space normals of instanced hits are rotated to world
    before normalizing), else from a gather of each triangle table.
    ``time``: each ray's shutter time, for the pose of a moving prim (an
    instance moves without turning, so its frame needs no time).
    ``RT_SKIP_TRI_FRAME`` (a diagnostic) returns the prim frame alone."""
    frame = eval_prim_frame(scene.prims, hits.prim_id, origin, direction, hits.t, time=time)
    if ablation_switch("RT_SKIP_TRI_FRAME"):
        return frame
    is_tri = hits.tri_id >= 0
    inst = hits.inst_id if hits.inst_id is not None else torch.full_like(hits.tri_id, -1)

    if hits.attr is not None:
        nx, ny, nz, tu, tv, matf = hits.attr
        nrm = Vec3(nx, ny, nz)
        if scene.instances is not None:
            for i in range(scene.instances.count):
                rot, _ = _instance_rot(scene, i)
                nrm = vwhere(inst == i, rot.to_world(nrm), nrm)
        normal = normalize(nrm, eps=1e-20)
        tangent, bitangent = build_onb(normal)
        tri_frame = PrimFrame(
            position=origin + direction * torch.clamp(hits.t, 0.0, 1e12),
            normal=normal,
            tangent=tangent,
            bitangent=bitangent,
            tex_u=tu,
            tex_v=tv,
            material_id=matf.to(torch.int32),
            light_id=torch.full_like(hits.tri_id, -1),
        )
        return merge_frames(is_tri, tri_frame, frame)

    def own(mask):
        """The hits of one triangle table: tri ids of other tables index
        other arrays, so their lanes read row 0 and are dropped by the merge."""
        return hits._replace(tri_id=torch.where(mask, hits.tri_id, -1)), mask

    if scene.tris is not None:
        h, mask = own(is_tri & (inst < 0))
        frame = merge_frames(mask, eval_tri_frame(scene.tris, h, origin, direction), frame)
    if scene.instances is not None:
        for i, mid in enumerate(scene.instances.mesh_ids):
            h, mask = own(is_tri & (inst == i))
            f_i = eval_tri_frame(scene.mesh_geoms[mid].tris, h, origin, direction)
            rot, _ = _instance_rot(scene, i)
            f_w = f_i._replace(normal=rot.to_world(f_i.normal), tangent=rot.to_world(f_i.tangent),
                               bitangent=rot.to_world(f_i.bitangent))
            frame = merge_frames(mask, f_w, frame)
    return frame


def scene_occluded(scene: SceneData, origin: Vec3, direction: Vec3, t_max, time=None):
    """Any-hit shadow query at each ray's shutter ``time`` (None = static).
    Returns (occluded, overflow): ``overflow`` marks shadow rays whose mesh
    query the backend may have truncated."""
    with span("traverse", occlusion=True):
        return _occluded(scene, origin, direction, t_max, time)


def _occluded(scene: SceneData, origin: Vec3, direction: Vec3, t_max, time):
    n = origin.x.shape
    with span("traverse.prims"):
        t_p, _ = intersect_prims(scene.prims, origin, direction, t_max, time)
    occ = t_p < t_max
    overflow = torch.zeros(n, dtype=torch.bool, device=origin.x.device)
    mode = _resolved_mode(scene)
    if scene.tris is not None and scene.clusters is not None:
        with span("traverse.mesh"):
            mesh_occ, ovf = _cs_occluded(mode, scene.clusters, scene.bvh, scene.tris, origin, direction, t_max)
            occ = occ | mesh_occ
            overflow = overflow | ovf
    if scene.instances is not None:
        inst_mode = "wave2" if mode == "bvh" else mode
        with span("traverse.instances"):
            o_w, d_w = _detached(origin, direction)
            for i, mid in enumerate(scene.instances.mesh_ids):
                geom = scene.mesh_geoms[mid]
                o_l, d_l = _instance_local_ray(scene, i, o_w, d_w, time)
                # already-occluded rays query with limit 0 (the early-out analogue)
                lim = torch.where(occ, 0.0, t_max * torch.ones_like(origin.x))
                mesh_occ, ovf = _cs_occluded(inst_mode, geom.clusters, None, geom.tris, o_l, d_l, lim)
                occ = occ | mesh_occ
                overflow = overflow | ovf
    return occ, overflow
