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
re-derives the smooth quantities from them.

Instances go through a flat top level (``TopLevel``, built once a scene):
every ray is slab-tested against every instance's padded world box, the
(ray, instance) pairs that survive are moved into their instance's object
space (``_instance_local_ray``'s float operations), and each shared mesh is
queried once over all of its pairs.  The hits fold back to their rays as
the per-instance loop of the reference folds them: the least t, ties to the
lowest instance id, baked and prim hits first.
"""

from __future__ import annotations

import os
import weakref
from typing import NamedTuple

import torch

from ..math.sampling import build_onb
from ..math.vec import Vec3, normalize, where as vwhere
from ..scene.types import Rot3, SceneData
from ..utils.profiler import count, host_sync, span
from .bvh_traverse import bvh_any_hit, bvh_closest_hit, eval_tri_frame
from .cluster_traverse import cluster_any_hit, cluster_closest_hit, slab_inv
from .intersect import BIG, Hits, PrimFrame, eval_prim_frame, intersect_prims, merge_frames
from .pallas_traverse import pallas_sorted_any_hit, pallas_sorted_closest_hit
from .wave2_traverse import ablation_switch, interp_tri_attr, wave2_any_hit, wave2_closest_hit
from .wave_traverse import wave_any_hit, wave_closest_hit

_MODE = "auto"
# ray x cluster pairs one block of scene_traversal_cost holds (each of its
# slab-test temporaries is this many floats)
COST_BLOCK_PAIRS = 1 << 24
# ray x instance slab tests one block of the top level's cull holds
TOP_BLOCK_PAIRS = 1 << 24
# engines whose overflow is a per-ray candidate budget, which widens with the cap
_TRUNCATING = ("cluster", "sorted-pallas")
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


class TopLevel(NamedTuple):
    """An instanced scene's flat top level: no tree, one padded world box an
    instance (the scenes hold tens of instances; a tree pays at thousands)."""

    meshes: tuple  # (mesh id, first row, end row) of each mesh that some instance places
    inst_of_row: torch.Tensor  # (I,) int64 instance id of each row; rows in mesh-major order
    box: torch.Tensor  # (6, I) f32 world box at shutter 0 by row [min.xyz, max.xyz], padded outward
    vel: torch.Tensor  # (3, I) f32 velocity by row
    xf: torch.Tensor  # (15, I) f32 by instance id: rotation rows r0, r1, r2, translation, velocity
    mesh_of: torch.Tensor  # (I,) int64 mesh id by instance id


_TOP_LEVELS = {}  # id(scene.instances) -> (weak ref, mesh_geoms, TopLevel): a memo of immutable scene tables


def top_level(scene: SceneData) -> TopLevel:
    """The scene's ``TopLevel``, built at its first query and kept while its
    instance table lives."""
    inst = scene.instances
    got = _TOP_LEVELS.get(id(inst))
    if got is not None and got[0]() is inst and got[1] is scene.mesh_geoms:
        return got[2]
    top = _build_top_level(scene)
    key = id(inst)

    def forget(ref):
        if _TOP_LEVELS.get(key, (None,))[0] is ref:
            del _TOP_LEVELS[key]

    _TOP_LEVELS[key] = (weakref.ref(inst, forget), scene.mesh_geoms, top)
    return top


def _build_top_level(scene: SceneData) -> TopLevel:
    """World boxes: each shared mesh's object-space bound, its 8 corners
    turned by the instance's rotation and moved by its translation, padded
    outward by 1e-5 of the coordinates' magnitude (+ 1e-5) so that no
    rounding of the object-space rays or of the slab test can cull a pair
    whose query would hit."""
    inst = scene.instances
    rows = tuple(sorted(range(inst.count), key=lambda i: (inst.mesh_ids[i], i)))
    meshes = []
    for r, i in enumerate(rows):
        if meshes and meshes[-1][0] == inst.mesh_ids[i]:
            meshes[-1][2] = r + 1
        else:
            meshes.append([inst.mesh_ids[i], r, r + 1])
    dev = inst.trans.x.device
    with host_sync("instances.tables"):
        inst_of_row = torch.tensor(rows, dtype=torch.int64, device=dev)
        mesh_of = torch.tensor(inst.mesh_ids, dtype=torch.int64, device=dev)
    xf = torch.stack([*inst.rot.r0, *inst.rot.r1, *inst.rot.r2, *inst.trans, *inst.vel]).to(torch.float32)
    bounds = []
    for geom in scene.mesh_geoms:
        t = geom.tris
        pts = torch.cat([torch.stack(tuple(p)) for p in (t.v0, t.v0 + t.e1, t.v0 + t.e2)], 1)  # (3, 3T)
        bounds.append(torch.cat([pts.amin(1), pts.amax(1)]))
    ob = torch.stack(bounds).index_select(0, mesh_of)  # (I, 6) object bound by instance id
    bits = torch.arange(8, device=dev)
    corner = [torch.where(((bits >> a) & 1).bool()[None, :], ob[:, 3 + a, None], ob[:, a, None]) for a in range(3)]
    world = [xf[a, :, None] * corner[0] + xf[3 + a, :, None] * corner[1] + xf[6 + a, :, None] * corner[2]
             + xf[9 + a, :, None] for a in range(3)]  # to_world(corner) + trans, (I, 8) each
    lo = torch.stack([w.amin(1) for w in world])
    hi = torch.stack([w.amax(1) for w in world])
    pad = 1e-5 * (torch.abs(lo) + torch.abs(hi) + 1.0)
    box = torch.cat([lo - pad, hi + pad]).index_select(1, inst_of_row)
    return TopLevel(tuple(tuple(m) for m in meshes), inst_of_row, box, xf[12:15].index_select(1, inst_of_row), xf,
                    mesh_of)


def _cull(top: TopLevel, origin: Vec3, direction: Vec3, cap, time):
    """(I, N) bool by row: the ray meets the instance's box at some t in
    [0, cap).  Under motion each ray meets the box at its own shutter time
    (its origin moved by ``-vel * time``), exact for any time.  Rays go in
    blocks of ``TOP_BLOCK_PAIRS // I``, so no (rays x instances) float
    tensor of a whole wavefront is held."""
    n, count_i = origin.x.shape[0], top.box.shape[1]
    keep = torch.empty((count_i, n), dtype=torch.bool, device=origin.x.device)
    inv = [slab_inv(c) for c in direction]
    step = max(1, TOP_BLOCK_PAIRS // count_i)
    for a in range(0, n, step):
        sl = slice(a, a + step)
        near = far = None
        for k in range(3):
            o = origin[k][None, sl]
            if time is not None:
                o = o - top.vel[k][:, None] * time[None, sl]
            t1 = (top.box[k][:, None] - o) * inv[k][None, sl]
            t2 = (top.box[3 + k][:, None] - o) * inv[k][None, sl]
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            near = lo if near is None else torch.maximum(near, lo)
            far = hi if far is None else torch.minimum(far, hi)
        keep[:, sl] = (far >= torch.clamp_min(near, 0.0)) & (near < cap[None, sl])
    return keep


class Pairs(NamedTuple):
    """The (ray, instance) pairs a top-level query sends, grouped by shared
    mesh (rows in mesh-major order), each mesh's pairs ``ends``-delimited."""

    ends: list  # pairs up to and including each row (host ints)
    inst: torch.Tensor  # (P,) int64 instance id
    ray: torch.Tensor  # (P,) int64 ray index
    origin: Vec3  # (P,) object-space origin
    direction: Vec3  # (P,) object-space direction


def _pairs(scene: SceneData, top: TopLevel, origin: Vec3, direction: Vec3, cap, time):
    """The pairs that survive the cull, in object space, or None.  One
    blocking read: the pair count of every row."""
    n, count_i = origin.x.shape[0], top.box.shape[1]
    count("instances.pairs_tested", n * count_i)
    keep = _cull(top, origin, direction, cap, time)
    with host_sync("instances.pair_counts"):
        ends = keep.sum(1).cumsum(0).tolist()
    total = ends[-1]
    count("instances.pairs_sent", total)
    if total == 0:
        return None
    flat = keep.view(-1)
    pos = flat.cumsum(0, dtype=torch.int32 if flat.numel() < 2**31 else torch.int64)
    f = torch.searchsorted(pos, torch.arange(1, total + 1, dtype=pos.dtype, device=pos.device))
    row = torch.div(f, n, rounding_mode="floor")
    ray = f - row * n
    inst = top.inst_of_row.index_select(0, row)
    cols = [*origin, *direction] + ([time] if time is not None else [])
    r = torch.stack(cols).index_select(1, ray)
    x = top.xf.index_select(1, inst)
    rot = Rot3(Vec3(*x[0:3]), Vec3(*x[3:6]), Vec3(*x[6:9]))
    trans = Vec3(*x[9:12])
    if time is not None:  # _instance_local_ray: trans + vel * time, then the rigid inverse
        trans = trans + Vec3(*x[12:15]) * r[6]
    return Pairs(ends, inst, ray, rot.to_local(Vec3(*r[0:3]) - trans), rot.to_local(Vec3(*r[3:6])))


def _by_mesh(scene: SceneData, top: TopLevel, pairs: Pairs, engine, mode, caps):
    """``engine`` (``_cs_closest`` or ``_cs_occluded``) once per shared mesh
    with pairs, over its slice of the pairs and of ``caps``, each call in an
    ``instances.query`` span; the outputs joined field by field in pair
    order (a field of tuples joined member by member; None if any is)."""
    outs = []
    for m, first, end in top.meshes:
        lo, hi = pairs.ends[first - 1] if first else 0, pairs.ends[end - 1]
        if hi > lo:
            geom, sl = scene.mesh_geoms[m], slice(lo, hi)
            with span("instances.query", mesh=m):
                count("instances.queries")
                outs.append(engine(mode, geom.clusters, None, geom.tris, Vec3(*(c[sl] for c in pairs.origin)),
                                   Vec3(*(c[sl] for c in pairs.direction)), caps[sl]))
    if len(outs) == 1:
        return outs[0]

    def join(parts):
        if any(p is None for p in parts):
            return None
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(c) for c in zip(*parts))
        return torch.cat(parts)

    return tuple(join(f) for f in zip(*outs))


def _loop_caps(top: TopLevel, n: int, pairs: Pairs, hit_t, cap):
    """Each pair's cap under the per-instance loop, which queries instance i
    of a ray with the least of ``cap`` and the hits (``hit_t``; inf where
    none) of its instances before i: a prefix minimum over instance ids."""
    h = torch.full((top.box.shape[1], n), float("inf"), device=cap.device)
    h.index_put_((pairs.inst, pairs.ray), hit_t)
    before = torch.cat([torch.full_like(h[:1], float("inf")), torch.cummin(h, 0).values[:-1]])
    return torch.minimum(cap, before[pairs.inst, pairs.ray])


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
        # two-level traversal through the top level: each instance's shared
        # mesh, traced in its object space against the best t of the prims
        # and the baked mesh (the fold then keeps the nearest instance, as
        # the loop over instances did); any-hit lanes never past
        # their t_max.  (The reference caps every lane by the best t alone,
        # which is BIG on a lane nothing has hit yet: a shadow ray is then
        # occluded by an instance BEHIND its light.  Closest-hit lanes keep
        # the reference's cap, so the ray counters agree with it.  Under
        # motion blur each lane meets the instance at its own time.)
        inst_mode = "wave2" if mode == "bvh" else mode  # instanced meshes keep no BVH: the auto engine
        with span("traverse.instances"):
            cap = best["t"] if any_hit is None else torch.where(any_hit, torch.minimum(best["t"], t_max), best["t"])
            ovf, won = _closest_instances(scene, inst_mode, *_detached(origin, direction), signed(cap), time,
                                          best["t"])
            overflow = overflow | ovf
            if won is not None:
                fold(*won)
            elif inst_mode not in ("wave2", "wave"):
                best["have_attr"] = False  # the engine would have returned no attributes

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
            nrm = vwhere(inst >= 0, _lane_rot(scene, inst).to_world(nrm), nrm)
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
        top = top_level(scene)
        rot = _lane_rot(scene, inst)
        mesh = top.mesh_of.index_select(0, torch.clamp_min(inst, 0).long())
        for m, _, _ in top.meshes:
            h, mask = own(is_tri & (inst >= 0) & (mesh == m))
            f_m = eval_tri_frame(scene.mesh_geoms[m].tris, h, origin, direction)
            f_w = f_m._replace(normal=rot.to_world(f_m.normal), tangent=rot.to_world(f_m.tangent),
                               bitangent=rot.to_world(f_m.bitangent))
            frame = merge_frames(mask, f_w, frame)
    return frame


def _lane_rot(scene: SceneData, inst) -> Rot3:
    """Each lane's instance rotation, gathered by ``inst`` (row 0's where
    negative)."""
    x = top_level(scene).xf[:9].index_select(1, torch.clamp_min(inst, 0).long())
    return Rot3(Vec3(*x[0:3]), Vec3(*x[3:6]), Vec3(*x[6:9]))


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
            # already-occluded rays query with limit 0 (the early-out analogue)
            lim = torch.where(occ, 0.0, t_max * torch.ones_like(origin.x))
            mesh_occ, ovf = _occluded_instances(scene, inst_mode, *_detached(origin, direction), lim, time)
            occ = occ | mesh_occ
            overflow = overflow | ovf
    return occ, overflow


def _closest_instances(scene: SceneData, mode, origin: Vec3, direction: Vec3, cap, time, best_t):
    """Closest hit over the instances through the top level, each pair
    capped by its ray's ``cap`` (sign-encoded: any-hit lanes negative).
    Returns (overflow by ray, the fold's winners as (t, tri, u, v, inst,
    attr or None) with tri -1 where no instance beats ``best_t``, or None
    where no pair was sent)."""
    top = top_level(scene)
    n = origin.x.shape[0]
    with span("instances.cull"):
        pairs = _pairs(scene, top, origin, direction, torch.abs(cap), time)
    if pairs is None:
        return torch.zeros(n, dtype=torch.bool, device=origin.x.device), None
    pair_cap = cap.index_select(0, pairs.ray)
    t, tri, u, v, ovf, attr = _by_mesh(scene, top, pairs, _cs_closest, mode, pair_cap)
    if mode in _TRUNCATING:
        # the loop capped instance i by the hits of the instances before it,
        # and these engines' overflow widens with the cap: each pair's flag
        # is taken again at the loop's cap (hits below it are the same)
        with span("instances.fold"):
            looped = _loop_caps(top, n, pairs, torch.where(tri >= 0, t, float("inf")), torch.abs(pair_cap))
        ovf = _by_mesh(scene, top, pairs, _cs_closest, mode, looped)[4]
    with span("instances.fold"):
        ray = pairs.ray
        # the least t a ray, ties to the lowest instance id; baked and prim hits win ties
        valid = (tri >= 0) & (t < best_t.index_select(0, ray))
        least = torch.full((n,), float("inf"), device=t.device).scatter_reduce_(
            0, ray, torch.where(valid, t, float("inf")), "amin")
        tie = valid & (t == least.index_select(0, ray))
        none = top.box.shape[1]
        first = torch.full((n,), none, dtype=torch.int64, device=t.device).scatter_reduce_(
            0, ray, torch.where(tie, pairs.inst, none), "amin")
        dest = torch.where(tie & (pairs.inst == first.index_select(0, ray)), ray, n)  # losers to a spare column
        floats = torch.zeros((3 + (6 if attr is not None else 0), n + 1), device=t.device).index_copy_(
            1, dest, torch.stack([t, u, v, *(attr or ())]))[:, :n]
        ints = torch.full((2, n + 1), -1, dtype=torch.int32, device=t.device).index_copy_(
            1, dest, torch.stack([tri, pairs.inst.to(torch.int32)]))[:, :n]
        overflow = torch.zeros(n, dtype=torch.int32, device=t.device).index_add_(0, ray, ovf.to(torch.int32)) > 0
    return overflow, (floats[0], ints[0], floats[1], floats[2], ints[1], tuple(floats[3:]) if attr is not None else None)


def _occluded_instances(scene: SceneData, mode, origin: Vec3, direction: Vec3, lim, time):
    """Any-hit over the instances through the top level, each pair limited
    by its ray's ``lim``.  Returns (occluded, overflow) by ray."""
    top = top_level(scene)
    n = origin.x.shape[0]
    with span("instances.cull"):
        pairs = _pairs(scene, top, origin, direction, lim, time)
    if pairs is None:
        z = torch.zeros(n, dtype=torch.bool, device=origin.x.device)
        return z, z
    pair_lim = lim.index_select(0, pairs.ray)
    occ, ovf = _by_mesh(scene, top, pairs, _cs_occluded, mode, pair_lim)
    if mode in _TRUNCATING:  # as in _closest_instances: the loop's limit is 0 after an occluding instance
        with span("instances.fold"):
            looped = _loop_caps(top, n, pairs, torch.where(occ, 0.0, float("inf")), pair_lim)
        ovf = _by_mesh(scene, top, pairs, _cs_occluded, mode, looped)[1]
    with span("instances.fold"):
        per_ray = torch.zeros((2, n), dtype=torch.int32, device=occ.device).index_add_(
            1, pairs.ray, torch.stack([occ, ovf]).to(torch.int32)) > 0
    return per_ray[0], per_ray[1]
