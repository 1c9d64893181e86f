"""Vertex Connection and Merging: bidirectional path tracing plus
progressive photon merging, SmallVCM-style (port of
``raytracer_tpu/integrators/vcm.py``).

Every pass traces one light sub-path and one camera sub-path per pixel.
The light vertices are stored (stacked per-depth tensors) and used three
ways:

1. connected to the camera (light-tracing splats),
2. connected to the camera-path vertices of the same pixel (vertex
   connection),
3. inserted as photons into a hash grid and merged into camera vertices
   within the merging radius (vertex merging).

All estimators are combined with the recursive dVC / dVM / dVCM MIS
quantities (balance heuristic, ``Mis(x) = x``).  Both sub-paths shade with
the scene's decals.

Departures that change no result: shadow queries whose answer no lane uses
(a connection masked by its length, cosines or BSDF) go with limit 0, which
every engine answers without work; the vertex connection (D x N lanes) and
the merge (N x K lanes) are evaluated in blocks of pixels of at most
``BLOCK_LANES`` lanes, each pixel's sums over D and K taken whole inside its
block, so that a 512^2 pass does not hold every intermediate of 16.8M
lanes at once.  ``rows`` / ``row0`` keep path ids global, so a band of
pixel rows traces the same paths as the whole frame.  In band mode over a
``torch.distributed`` group (``axis_name``, ``parallel/mesh.py::
render_pass_vcm_sharded``) the splat frame is summed over the group and
each rank keeps its band, and the photons of every rank are gathered in
rank order before the grid build, as the reference's ``psum`` and tiled
``all_gather`` do.  Every band has the same D x N photon slots, invalid
ones parked, so the gather moves equal-sized tensors; the photon order,
which decides the ``max_photons_per_cell`` a grid cell keeps, is the
reference's sharded order, not the one-device order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..math import sampling
from ..math.sampling import local_to_world, world_to_local
from ..math.vec import Vec3, dot, max_component, sqrt_rn, where as vwhere
from ..ops import bsdf as bsdf_ops
from ..ops.bsdf import MatParams
from ..ops.hashgrid import build_hash_grid, gather_candidates
from ..ops.intersect import BIG
from ..ops.lights import env_direction_pdf, gather_light, illuminate
from ..ops.materials import apply_normal_map, resolve_material
from ..ops.traverse import scene_hit_frame, scene_occluded, scene_traverse
from ..parallel.mesh import all_gather_cat, all_reduce_sum
from ..render.film import accumulate_frame, make_film
from ..sampler.sampler import SampleStream, make_stream, next_3d
from ..scene.camera import camera_pdf_w, generate_rays, world_to_film
from ..scene.types import LIGHT_BACKGROUND, Camera, SceneData, SceneMeta
from .light_tracer import EMIT_OFFSET, SplatBatch, emit_paths, splat_to_film, stack_splats
from .path_tracer import RAY_OFFSET, SHADOW_OFFSET, _env_radiance

# lanes of one block of the vertex connection or the merge
BLOCK_LANES = 1 << 22
PARK = 3.0e18  # invalid photons are parked this far out, where no query finds them


def _mis(x):
    """Balance-heuristic power (``Mis(x) = x``)."""
    return x


@dataclass(frozen=True)
class VcmParams:
    """The integrator's knobs."""

    max_path_length: int = 8
    initial_radius: float = 0.05
    min_radius: float = 0.02
    radius_multiplier: float = 1.0  # the reference's default (no shrink)
    use_vertex_connection: bool = True
    use_vertex_merging: bool = True
    max_photons_per_cell: int = 8


class _Vertex(NamedTuple):
    """Stored light vertices as stacked tensors."""

    position: Vec3
    normal: Vec3
    tangent: Vec3
    bitangent: Vec3
    wo_world: Vec3  # direction toward the previous vertex (outgoing)
    throughput: Vec3
    mat: MatParams
    d_vc: torch.Tensor
    d_vm: torch.Tensor
    d_vcm: torch.Tensor
    path_length: torch.Tensor  # int32
    valid: torch.Tensor  # bool


class _PathState(NamedTuple):
    origin: Vec3
    direction: Vec3
    throughput: Vec3
    d_vc: torch.Tensor
    d_vm: torch.Tensor
    d_vcm: torch.Tensor
    length: torch.Tensor
    alive: torch.Tensor
    last_specular: torch.Tensor
    is_finite_light: torch.Tensor
    stream: SampleStream


class _Photons(NamedTuple):
    """Photon fields for the grid build and the merge."""

    pos: Vec3
    wo: Vec3
    thr: Vec3
    d_vm: torch.Tensor
    d_vcm: torch.Tensor


def _map(fn, x):
    """``fn`` on every tensor of a tree of NamedTuples (Vec3, MatParams, ...)."""
    if torch.is_tensor(x):
        return fn(x)
    return type(x)(*(_map(fn, y) for y in x))


def _stack(items):
    """A list of same-shaped trees stacked leaf by leaf along a new axis 0."""
    if torch.is_tensor(items[0]):
        return torch.stack(items)
    return type(items[0])(*(_stack([it[i] for it in items]) for i in range(len(items[0]))))


def _shade_frame(scene, hits, origin, direction):
    return apply_normal_map(scene, scene_hit_frame(scene, hits, origin, direction))


def _advance(state: _PathState, d_vc, d_vm, d_vcm, frame, mp, wo_local, hits_surface, length_ok, stream,
             mis_vc_factor, mis_vm_factor):
    """Sample the BSDF, update the MIS quantities (``d_vc``, ``d_vm``,
    ``d_vcm``: the values at this hit) and continue the lanes that survive;
    the others keep ``state``'s (the camera's and the light's sub-paths
    alike)."""
    s1, s2, s3, stream = next_3d(stream)
    smp = bsdf_ops.sample(mp, wo_local, s1, s2, s3)
    wi_world = local_to_world(smp.wi, frame.tangent, frame.bitangent, frame.normal)
    cos_out = torch.abs(dot(wi_world, frame.normal))
    _f, _p, rev_pdf = bsdf_ops.evaluate_with_rev(mp, wo_local, smp.wi)
    survive = hits_surface & smp.valid & length_ok
    new_throughput = state.throughput * smp.weight
    survive = survive & (max_component(new_throughput) > 1e-9)

    inv_pdf = 1.0 / torch.clamp_min(smp.pdf, 1e-6)
    spec = smp.specular
    nd_vc = torch.where(spec, d_vc * _mis(cos_out),
                        _mis(cos_out * inv_pdf) * (d_vc * _mis(rev_pdf) + d_vcm + mis_vm_factor))
    nd_vm = torch.where(spec, d_vm * _mis(cos_out),
                        _mis(cos_out * inv_pdf) * (d_vm * _mis(rev_pdf) + d_vcm * mis_vc_factor + 1.0))
    nd_vcm = torch.where(spec, 0.0, _mis(inv_pdf))
    return _PathState(
        origin=vwhere(survive, frame.position + wi_world * RAY_OFFSET, state.origin),
        direction=vwhere(survive, wi_world, state.direction),
        throughput=vwhere(survive, new_throughput, state.throughput),
        d_vc=torch.where(survive, nd_vc, state.d_vc),
        d_vm=torch.where(survive, nd_vm, state.d_vm),
        d_vcm=torch.where(survive, nd_vcm, state.d_vcm),
        length=state.length + survive.to(torch.int32),
        alive=survive,
        last_specular=spec,
        is_finite_light=state.is_finite_light,
        stream=stream,
    )


def _trace_light_phase(scene: SceneData, meta: SceneMeta, cam: Camera, stream: SampleStream, vcm: VcmParams,
                       n_paths: int, mis_vc_factor, mis_vm_factor):
    """Light sub-paths: store the vertices (photons) and the camera splats.
    Returns (vertices stacked (D, N), splats stacked (D, N), stream)."""
    dev = stream.pixel_hash.device
    l, em, pick_prob, stream = emit_paths(scene, meta, stream)
    direct_pdf_a = em.direct_pdf_a * pick_prob
    emission_pdf = em.emission_pdf_w * pick_prob
    inv_emission = 1.0 / emission_pdf
    throughput = em.radiance * inv_emission
    alive = max_component(throughput) > 1e-9
    if meta.n_lights == 0:
        alive = torch.zeros_like(alive)

    # MIS init of a light sub-path
    d_vcm = _mis(direct_pdf_a * inv_emission)
    cos_at = torch.where(l.is_finite, em.cos_at_light, 1.0)
    d_vc = torch.where(l.is_delta, 0.0, _mis(cos_at * inv_emission))
    d_vm = d_vc * mis_vc_factor

    state = _PathState(
        origin=em.position + em.direction * EMIT_OFFSET, direction=em.direction, throughput=throughput,
        d_vc=d_vc, d_vm=d_vm, d_vcm=d_vcm,
        length=torch.ones(n_paths, dtype=torch.int32, device=dev),
        alive=alive,
        last_specular=torch.zeros(n_paths, dtype=torch.bool, device=dev),
        is_finite_light=l.is_finite,
        stream=stream,
    )
    vertices, splats = [], []
    for _ in range(vcm.max_path_length):
        hits = scene_traverse(scene, state.origin, state.direction)
        miss = hits.t >= BIG * 0.5
        hits = hits._replace(t=torch.clamp(hits.t, 0.0, 1e12))
        frame = _shade_frame(scene, hits, state.origin, state.direction)
        hit_surface = state.alive & (~miss) & (frame.light_id < 0)
        mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v, position=frame.position)

        # MIS update at the hit
        cos_in = torch.abs(dot(state.direction, frame.normal))
        inv_cos = 1.0 / _mis(torch.clamp_min(cos_in, 1e-6))
        dist_factor = torch.where((state.length > 1) | state.is_finite_light, _mis(hits.t * hits.t), 1.0)
        d_vcm = state.d_vcm * dist_factor * inv_cos
        d_vc = state.d_vc * inv_cos
        d_vm = state.d_vm * inv_cos

        # every hit is stored; connections mask themselves by f != 0
        wo_world = -state.direction
        vertices.append(_Vertex(
            position=frame.position, normal=frame.normal, tangent=frame.tangent, bitangent=frame.bitangent,
            wo_world=wo_world, throughput=state.throughput, mat=mp, d_vc=d_vc, d_vm=d_vm, d_vcm=d_vcm,
            path_length=state.length, valid=hit_surface,
        ))

        # camera splat
        to_cam = cam.origin - frame.position
        d2 = dot(to_cam, to_cam)
        dist = sqrt_rn(torch.clamp_min(d2, 1e-12))
        dir_to_cam = to_cam * (1.0 / dist)
        wo_local = world_to_local(wo_world, frame.tangent, frame.bitangent, frame.normal)
        wi_local = world_to_local(dir_to_cam, frame.tangent, frame.bitangent, frame.normal)
        f_cam, _pdf_fwd, pdf_rev = bsdf_ops.evaluate_with_rev(mp, wo_local, wi_local)
        fu, fv, on_film = world_to_film(cam, frame.position)
        cos_to_cam = dot(dir_to_cam, frame.normal)
        wanted = (hit_surface & on_film & (cos_to_cam > 1e-6) & (max_component(f_cam) > 0.0)
                  & vcm.use_vertex_connection)
        visible = ~scene_occluded(scene, frame.position + frame.normal * SHADOW_OFFSET, dir_to_cam,
                                  torch.where(wanted, dist * 0.999, 0.0))[0]
        cam_pdf_a = camera_pdf_w(cam, -dir_to_cam) * torch.clamp_min(cos_to_cam, 0.0) / torch.clamp_min(d2, 1e-12)
        # the reference's count factors: no n here and none in the camera's
        # dVCM init (its film normalization carries the full-film camera pdf)
        w_light = _mis(cam_pdf_a) * (mis_vm_factor + d_vcm + d_vc * _mis(pdf_rev))
        mis_w = 1.0 / (w_light + 1.0)
        contrib = f_cam * state.throughput * (mis_w * cam_pdf_a / torch.clamp_min(cos_to_cam, 1e-6))
        splats.append(SplatBatch(u=fu, v=fv, color=contrib, mask=wanted & visible))

        state = _advance(state, d_vc, d_vm, d_vcm, frame, mp, wo_local, hit_surface,
                         state.length + 2 <= vcm.max_path_length + 1, state.stream, mis_vc_factor, mis_vm_factor)
    return _stack(vertices), stack_splats(splats), state.stream


def _blocks(n: int, lanes_per_pixel: int):
    """Slices of pixels with at most BLOCK_LANES lanes each."""
    step = max(1, BLOCK_LANES // lanes_per_pixel)
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


def _connect_vertices(scene, vertices: _Vertex, frame, wo_local, mp, d_vc, d_vcm, length, can_connect,
                      mis_vm_factor, vcm: VcmParams, sl: slice) -> Vec3:
    """Vertex connection of the camera vertices of the pixels ``sl`` to the
    D light vertices of the same pixels: one any-hit query and two BSDF
    evaluations over (D, n) lanes, summed over D per pixel."""
    D = vcm.max_path_length
    lv = _map(lambda x: x[:, sl].reshape(-1), vertices)  # (D * n,)
    tile = lambda x: x[sl].expand(D, *x[sl].shape).reshape(-1)
    c_pos, c_nrm, c_tan, c_bit = (_map(tile, v) for v in (frame.position, frame.normal, frame.tangent,
                                                          frame.bitangent))
    c_wo_local, c_mp = _map(tile, wo_local), _map(tile, mp)
    c_dvc, c_dvcm, c_len, c_can = tile(d_vc), tile(d_vcm), tile(length), tile(can_connect)

    length_ok = lv.path_length + c_len + 1 <= vcm.max_path_length
    to_lv = lv.position - c_pos
    d2v = dot(to_lv, to_lv)
    distv = sqrt_rn(torch.clamp_min(d2v, 1e-12))
    ldir = to_lv * (1.0 / distv)
    cos_cam_v = dot(c_nrm, ldir)
    cos_light_v = dot(lv.normal, -ldir)
    wi_local_c = world_to_local(ldir, c_tan, c_bit, c_nrm)
    f_cam, cam_pdf_f, cam_pdf_r = bsdf_ops.evaluate_with_rev(c_mp, c_wo_local, wi_local_c)
    lwo_local = world_to_local(lv.wo_world, lv.tangent, lv.bitangent, lv.normal)
    lwi_local = world_to_local(-ldir, lv.tangent, lv.bitangent, lv.normal)
    f_light, light_pdf_f, light_pdf_r = bsdf_ops.evaluate_with_rev(lv.mat, lwo_local, lwi_local)
    geom = 1.0 / torch.clamp_min(d2v, 1e-12)
    wanted = (c_can & lv.valid & length_ok & (cos_cam_v > 1e-6) & (cos_light_v > 1e-6)
              & (max_component(f_cam) > 0.0) & (max_component(f_light) > 0.0))
    occluded = scene_occluded(scene, c_pos + ldir * SHADOW_OFFSET, ldir, torch.where(wanted, distv * 0.999, 0.0))[0]
    cam_pdf_a = cam_pdf_f * torch.clamp_min(cos_light_v, 1e-6) / torch.clamp_min(d2v, 1e-12)
    light_pdf_a = light_pdf_f * torch.clamp_min(cos_cam_v, 1e-6) / torch.clamp_min(d2v, 1e-12)
    w_light = _mis(cam_pdf_a) * (mis_vm_factor + lv.d_vcm + lv.d_vc * _mis(light_pdf_r))
    w_cam = _mis(light_pdf_a) * (mis_vm_factor + c_dvcm + c_dvc * _mis(cam_pdf_r))
    mis_w3 = 1.0 / (w_light + 1.0 + w_cam)
    ok = wanted & (~occluded)
    contrib = lv.throughput * f_cam * f_light * (geom * mis_w3 * ok.to(torch.float32))
    return Vec3(*(c.reshape(D, -1).sum(0) for c in contrib))


def _merge_vertices(photons: _Photons, cand_idx, cand_mask, frame, wo_local, mp, d_vm, d_vcm, can_connect,
                    r_vm, mis_vc_factor, sl: slice) -> Vec3:
    """Vertex merging at the camera vertices of the pixels ``sl``: the K
    candidate photons of each, radius-tested, one BSDF evaluation over
    (n, K) lanes, summed over K per pixel."""
    K = cand_idx.shape[-1]
    ci = cand_idx[sl].reshape(-1)
    ph_pos, ph_dir, ph_thr = (_map(lambda x: x[ci], v) for v in (photons.pos, photons.wo, photons.thr))
    ph_dvm, ph_dvcm = photons.d_vm[ci], photons.d_vcm[ci]
    rep = lambda x: torch.repeat_interleave(x[sl], K)  # (n,) -> (n * K,), each K times
    q_pos, q_nrm, q_tan, q_bit = (_map(rep, v) for v in (frame.position, frame.normal, frame.tangent,
                                                         frame.bitangent))
    q_wo, q_mp = _map(rep, wo_local), _map(rep, mp)
    q_dvcm, q_dvm = rep(d_vcm), rep(d_vm)

    dpx = ph_pos.x - q_pos.x
    dpy = ph_pos.y - q_pos.y
    dpz = ph_pos.z - q_pos.z
    within = (dpx * dpx + dpy * dpy + dpz * dpz) <= r_vm * r_vm
    cos_to_light = dot(q_nrm, ph_dir)
    wi_l = world_to_local(ph_dir, q_tan, q_bit, q_nrm)
    f, pdf_f, pdf_r = bsdf_ops.evaluate_with_rev(q_mp, q_wo, wi_l)
    w_light = ph_dvcm * mis_vc_factor + ph_dvm * _mis(pdf_f)
    w_cam = q_dvcm * mis_vc_factor + q_dvm * _mis(pdf_r)
    mw = 1.0 / (w_light + 1.0 + w_cam)
    weight = mw / torch.clamp_min(cos_to_light, 1e-6)
    ok = cand_mask[sl].reshape(-1) & within & (cos_to_light > 1e-6) & rep(can_connect)
    contrib = f * ph_thr * (weight * ok.to(torch.float32))
    return Vec3(*(c.reshape(-1, K).sum(-1) for c in contrib))


@torch.no_grad()
def render_pass_vcm(scene: SceneData, meta: SceneMeta, cam: Camera, film, pass_idx: int, halton, vp, params,
                    vcm: VcmParams = VcmParams(), rows: int | None = None, row0: int = 0,
                    axis_name=None):
    """One full VCM pass: light phase, photon grid, camera phase.  Returns
    the film.  ``rows`` / ``row0`` trace the band of pixel rows
    [row0, row0 + rows) with global path ids; ``params`` (RenderParams) is
    not read.  ``axis_name``: a ``torch.distributed`` process group over
    the bands (``film`` is then this rank's band), in place of the
    reference's mesh axis name."""
    from ..render.renderer import pixel_grid

    dev = film.sum.device
    w, h = vp.width, vp.height
    rows_ = h if rows is None else rows
    n = w * rows_  # paths of this band
    n_total = w * h  # the global light-path count (normalizations use it)
    light_pick = 1.0 / max(meta.n_lights, 1)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)

    # merging radii and the eta factors, in float32 as the reference; VM is
    # held back one pass (its radius trails the connection's by a pass)
    p = f32(pass_idx)
    r_vc = torch.clamp_min(vcm.initial_radius * vcm.radius_multiplier ** p, vcm.min_radius)
    r_vm = torch.clamp_min(vcm.initial_radius * vcm.radius_multiplier ** torch.clamp_min(p - 1, 0.0), vcm.min_radius)
    vm_norm = 1.0 / (math.pi * r_vm * r_vm * n_total)
    eta_vcm_vc = math.pi * r_vc * r_vc * n_total
    if vcm.use_vertex_merging:
        mis_vm_factor_vc = _mis(eta_vcm_vc) if pass_idx > 0 else f32(0.0)
    else:
        mis_vm_factor_vc = f32(0.0)
    mis_vc_factor_vc = _mis(1.0 / eta_vcm_vc) if vcm.use_vertex_connection else 0.0
    eta_vcm_vm = math.pi * r_vm * r_vm * n_total
    mis_vc_factor_vm = _mis(1.0 / eta_vcm_vm) if vcm.use_vertex_connection else 0.0

    # ---------------- light phase ----------------
    # global path ids: any row partitioning gives the same streams
    path_ids = torch.arange(n, dtype=torch.int64, device=dev) + row0 * w
    lstream = make_stream(path_ids, pass_idx, seed=vp.seed + 0x5EC, halton=None)
    vertices, splats, _ = _trace_light_phase(scene, meta, cam, lstream, vcm, n, mis_vc_factor_vc, mis_vm_factor_vc)
    if axis_name is None:
        film = splat_to_film(film, splats, w, h)
    else:
        # splats land on any pixel: a whole frame, summed over the group,
        # of which this rank keeps its band
        frame = all_reduce_sum(splat_to_film(make_film(w, h, dev), splats, w, h).sum, axis_name)
        film = film._replace(sum=film.sum + frame[row0:row0 + rows_])

    # the photon array: every vertex, flattened (D*N,), invalid ones parked
    flat = lambda x: x.reshape(-1)
    photon_valid = flat(vertices.valid)
    photons = _Photons(
        pos=Vec3(*(torch.where(photon_valid, flat(c), PARK) for c in vertices.position)),
        wo=_map(flat, vertices.wo_world),
        thr=_map(flat, vertices.throughput),
        d_vm=flat(vertices.d_vm),
        d_vcm=flat(vertices.d_vcm),
    )
    if axis_name is not None:
        # every rank's photons, in rank order, before the grid build
        photons = _map(lambda x: all_gather_cat(x, axis_name), photons)
    grid = build_hash_grid(photons.pos, r_vm)

    # ---------------- camera phase ----------------
    cx, cy, pids = pixel_grid(w, h, rows, row0, device=dev)
    cstream = make_stream(pids.to(torch.int64), pass_idx, seed=vp.seed, halton=halton)
    rays, cstream = generate_rays(cam, cx, cy, cstream)
    cam_pdf = camera_pdf_w(cam, rays.dir)
    state = _PathState(
        origin=rays.origin, direction=rays.dir, throughput=Vec3.ones((n,), dev),
        d_vc=torch.zeros(n, device=dev), d_vm=torch.zeros(n, device=dev),
        d_vcm=_mis(1.0 / torch.clamp_min(cam_pdf, 1e-12)),
        length=torch.ones(n, dtype=torch.int32, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        last_specular=torch.ones(n, dtype=torch.bool, device=dev),
        is_finite_light=torch.zeros(n, dtype=torch.bool, device=dev),
        stream=cstream,
    )
    vm_only = vcm.use_vertex_merging and not vcm.use_vertex_connection
    per_depth = []
    for _ in range(vcm.max_path_length):
        result = Vec3.zeros((n,), dev)
        hits = scene_traverse(scene, state.origin, state.direction)
        miss = hits.t >= BIG * 0.5
        hits = hits._replace(t=torch.clamp(hits.t, 0.0, 1e12))
        frame = _shade_frame(scene, hits, state.origin, state.direction)
        mp = resolve_material(scene, frame.material_id, frame.tex_u, frame.tex_v, position=frame.position)

        # MIS update at the hit
        cos_in = torch.abs(dot(state.direction, frame.normal))
        inv_cos = 1.0 / _mis(torch.clamp_min(cos_in, 1e-6))
        d_vcm = state.d_vcm * _mis(hits.t * hits.t) * inv_cos
        d_vc = state.d_vc * inv_cos
        d_vm = state.d_vm * inv_cos

        # background on a miss
        bg_total = Vec3.zeros((n,), dev)
        for li, kind in enumerate(meta.light_kinds):
            if kind != LIGHT_BACKGROUND:
                continue
            radiance = _env_radiance(scene, li, state.direction)
            # the direct pdf NEE samples with: the env importance map when
            # there is one, else the uniform hemisphere
            if scene.env_dist is not None:
                direct_pdf_a = env_direction_pdf(scene.env_dist, state.direction)
            else:
                direct_pdf_a = 1.0 / (2.0 * math.pi)
            emission_pdf_w = sampling.uniform_sphere_pdf() * sampling.uniform_circle_pdf(meta.scene_radius)
            w_camera = (_mis(direct_pdf_a * light_pick) * state.d_vcm
                        + _mis(emission_pdf_w * light_pick) * state.d_vc)
            if vm_only:
                mis_w = torch.where(state.length > 1, torch.where(state.last_specular, 1.0, 0.0), 1.0)
            else:
                mis_w = torch.where(state.length > 1, 1.0 / (1.0 + w_camera), 1.0)
            bg_total = bg_total + radiance * mis_w
        result = result + state.throughput * bg_total * (state.alive & miss).to(torch.float32)

        # a light hit directly
        hit_light = state.alive & (~miss) & (frame.light_id >= 0)
        l_hit = gather_light(scene.lights, torch.clamp_min(frame.light_id, 0))
        cos_at_light = dot(frame.normal, -state.direction)
        inv_area = 1.0 / torch.clamp_min(l_hit.area, 1e-8)
        direct_pdf_a = inv_area
        emission_pdf_w = inv_area * torch.clamp_min(cos_at_light, 1e-6) / math.pi
        w_camera = _mis(direct_pdf_a * light_pick) * d_vcm + _mis(emission_pdf_w * light_pick) * d_vc
        if vm_only:
            # pure photon mapping: non-specular light hits come through merging
            mis_w = torch.where(state.length > 1, torch.where(state.last_specular, 1.0, 0.0), 1.0)
        else:
            mis_w = torch.where(state.length > 1, 1.0 / (1.0 + w_camera), 1.0)
        m_light = (hit_light & (cos_at_light > 1e-6)).to(torch.float32)
        result = result + state.throughput * l_hit.color * (mis_w * m_light)

        hit_surface = state.alive & (~miss) & (frame.light_id < 0)
        result = result + state.throughput * mp.emission * hit_surface.to(torch.float32)

        wo_local = world_to_local(-state.direction, frame.tangent, frame.bitangent, frame.normal)
        stream = state.stream
        can_connect = hit_surface & (state.length + 1 <= vcm.max_path_length)

        # NEE: vertex connection to each light
        if vcm.use_vertex_connection and meta.n_lights > 0:
            nee_total = Vec3.zeros((n,), dev)
            for li in range(meta.n_lights):
                l = gather_light(scene.lights, torch.full((n,), li, dtype=torch.int32, device=dev))
                u1, u2, u3, stream = next_3d(stream)
                ill = illuminate(l, frame.position, frame.normal, u1, u2, u3, env=scene.env_dist,
                                 scene_radius=meta.scene_radius)
                wi_local = world_to_local(ill.dir_to_light, frame.tangent, frame.bitangent, frame.normal)
                f, pdf_fwd, pdf_rev = bsdf_ops.evaluate_with_rev(mp, wo_local, wi_local)
                cos_to_light = dot(frame.normal, ill.dir_to_light)
                wanted = can_connect & ill.valid & (cos_to_light > 1e-6) & (max_component(f) > 0.0)
                occluded = scene_occluded(scene, frame.position + ill.dir_to_light * SHADOW_OFFSET,
                                          ill.dir_to_light,
                                          torch.where(wanted, torch.clamp_max(ill.distance * 0.999, BIG), 0.0))[0]
                bsdf_pdf = torch.where(l.is_delta, 0.0, pdf_fwd)
                w_light = _mis(bsdf_pdf / torch.clamp_min(ill.direct_pdf_w, 1e-12))
                w_cam = _mis(
                    ill.emission_pdf_w * torch.clamp_min(cos_to_light, 1e-6)
                    / torch.clamp_min(ill.direct_pdf_w * torch.clamp_min(ill.cos_at_light, 1e-6), 1e-12)
                ) * (mis_vm_factor_vc + d_vcm + d_vc * _mis(pdf_rev))
                mis_w2 = 1.0 / (w_light + 1.0 + w_cam)
                ok = wanted & (~occluded)
                nee_total = nee_total + ill.radiance * f * (
                    mis_w2 / torch.clamp_min(ill.direct_pdf_w, 1e-12) * ok.to(torch.float32))
            result = result + state.throughput * nee_total

        # vertex connection to the stored light vertices of the same pixel
        if vcm.use_vertex_connection:
            parts = [_connect_vertices(scene, vertices, frame, wo_local, mp, d_vc, d_vcm, state.length, can_connect,
                                       mis_vm_factor_vc, vcm, sl) for sl in _blocks(n, vcm.max_path_length)]
            vc_total = Vec3(*(torch.cat([pt[i] for pt in parts]) for i in range(3)))
            result = result + state.throughput * vc_total

        # vertex merging with the photons near the camera vertex
        if vcm.use_vertex_merging:
            cand_idx, cand_mask = gather_candidates(grid, frame.position, vcm.max_photons_per_cell)
            parts = [_merge_vertices(photons, cand_idx, cand_mask, frame, wo_local, mp, d_vm, d_vcm, can_connect, r_vm,
                                     mis_vc_factor_vm, sl) for sl in _blocks(n, cand_idx.shape[-1])]
            merged = Vec3(*(torch.cat([pt[i] for pt in parts]) for i in range(3)))
            do_vm = float(pass_idx > 0)
            result = result + state.throughput * merged * (vm_norm * do_vm)

        per_depth.append(result)
        state = _advance(state, d_vc, d_vm, d_vcm, frame, mp, wo_local, hit_surface,
                         state.length <= vcm.max_path_length, stream, mis_vc_factor_vc, mis_vm_factor_vc)

    radiance = Vec3(*(torch.stack([r[i] for r in per_depth]).sum(0) for i in range(3)))
    return accumulate_frame(film, radiance, use_secondary=(pass_idx % 2 == 0))
