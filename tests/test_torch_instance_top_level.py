"""The port's flat top level over instances (``ops/traverse.py``: one
padded world box an instance, the (ray, instance) pairs that meet them, one
engine query a shared mesh, the fold back to the rays) against the JAX
package's per-instance loop, which traces every instance of every ray.

Scenes built by both packages' SceneBuilders from the same inputs, clusters
at K = 8 (as tests/test_torch_instancing.py builds its scenes):

- ``moving``: the pyramid placed three times, two of the instances moving,
  beside a baked grid; rays at per-ray shutter times in [0, 1.5) (the
  port's shutter runs to ``motion_blur_strength``, which may pass 1);
- ``tied``: the pyramid placed three times, instances 0 and 2 at one pose,
  and the grid placed once: two shared meshes.

Held as tests/test_torch_instancing.py holds the loop: closest-hit lanes'
tri, instance and prim ids equal, t within 1e-5; fused any-hit lanes
shadowed where the JAX package's scene_occluded says so; occlusion and
overflow equal.  Also: rays that graze the instances' boxes, the tie rule,
the light behind an instance under wave2, the cull's conservativeness, one
engine query a shared mesh with pairs and none for a mesh without, and the
port against the benchmark's plain reference (``benchmark/reference/rt/
ops/instances.py``) on the benchmark's instanced layout at 16^2.
"""

import os
import sys
import time
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from tests.test_torch_instancing import K, N_RAYS, _grid, _pyramid, _queries, _ref_vec, _vec
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.ops import traverse as ref_traverse
from raytracer_tpu.scene import build as ref_build
from raytracer_tpu.scene import clusters as ref_clusters
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.scene import build
from raytracer_tpu_torch.scene import clusters
from raytracer_tpu_torch.scene import types as T
from raytracer_tpu_torch.utils import profiler

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
POSES = [((-1.6, 0.0, 0.5), 30.0), ((1.4, 0.3, 1.0), -45.0), ((0.0, -0.4, 2.0), 120.0)]
VELOCITIES = [(0.0, 0.0, 0.0), (0.4, 0.0, -0.3), (0.0, 0.6, 0.2)]


def _materials(b, pkg_build, rigid):
    red = b.add_material(pkg_build.MaterialDesc(name="red", bsdf="diffuse", base_color=(0.7, 0.3, 0.2)))
    grey = b.add_material(pkg_build.MaterialDesc(name="grey", bsdf="roughPlastic", base_color=(0.6, 0.6, 0.65),
                                                 roughness=0.3))
    b.add_light(pkg_build.LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.7, 0.8, 0.9)))
    b.add_light(pkg_build.LightDesc(kind=T.LIGHT_DIRECTIONAL, color=(2.5, 2.4, 2.2),
                                    transform=rigid(euler_deg=(50.0, 20.0, 0.0))))
    return red, grey


def _moving(b, pkg_build, rigid):
    red, grey = _materials(b, pkg_build, rigid)
    gv, gf, gn, guv = _grid()
    b.add_mesh(gv, gf, gn, guv, np.full(len(gf), grey), transform=rigid(translation=(0.0, -0.6, 1.0)))
    pv, pf, pn, _ = _pyramid()
    mid = b.add_mesh_geometry(pv, pf, pn, None, np.full(len(pf), red))
    for (t, yaw), vel in zip(POSES, VELOCITIES):
        b.add_mesh_instance(mid, rigid(translation=t, euler_deg=(0, yaw, 0)), velocity=vel)


def _tied(b, pkg_build, rigid):
    red, grey = _materials(b, pkg_build, rigid)
    pv, pf, pn, _ = _pyramid()
    pyr = b.add_mesh_geometry(pv, pf, pn, None, np.full(len(pf), red))
    gv, gf, gn, guv = _grid()
    grid = b.add_mesh_geometry(gv, gf, gn, guv, np.full(len(gf), grey))
    for t, yaw in (POSES[0], POSES[1], POSES[0]):  # instances 0 and 2 at one pose
        b.add_mesh_instance(pyr, rigid(translation=t, euler_deg=(0, yaw, 0)))
    b.add_mesh_instance(grid, rigid(translation=(0.0, -1.5, 30.0), euler_deg=(-60.0, 0.0, 0.0)))
    b.add_sphere(rigid(translation=(2.2, 0.4, -0.5)), 0.5, grey)


def _build(fill):
    """(JAX scene, port scene), both at K = 8."""
    with mock.patch.object(ref_clusters, "build_clusters", partial(ref_clusters.build_clusters, k=K)), \
            mock.patch.object(clusters, "build_clusters", partial(clusters.build_clusters, k=K)):
        rb = ref_build.SceneBuilder()
        fill(rb, ref_build, RefRigidTransform)
        pb = build.SceneBuilder()
        fill(pb, build, RigidTransform)
        return rb.build()[0], pb.build("cpu")[0]


@pytest.fixture(scope="module")
def scenes():
    return {"moving": _build(_moving), "tied": _build(_tied)}


@pytest.fixture
def modes(monkeypatch):
    """Set both packages' mode; both back to 'auto' afterwards (the JAX
    package reads its mode while it traces, so its compiled functions are
    dropped too)."""
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)

    def use(mode):
        traverse.set_traversal_mode(mode)
        ref_traverse.set_traversal_mode(mode)

    yield use
    traverse.set_traversal_mode("auto")
    ref_traverse.set_traversal_mode("auto")
    jax.clear_caches()


def _held_as_the_loop(scene, ref_scene, o, d, any_hit, t_max, limit, time=None):
    """The port's scene_traverse (closest-hit and fused any-hit lanes) and
    scene_occluded against the JAX package's, as
    tests/test_torch_instancing.py holds them.  Returns the port's hits."""
    rt = None if time is None else jnp.asarray(time)
    pt = None if time is None else torch.as_tensor(time)
    got = traverse.scene_traverse(scene, _vec(o), _vec(d), torch.as_tensor(t_max), time=pt,
                                  any_hit=torch.as_tensor(any_hit))
    ref = ref_traverse.scene_traverse(ref_scene, _ref_vec(o), _ref_vec(d), jnp.asarray(t_max), time=rt,
                                      any_hit=jnp.asarray(any_hit))
    occ, ovf = traverse.scene_occluded(scene, _vec(o), _vec(d), torch.as_tensor(limit), time=pt)
    ref_occ, ref_ovf = ref_traverse.scene_occluded(ref_scene, _ref_vec(o), _ref_vec(d), jnp.asarray(limit), time=rt)
    ref_shadow = np.asarray(ref_traverse.scene_occluded(ref_scene, _ref_vec(o), _ref_vec(d), jnp.asarray(t_max),
                                                        time=rt)[0])
    lanes = ~any_hit
    for field in ("tri_id", "inst_id", "prim_id"):
        assert np.array_equal(getattr(got, field).numpy()[lanes], np.asarray(getattr(ref, field))[lanes]), field
    np.testing.assert_allclose(got.t.numpy()[lanes], np.asarray(ref.t)[lanes], rtol=1e-5, atol=1e-5)
    shadowed = (got.t.numpy() < t_max) & ((got.tri_id.numpy() >= 0) | (got.prim_id.numpy() >= 0))
    assert np.array_equal(shadowed[any_hit], ref_shadow[any_hit])
    assert np.array_equal(occ.numpy(), np.asarray(ref_occ))
    assert np.array_equal(ovf.numpy(), np.asarray(ref_ovf))
    assert np.array_equal(got.overflow.numpy()[lanes], np.asarray(ref.overflow)[lanes])
    return got, occ


@pytest.mark.parametrize("mode", ["cluster", "wave2"])
def test_moving_instances_at_per_ray_shutter_times(scenes, modes, mode):
    """Two of three instances move; each ray meets them at its own shutter
    time, up to 1.5 (past the union of the boxes at 0 and 1)."""
    modes(mode)
    ref_scene, scene = scenes["moving"]
    o, d, any_hit, t_max, limit = _queries(seed=11)
    time = np.random.default_rng(12).uniform(0.0, 1.5, N_RAYS).astype(np.float32)
    got, occ = _held_as_the_loop(scene, ref_scene, o, d, any_hit, t_max, limit, time)
    inst = got.inst_id.numpy()
    assert ((inst == 1) | (inst == 2)).sum() > 20 and (inst == 0).sum() > 10  # the moving and the still
    assert 0.1 < occ.numpy().mean() < 0.9


def test_ties_go_to_the_lowest_instance_id(scenes, modes):
    """Instances 0 and 2 stand at one pose: every hit on them ties in t, and
    the fold gives instance 0, as the loop's strict ``<`` does."""
    modes("wave2")
    ref_scene, scene = scenes["tied"]
    o, d, any_hit, t_max, limit = _queries(seed=21)
    got, _ = _held_as_the_loop(scene, ref_scene, o, d, any_hit, t_max, limit)
    inst = got.inst_id.numpy()[~any_hit]
    assert (inst == 0).sum() > 20 and (inst == 1).sum() > 10 and (inst == 2).sum() == 0


def _grazing_rays(scene):
    """Rays from outside aimed at every world-space vertex of every
    instance (the extreme ones lie on its box), at each vertex and an ulp
    beside it: they graze the boxes' faces, edges and corners."""
    inst = scene.instances
    targets = []
    for i, mid in enumerate(inst.mesh_ids):
        tris = scene.mesh_geoms[mid].tris
        rot, trans = traverse._instance_rot(scene, i)
        for p in (tris.v0, tris.v0 + tris.e1, tris.v0 + tris.e2):
            w = rot.to_world(p) + trans
            targets.append(torch.stack(tuple(w), 1))
    tgt = torch.unique(torch.cat(targets), dim=0).numpy().astype(np.float64)
    tgt = np.concatenate([tgt, np.nextafter(tgt.astype(np.float32), np.float32(np.inf)).astype(np.float64)])
    origins = np.array([[0.0, 1.0, -7.0], [6.0, 0.05, 1.0], [-6.0, 3.0, 2.0], [0.5, 8.0, 0.8]])
    o = np.repeat(origins, len(tgt), 0)
    d = np.tile(tgt, (len(origins), 1)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _loop(scene, o: Vec3, d: Vec3):
    """Closest hit by the per-instance loop the top level replaced: the
    prims' and baked mesh's hit first, then each instance's query capped by
    the best t so far, a strictly nearer hit replacing the best.  Returns
    (t, prim id, tri id, instance id)."""
    base = traverse.scene_traverse(scene._replace(instances=None, mesh_geoms=()), o, d)
    t, prim, tri, inst = base.t, base.prim_id, base.tri_id, base.inst_id
    for i, mid in enumerate(scene.instances.mesh_ids):
        geom = scene.mesh_geoms[mid]
        lo, ld = traverse._instance_local_ray(scene, i, o, d)
        t_i, tid = traverse._cs_closest("wave2", geom.clusters, None, geom.tris, lo, ld, t)[:2]
        closer = (t_i < t) & (tid >= 0)
        t, prim = torch.where(closer, t_i, t), torch.where(closer, -1, prim)
        tri, inst = torch.where(closer, tid, tri), torch.where(closer, i, inst)
    return t, prim, tri, inst


def test_rays_grazing_the_boxes_keep_their_pairs(scenes, modes):
    """The cull is conservative: every (ray, instance) whose object-space
    query hits is kept, for rays that graze the boxes' faces, edges and
    corners; and the top level gives those rays the loop's hits, bit for
    bit.  (Against the JAX package these rays, aimed at vertices, part
    where its jitted Möller-Trumbore fuses multiply-adds.)"""
    modes("wave2")
    for name in ("moving", "tied"):
        _, scene = scenes[name]
        o, d = _grazing_rays(scene)
        top = traverse.top_level(scene)
        big = torch.full((o.shape[0],), 3.0e38)
        keep = traverse._cull(top, _vec(o), _vec(d), big, None)
        for row, i in enumerate(top.inst_of_row.tolist()):
            geom = scene.mesh_geoms[scene.instances.mesh_ids[i]]
            lo, ld = traverse._instance_local_ray(scene, i, _vec(o), _vec(d))
            hit = traverse._cs_closest("wave2", geom.clusters, None, geom.tris, lo, ld, big)[1] >= 0
            assert hit.sum() > 0 and bool(keep[row][hit].all()), (name, i)
        got = traverse.scene_traverse(scene, _vec(o), _vec(d))
        want = _loop(scene, _vec(o), _vec(d))
        assert (want[3] >= 0).sum() > len(o) // 4
        for field, w in zip(("t", "prim_id", "tri_id", "inst_id"), want):
            assert torch.equal(getattr(got, field), w), (name, field)


def test_a_shadow_ray_never_meets_an_instance_beyond_its_light(scenes, modes):
    """The port's departure from the JAX package (ROADMAP, "Decisions")
    under wave2, through the top level: a fused any-hit lane aimed at an
    instance is shadowed only when its limit lies past it."""
    modes("wave2")
    ref_scene, scene = scenes["tied"]
    n = 64
    rng = np.random.default_rng(9)
    target = np.array(POSES[1][0]) + np.array([0.0, 0.5, 0.0]) + rng.uniform(-0.1, 0.1, (n, 3))
    o = np.tile([[1.4, 0.8, -6.0]], (n, 1)) + rng.uniform(-0.2, 0.2, (n, 3))
    d = target - o
    dist = np.linalg.norm(d, axis=1)
    o, d = o.astype(np.float32), (d / dist[:, None]).astype(np.float32)
    for frac, want in ((0.3, False), (1.5, True)):
        t_max = (frac * dist).astype(np.float32)
        got = traverse.scene_traverse(scene, _vec(o), _vec(d), torch.as_tensor(t_max),
                                      any_hit=torch.ones(n, dtype=torch.bool))
        assert ((got.t.numpy() < t_max) == want).all(), frac
        assert ((got.inst_id.numpy() == 1) == want).all(), frac
        assert (traverse.scene_occluded(scene, _vec(o), _vec(d), torch.as_tensor(t_max))[0].numpy() == want).all()
        assert (np.asarray(ref_traverse.scene_occluded(ref_scene, _ref_vec(o), _ref_vec(d),
                                                       jnp.asarray(t_max))[0]) == want).all()


def _rays_at(points, origin):
    o = np.tile(np.asarray(origin, np.float32), (len(points), 1))
    d = np.asarray(points, np.float64) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_one_engine_query_per_shared_mesh_with_pairs(scenes, monkeypatch):
    """``instances.queries`` counts one engine call a shared mesh that has
    pairs, and the engine is never called for a mesh without: rays at the
    pyramids only query the pyramid's mesh, rays at both meshes query both,
    rays into the sky query none."""
    _, scene = scenes["tied"]
    pyramid, grid = (scene.mesh_geoms[m].clusters for m in (0, 1))
    seen = []
    real = traverse._cs_closest
    monkeypatch.setattr(traverse, "_cs_closest", lambda mode, cs, *a: (seen.append(cs), real(mode, cs, *a))[1])
    above = (0.0, 10.0, 0.8)  # rays down onto the pyramids, far from the grid's box
    at_pyramids = _rays_at([np.array(POSES[k][0]) + [0.0, 0.4, 0.0] for k in (0, 1)] * 8, above)
    at_grid = _rays_at([[0.0, -1.5, 30.0]] * 8, (0.0, 1.0, -7.0))
    at_both = tuple(np.concatenate(a) for a in zip(at_pyramids, at_grid))
    for (o, d), want in ((at_pyramids, [pyramid]), (at_both, [pyramid, grid]),
                         (_rays_at([[0.0, 50.0, 0.0]] * 8, above), [])):
        seen.clear()
        profiler.reset()
        with profiler.enable():
            traverse.scene_traverse(scene, _vec(o), _vec(d))
            c = profiler.counters()
        assert [cs is pyramid for cs in seen] == [cs is pyramid for cs in want], len(seen)
        assert c.get("instances.queries", 0) == len(want)
        assert c["instances.pairs_tested"] == len(o) * scene.instances.count
        assert (c["instances.pairs_sent"] > 0) == bool(want)
        assert profiler.syncs().get("instances.pair_counts") == 1
        names = {r.name for r in profiler.records()}
        assert {"instances.cull"} <= names and ("instances.fold" in names) == bool(want)
    profiler.reset()


@pytest.fixture(scope="module")
def bench_path():
    """The benchmark's folders on the import path, for its harness and
    reference."""
    added = [p for p in (BENCH, os.path.join(BENCH, "tests")) if p not in sys.path]
    sys.path[:0] = added
    yield
    for p in added:
        sys.path.remove(p)


def test_the_port_reads_the_benchmark_reference_on_the_instanced_layout(bench_path, tmp_path, monkeypatch):
    """``interior800k_inst_render``'s comparison at 16^2 in float32 on the
    CPU, on the instanced layout of ``benchmark/generators/hall_inst.py``
    (``write_small``: 18 instances of 3 meshes beside a baked shell): the
    port under its default mode against the reference's loop over
    instances in object space, bit for bit."""
    from conftest import tiny
    from harness import cells, runner, scenes as bench_scenes

    small = cells.load_module("generators", "hall_inst").write_small(str(tmp_path))
    monkeypatch.setattr(bench_scenes, "scene_path", lambda name, config, cache=None: small)
    got = runner.run(tiny(cells.find("interior800k_inst_render")), 2**31 + 2223, 0.5, False, "cpu",
                     time.perf_counter(), lambda m: None)
    assert got["correct"] is True and got["failed"] == 0
    assert got["checks"]["mismatch_share"]["value"] == 0.0 and got["checks"]["mean_gap"]["value"] == 0.0
