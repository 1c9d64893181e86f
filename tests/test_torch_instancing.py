"""Port parity: two-level instancing (shared object-space meshes placed by
rigid instances) of raytracer_tpu_torch against the JAX package.

Two scenes, each built by both packages' SceneBuilders from the same
inputs, with clusters at K = 8 (the JAX wave2 engine runs its Pallas kernel
in interpret mode on a CPU, which compiles in seconds at K = 8 and in
minutes at the default 64):

- ``pyramids``: the 4-triangle pyramid of tests/test_instancing.py placed
  three times, beside one baked 162-triangle grid: every instance's tri ids
  lie inside the baked table's range;
- ``grids``: the grid placed twice, beside one baked pyramid: instance tri
  ids run past the end of the baked table.  The JAX package gathers every
  table with every tri id and lets XLA clamp; the port masks each table's
  ids to its own lanes first.

Host tables are bit-equal.  Traversal (the same engine on both sides): tri
and instance ids equal, t within rtol 1e-5 + atol 1e-5 (tests/
test_torch_wave2.py's tolerance).  Shading frames of the same hits: within
1e-5.  The 24^2 render against the JAX package's ``wave`` engine (what JAX
resolves ``auto`` to on a CPU) is held as tests/test_torch_render.py holds
its renders.  One departure from the JAX package is deliberate (ROADMAP,
"Decisions"): a fused shadow lane caps its instance queries by its limit.
Its two tests pin it, at the traversal level and on a 16^2 render with an
instance behind a light.
"""

import json
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from tests.test_torch_scene import assert_same, to_port
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.io.scene_loader import load_scene as ref_load_scene
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import traverse as ref_traverse
from raytracer_tpu.ops.intersect import Hits as RefHits
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.scene import build as ref_build
from raytracer_tpu.scene import clusters as ref_clusters
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene import build
from raytracer_tpu_torch.scene import clusters
from raytracer_tpu_torch.scene import types as T
from raytracer_tpu_torch.scene.camera import make_camera

K = 8
N_RAYS = 1024
PLACES = [((-1.6, 0.0, 0.5), 30.0), ((1.4, 0.3, 1.0), -45.0), ((0.0, -0.4, 2.0), 120.0)]


def _pyramid():
    """The 4-face pyramid of tests/test_instancing.py (object space, apex +Y)."""
    v = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], [0, 1.5, 0]], np.float64)
    f = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], np.int64)
    n = np.zeros_like(v)
    for a, b, c in f:
        fn = np.cross(v[b] - v[a], v[c] - v[a])
        n[[a, b, c]] += fn
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return v, f, n, None


def _grid(side=10):
    """A bumpy (side-1)^2 * 2 = 162-triangle grid over [-4, 4]^2 with uvs."""
    u = np.linspace(-4.0, 4.0, side)
    x, z = np.meshgrid(u, u)
    y = 0.15 * np.sin(1.3 * x) * np.cos(0.9 * z)
    v = np.stack([x, y, z], -1).reshape(-1, 3)
    idx = np.arange(side * side).reshape(side, side)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    f = np.concatenate([np.stack([a, d, b], 1), np.stack([a, c, d], 1)])
    n = np.tile([[0.0, 1.0, 0.0]], (len(v), 1)) + 0.1 * np.stack([np.cos(x), np.zeros_like(x), np.sin(z)], -1).reshape(-1, 3)
    uv = np.stack([(x + 4) / 8, (z + 4) / 8], -1).reshape(-1, 2)
    return v, f, n, uv


def _fill(b, pkg_build, rigid, name):
    """Scene content in the builder of one package."""
    red = b.add_material(pkg_build.MaterialDesc(name="red", bsdf="diffuse", base_color=(0.7, 0.3, 0.2)))
    grey = b.add_material(pkg_build.MaterialDesc(name="grey", bsdf="roughPlastic", base_color=(0.6, 0.6, 0.65),
                                                 roughness=0.3))
    b.add_light(pkg_build.LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.7, 0.8, 0.9)))
    b.add_light(pkg_build.LightDesc(kind=T.LIGHT_DIRECTIONAL, color=(2.5, 2.4, 2.2),
                                    transform=rigid(euler_deg=(50.0, 20.0, 0.0))))
    pv, pf, pn, _ = _pyramid()
    gv, gf, gn, guv = _grid()
    if name == "pyramids":
        b.add_mesh(gv, gf, gn, guv, np.full(len(gf), grey), transform=rigid(translation=(0.0, -0.6, 1.0)))
        mid = b.add_mesh_geometry(pv, pf, pn, None, np.full(len(pf), red))
        for t, yaw in PLACES:
            b.add_mesh_instance(mid, rigid(translation=t, euler_deg=(0, yaw, 0)))
    else:
        b.add_mesh(pv, pf, pn, None, np.full(len(pf), red), transform=rigid(translation=(0.3, -0.2, 0.5),
                                                                           euler_deg=(0, 20, 0)))
        mid = b.add_mesh_geometry(gv, gf, gn, guv, np.full(len(gf), grey))
        b.add_mesh_instance(mid, rigid(translation=(0.0, -0.6, 1.0)))
        b.add_mesh_instance(mid, rigid(translation=(0.5, 1.5, 5.0), euler_deg=(-70.0, 15.0, 0.0)))
    b.add_sphere(rigid(translation=(2.2, 0.4, -0.5)), 0.5, grey)


def _scenes(name):
    """(JAX scene, meta), (port scene, meta), both built at K = 8."""
    with mock.patch.object(ref_clusters, "build_clusters", partial(ref_clusters.build_clusters, k=K)), \
            mock.patch.object(clusters, "build_clusters", partial(clusters.build_clusters, k=K)):
        rb = ref_build.SceneBuilder()
        _fill(rb, ref_build, RefRigidTransform, name)
        pb = build.SceneBuilder()
        _fill(pb, build, RigidTransform, name)
        return rb.build(), pb.build("cpu")


@pytest.fixture(scope="module")
def scenes():
    return {name: _scenes(name) for name in ("pyramids", "grids")}


@pytest.fixture
def restore_modes(monkeypatch):
    """Both packages back to 'auto' afterwards; the JAX package reads its
    mode while it traces, so its compiled functions are dropped too."""
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    yield
    traverse.set_traversal_mode("auto")
    ref_traverse.set_traversal_mode("auto")
    jax.clear_caches()


@pytest.mark.parametrize("name", ["pyramids", "grids"])
def test_builder_tables_bit_equal(scenes, name):
    """Every table of the two builders equal bit for bit: geometries'
    Triangles and ClusterSets, the instances' rot, trans, vel and mesh ids,
    the baked mesh's BVH, and the scene radius (which bounds instances)."""
    (ref_scene, ref_meta), (scene, meta) = scenes[name]
    carried = to_port(ref_scene)
    assert isinstance(carried.instances, T.Instances) and isinstance(carried.mesh_geoms[0], T.MeshGeom)
    assert_same(scene, carried)
    assert meta == to_port(ref_meta)
    assert scene.instances.count == len(ref_scene.instances.mesh_ids) and len(scene.mesh_geoms) == 1
    assert scene.bvh is not None and scene.mesh_geoms[0].clusters.tris_per_cluster == K


def test_instances_are_rigid():
    b = build.SceneBuilder()
    v, f, n, _ = _pyramid()
    mid = b.add_mesh_geometry(v, f, n, None, np.zeros(len(f)))
    with pytest.raises(ValueError, match="rigid"):
        b.add_mesh_instance(mid, RigidTransform(translation=(1.0, 0.0, 0.0), scale=2.0))
    assert b.add_mesh_instance(mid, RigidTransform(translation=(1.0, 0.0, 0.0)), velocity=(0.0, 1.0, 0.0)) == 0
    scene, _ = b.build("cpu")
    assert scene.tris is None and scene.bvh is None and scene.instances.vel.y.tolist() == [1.0]


def _write_obj(path, mtl, v, f, mats):
    """An OBJ whose faces alternate between the ``mats`` materials."""
    lines = [f"mtllib {mtl}"] + [f"v {x} {y} {z}" for x, y, z in v]
    for i, (a, b, c) in enumerate(f):
        if i % (len(f) // len(mats)) == 0:
            lines.append(f"usemtl {mats[(i * len(mats)) // len(f)]}")
        lines.append(f"f {a + 1} {b + 1} {c + 1}")
    path.write_text("\n".join(lines) + "\n")


def test_loader_turns_a_repeated_mesh_into_instances(tmp_path):
    """One OBJ placed twice (and once more at scale 2, which bakes) beside a
    second OBJ placed once: one geometry and two instances, the rest baked,
    and a material table equal row for row to the JAX loader's (each use
    registers the OBJ's materials again; the geometry keeps the ids of its
    first use)."""
    (tmp_path / "m.mtl").write_text("newmtl stone\nKd 0.5 0.5 0.4\nnewmtl gold\nKd 0.9 0.7 0.2\nKe 0.1 0 0\n")
    v, f, _, _ = _pyramid()
    _write_obj(tmp_path / "pyr.obj", "m.mtl", v, f, ["stone", "gold"])
    gv, gf, _, _ = _grid(6)
    _write_obj(tmp_path / "grid.obj", "m.mtl", gv, gf, ["gold"])
    doc = {
        "materials": [{"name": "blue", "baseColor": [0.1, 0.2, 0.8]}],
        "objects": [
            {"type": "mesh", "path": "pyr.obj", "transform": {"translation": [1, 0, 0]}},
            {"type": "mesh", "path": "grid.obj"},
            {"type": "sphere", "radius": 0.5, "material": "blue"},
            {"type": "mesh", "path": "pyr.obj", "transform": {"translation": [-1, 0, 2], "orientation": [0, 40, 0]}},
            {"type": "mesh", "path": "pyr.obj", "scale": 2.0},
        ],
        "lights": [{"type": "background", "color": [0.5, 0.5, 0.5]}],
    }
    (tmp_path / "s.json").write_text(json.dumps(doc))
    ref_scene, ref_meta, ref_cam = ref_load_scene(str(tmp_path / "s.json"))
    scene, meta, cam = load_scene(str(tmp_path / "s.json"), device="cpu")
    assert_same(scene, to_port(ref_scene))
    assert meta == to_port(ref_meta)
    assert len(scene.mesh_geoms) == 1 and scene.instances.mesh_ids == (0, 0)
    assert scene.tris.count == len(gf) + len(f)  # the grid and the scaled pyramid are baked
    # blue, the default, then per use of an OBJ its materials: the instanced
    # geometry keeps those of the first use (pyr.obj's stone and gold: 2, 3)
    assert scene.materials.bsdf.shape[0] == 9
    assert sorted(set(scene.mesh_geoms[0].tris.material_id.tolist())) == [2, 3]


def _rays(seed):
    """Half camera-like rays toward the scene, half random rays inside it."""
    rng = np.random.default_rng(seed)
    n = N_RAYS // 2
    d1 = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.3, n), np.ones(n)], 1)
    o1 = np.tile([[0.0, 1.0, -7.0]], (n, 1))
    o2 = rng.uniform(-3.0, 3.0, (n, 3)) + np.array([0.0, 0.5, 1.0])
    d2 = rng.normal(size=(n, 3))
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _ref_vec(a):
    return RefVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _vec(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _queries(seed=3):
    """The test rays: (o, d, any-hit lanes, their t_max, occlusion limits)."""
    o, d = _rays(seed)
    rng = np.random.default_rng(seed + 1)
    any_hit = rng.random(N_RAYS) < 0.3
    t_max = np.where(any_hit, rng.uniform(1.0, 8.0, N_RAYS), 3.0e38).astype(np.float32)
    limit = rng.uniform(0.5, 9.0, N_RAYS).astype(np.float32)
    return o, d, any_hit, t_max, limit


@pytest.fixture(scope="module")
def ref_queries(scenes):
    """The JAX package's scene_traverse and scene_occluded answers on the
    test rays, per (mode, scene), each computed once: the interpret-mode
    wave2 kernel then compiles once for the two tests that use it."""
    o, d, any_hit, t_max, limit = _queries()
    cache = {}

    def get(mode, name):
        if (mode, name) not in cache:
            ref_scene = scenes[name][0][0]
            ref_traverse.set_traversal_mode(mode)
            try:
                cache[mode, name] = (
                    ref_traverse.scene_traverse(ref_scene, _ref_vec(o), _ref_vec(d), jnp.asarray(t_max),
                                                any_hit=jnp.asarray(any_hit)),
                    ref_traverse.scene_occluded(ref_scene, _ref_vec(o), _ref_vec(d), jnp.asarray(limit)),
                    np.asarray(ref_traverse.scene_occluded(ref_scene, _ref_vec(o), _ref_vec(d),
                                                           jnp.asarray(t_max))[0]))
            finally:
                ref_traverse.set_traversal_mode("auto")
        return cache[mode, name]

    yield get
    jax.clear_caches()


@pytest.mark.parametrize("mode", ["cluster", "wave2", "bvh"])
def test_traverse_and_occluded_match_reference(scenes, ref_queries, restore_modes, mode):
    """scene_traverse (closest-hit lanes and fused any-hit lanes) and
    scene_occluded on both scenes, each package in the same mode; the
    port's ``bvh`` (the walk for the baked mesh, wave2 for the instances)
    against the JAX package's ``wave2``, whose CPU fallback for instances
    under ``bvh`` is another engine.  Closest-hit lanes: ids equal.  Fused
    any-hit lanes: occluded exactly where the JAX package's scene_occluded
    says so with the same limit (its fused query lets instances behind the
    limit occlude; see test_instances_behind_the_limit_do_not_occlude)."""
    traverse.set_traversal_mode(mode)
    o, d, any_hit, t_max, limit = _queries()
    calls = {"bvh_closest_hit": 0, "wave2_closest_hit": 0}
    count = lambda name, real: lambda *a, **k: (calls.__setitem__(name, calls[name] + 1), real(*a, **k))[1]
    for name in ("pyramids", "grids"):
        scene = scenes[name][1][0]
        ref, (ref_occ, ref_ovf), ref_shadow = ref_queries("wave2" if mode == "bvh" else mode, name)
        with mock.patch.object(traverse, "bvh_closest_hit", count("bvh_closest_hit", traverse.bvh_closest_hit)), \
                mock.patch.object(traverse, "wave2_closest_hit", count("wave2_closest_hit", traverse.wave2_closest_hit)):
            got = traverse.scene_traverse(scene, _vec(o), _vec(d), torch.as_tensor(t_max),
                                          any_hit=torch.as_tensor(any_hit))
        occ, ovf = traverse.scene_occluded(scene, _vec(o), _vec(d), torch.as_tensor(limit))
        lanes = ~any_hit
        for field in ("tri_id", "inst_id", "prim_id"):
            assert np.array_equal(getattr(got, field).numpy()[lanes], np.asarray(getattr(ref, field))[lanes]), \
                (name, field)
        shadowed = (got.t.numpy() < t_max) & ((got.tri_id.numpy() >= 0) | (got.prim_id.numpy() >= 0))
        assert np.array_equal(shadowed[any_hit], ref_shadow[any_hit]), name
        inst = got.inst_id.numpy()
        assert (inst >= 0).sum() > 20 and ((got.tri_id.numpy() >= 0) & (inst < 0)).sum() > 20, name  # both kinds hit
        np.testing.assert_allclose(got.t.numpy()[lanes], np.asarray(ref.t)[lanes], rtol=1e-5, atol=1e-5)
        assert (got.attr is None) == (mode != "wave2") and (ref.attr is None) == (mode == "cluster")
        assert np.array_equal(occ.numpy(), np.asarray(ref_occ)) and 0.1 < occ.numpy().mean() < 0.9
        # the cluster engine's per-ray candidate budget may overflow; the two
        # packages flag the same rays (fused any-hit lanes query other limits)
        assert np.array_equal(ovf.numpy(), np.asarray(ref_ovf))
        assert np.array_equal(got.overflow.numpy()[lanes], np.asarray(ref.overflow)[lanes])
        assert mode == "cluster" or not (ovf.any() or got.overflow.any())
    # one engine call per shared mesh a traversal (the top level), not one per instance
    n_mesh = sum(len(scenes[name][1][0].mesh_geoms) for name in scenes)
    want = {"cluster": (0, 0), "wave2": (0, 2 + n_mesh), "bvh": (2, n_mesh)}[mode]
    assert (calls["bvh_closest_hit"], calls["wave2_closest_hit"]) == want, calls


def test_instances_behind_the_limit_do_not_occlude(scenes, restore_modes):
    """A fused any-hit lane (a shadow ray) is occluded only by what lies
    before its limit.  The JAX package caps each instance query by the best
    t so far alone, which is BIG where nothing has been hit: its lane gets
    the hit of an instance behind the limit (behind the light), and under
    wave2, which reports an any-hit lane's hit as t = 0, that lane reads as
    occluded.  The port keeps the limit; this departure is what makes the
    instanced hall render like the baked one."""
    traverse.set_traversal_mode("cluster")
    ref_traverse.set_traversal_mode("cluster")
    (ref_scene, _), (scene, _) = scenes["pyramids"]
    n = 64
    rng = np.random.default_rng(9)
    target = np.array(PLACES[0][0]) + np.array([0.0, 0.5, 0.0]) + rng.uniform(-0.1, 0.1, (n, 3))
    o = np.tile([[-1.6, 0.5, -6.0]], (n, 1)) + rng.uniform(-0.2, 0.2, (n, 3))
    d = target - o
    dist = np.linalg.norm(d, axis=1)
    o, d = o.astype(np.float32), (d / dist[:, None]).astype(np.float32)
    for frac, want in ((0.3, False), (1.5, True)):
        t_max = (frac * dist).astype(np.float32)
        got = traverse.scene_traverse(scene, _vec(o), _vec(d), torch.as_tensor(t_max),
                                      any_hit=torch.ones(n, dtype=torch.bool))
        assert ((got.t.numpy() < t_max) == want).all(), frac
        assert (traverse.scene_occluded(scene, _vec(o), _vec(d), torch.as_tensor(t_max))[0].numpy() == want).all()
        assert (np.asarray(ref_traverse.scene_occluded(ref_scene, _ref_vec(o), _ref_vec(d),
                                                       jnp.asarray(t_max))[0]) == want).all()
        ref = ref_traverse.scene_traverse(ref_scene, _ref_vec(o), _ref_vec(d), jnp.asarray(t_max),
                                          any_hit=jnp.ones(n, bool))
        assert (np.asarray(ref.inst_id) == 0).all()  # the reference's fused lane: the instance, even past t_max
        assert ((got.inst_id.numpy() == 0) == want).all()


def _frame_close(got, ref, label):
    for f in ("position", "normal", "tangent", "bitangent"):
        for c in "xyz":
            np.testing.assert_allclose(getattr(getattr(got, f), c).numpy(), np.asarray(getattr(getattr(ref, f), c)),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{label} {f}.{c}")
    for f in ("tex_u", "tex_v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{label} {f}")
    for f in ("material_id", "light_id"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f))), (label, f)


@pytest.mark.parametrize("name", ["pyramids", "grids"])
def test_hit_frame_matches_reference_on_both_paths(scenes, restore_modes, name):
    """scene_hit_frame on the same hits in both packages: the gather path
    (cluster hits, no attributes) and the attribute path (wave2 hits).  On
    ``grids`` the instances' tri ids run past the baked table's end, and
    the port raises if it gathers a table with another table's ids."""
    (ref_scene, _), (scene, _) = scenes[name]
    o, d = _rays(5)
    n_baked = scene.tris.count
    for mode in ("cluster", "wave2"):
        traverse.set_traversal_mode(mode)
        hits = traverse.scene_traverse(scene, _vec(o), _vec(d))
        assert (hits.attr is None) == (mode == "cluster")
        ref_hits = RefHits(*(None if x is None else tuple(jnp.asarray(a.numpy()) for a in x) if isinstance(x, tuple)
                             else jnp.asarray(x.numpy()) for x in hits))
        tri, inst = hits.tri_id.numpy(), hits.inst_id.numpy()
        if name == "grids":
            assert (tri[inst >= 0] >= n_baked).sum() > 20  # out of the baked table's range
        else:
            assert (tri[inst < 0] >= scene.mesh_geoms[0].tris.count).sum() > 20  # out of the geometry's range
        got = traverse.scene_hit_frame(scene, hits, _vec(o), _vec(d))
        ref = ref_traverse.scene_hit_frame(ref_scene, ref_hits, _ref_vec(o), _ref_vec(d))
        _frame_close(got, ref, f"{name} {mode}")


def test_instanced_render_matches_reference():
    """24^2, depth 3, MIS: the port (wave2, its kernel's twin) against the
    JAX package (``wave`` on a CPU) on the ``pyramids`` scene at the default
    K: counters within 0.1%, >= 99.5% of pixels within atol 1e-4 / rtol 1e-3,
    mean within 0.1%."""
    size = 24
    rb = ref_build.SceneBuilder()
    _fill(rb, ref_build, RefRigidTransform, "pyramids")
    pb = build.SceneBuilder()
    _fill(pb, build, RigidTransform, "pyramids")
    cam_kw = dict(fov_deg=45.0)
    rv = RefViewport(*rb.build(), ref_make_camera(RefRigidTransform(translation=(0.0, 1.0, -7.0)), **cam_kw),
                     RefViewportParams(size, size, seed=0), RefRenderParams(max_depth=3, mis=True))
    pv = Viewport(*pb.build("cpu"), make_camera(RigidTransform(translation=(0.0, 1.0, -7.0)), **cam_kw, device="cpu"),
                  ViewportParams(size, size, seed=0), RenderParams(max_depth=3, mis=True), device="cpu")
    a = rv.render(1).radiance()
    b = pv.render(1).radiance()
    assert np.isfinite(b).all() and b.mean() > 0
    rp, pp = rv.progress(), pv.progress()
    for key in ("total_rays", "total_shadow_rays"):
        assert abs(pp[key] - rp[key]) <= 1e-3 * rp[key], (key, pp[key], rp[key])
    assert pp["total_traversal_overflow"] == 0
    close = np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(b.mean() - a.mean()) <= 1e-3 * abs(a.mean())


def _light_behind(b, pkg_build, rigid, baked):
    """A floor lit by a rect light that faces it, and the pyramid placed
    just above the light: every shadow ray from the floor to the light
    points at the pyramid, which lies past the ray's limit."""
    grey = b.add_material(pkg_build.MaterialDesc(name="grey", bsdf="diffuse", base_color=(0.6, 0.6, 0.6)))
    red = b.add_material(pkg_build.MaterialDesc(name="red", bsdf="diffuse", base_color=(0.7, 0.3, 0.2)))
    b.add_light(pkg_build.LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.05, 0.05, 0.05)))
    b.add_light(pkg_build.LightDesc(kind=T.LIGHT_AREA, color=(8.0, 8.0, 8.0),
                                    transform=rigid(translation=(0.0, 2.0, 0.0), euler_deg=(90.0, 0.0, 0.0)),
                                    shape_kind=T.SHAPE_RECT, shape_param=(0.5, 0.5, 0.0)))
    b.add_rect(rigid(euler_deg=(-90.0, 0.0, 0.0)), (6.0, 6.0), grey)
    pv, pf, pn, _ = _pyramid()
    place = rigid(translation=(0.0, 2.5, 0.0))
    if baked:
        b.add_mesh(pv, pf, pn, None, np.full(len(pf), red), transform=place)
    else:
        b.add_mesh_instance(b.add_mesh_geometry(pv, pf, pn, None, np.full(len(pf), red)), place)


def test_light_behind_an_instance_pins_the_reference_divergence(restore_modes):
    """The one place where the port departs from the JAX package on purpose,
    at image level: a 16^2 depth-2 MIS render of ``_light_behind`` (clusters
    at K = 8).  The port under wave2 renders the instanced scene as it
    renders the same pyramid baked, and as the JAX package renders it under
    ``wave`` (counters within 0.1%, >= 99.5% of pixels within atol 1e-4 /
    rtol 1e-3, mean within 0.1%).  The JAX package under wave2 caps the
    pyramid's query of a fused shadow ray by the best t alone, its
    any-hit lane collapses the pyramid's hit to t = 0, and the floor under
    the light reads as shadowed: measured 55.2% darker in the mean, 30.9% of
    pixels apart, with the same rays and shadow rays traced.  The bands
    below pin that gap."""
    size, cam_kw = 16, dict(translation=(0.0, 4.0, -6.0), euler_deg=(35.0, 0.0, 0.0))
    params = dict(max_depth=2, mis=True)

    def port(baked):
        with mock.patch.object(clusters, "build_clusters", partial(clusters.build_clusters, k=K)):
            b = build.SceneBuilder()
            _light_behind(b, build, RigidTransform, baked)
            scene = b.build("cpu")
        v = Viewport(*scene, make_camera(RigidTransform(**cam_kw), fov_deg=50.0, device="cpu"),
                     ViewportParams(size, size, seed=0), RenderParams(**params), device="cpu").render(1)
        return v.radiance(), v.progress()

    def ref(mode):
        ref_traverse.set_traversal_mode(mode)
        jax.clear_caches()  # the JAX package reads its mode while it traces
        with mock.patch.object(ref_clusters, "build_clusters", partial(ref_clusters.build_clusters, k=K)):
            b = ref_build.SceneBuilder()
            _light_behind(b, ref_build, RefRigidTransform, False)
            scene = b.build()
        v = RefViewport(*scene, ref_make_camera(RefRigidTransform(**cam_kw), fov_deg=50.0),
                        RefViewportParams(size, size, seed=0), RefRenderParams(**params)).render(1)
        return v.radiance(), v.progress()

    got, got_p = port(False)
    baked, _ = port(True)
    assert got.mean() > 0.05 and np.isfinite(got).all()
    assert np.array_equal(got, baked)
    for mode in ("auto", "wave2"):  # auto: `wave` on a CPU, which traces |t_cap| without the any-hit collapse
        want, want_p = ref(mode)
        for key in ("total_rays", "total_shadow_rays"):
            assert abs(got_p[key] - want_p[key]) <= 1e-3 * want_p[key], (mode, key, got_p[key], want_p[key])
        close = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(-1).mean()
        gap = (got.mean() - want.mean()) / got.mean()
        if mode == "auto":
            assert close >= 0.995 and abs(gap) <= 1e-3, (close, gap)
        else:
            assert 0.50 <= gap <= 0.60 and 0.25 <= 1.0 - close <= 0.40, (close, gap)
