"""Port parity: the ``wave`` traversal mode (``ops/wave_traverse.py``, the
binned-wavefront engine) against the JAX package's, on the CPU.

Both packages get the same cluster set (the JAX builder's, carried across
with ``scene/convert.py``; 5,000 triangles, K as the builder gives it) and
the same windows of rays from numpy: a camera window, and a bounce window
that leaves the camera rays' hits in seeded random directions.  The
candidates of one phase-1 round and of the round after it (from the resume
cursor the first leaves) are equal, entries bit for bit; tri ids, overflow
and occlusion are equal.  t, u and v differ where XLA:CPU fuses
multiply-adds in the Möller-Trumbore, most on thin triangles seen from
near by: measured at these seeds, t within 7.3e-7 relative on the camera window, and
on the bounce window within 6.0e-5 relative wherever the difference passes
1e-6 absolute (3.0e-4 relative at t ~ 0.005); u and v within 2.9e-5.  So t
is held at rtol 1e-4 + atol 1e-6 and u, v at atol 1e-4 against JAX, and
the port's t, u, v bit for bit against a numpy float32 Möller-Trumbore of
the hit triangle (``tests/test_torch_bvh.py::_mt_f32``).  A 16^2, depth 2
render under ``wave`` in both packages agrees per pixel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import traverse as ref_traverse
from raytracer_tpu.ops import wave_traverse as ref_wave
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import random_mesh_scene
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.ops import wave_traverse as wave
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.convert import scene_from_numpy
from tests.test_torch_bvh import _mt_f32

N_RAYS = 2048
BIG = 3.0e38


@pytest.fixture(scope="module")
def scenes():
    ref = random_mesh_scene(5000)
    return ref, tuple(scene_from_numpy(x if i == 1 else jax.tree_util.tree_map(np.asarray, x), "cpu")
                      for i, x in enumerate(ref))


def _camera_window(seed):
    """Rays from a plane behind the mesh, spread around +z."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, N_RAYS), rng.uniform(-3, 3, N_RAYS), np.full(N_RAYS, -2.0)], 1)
    d = np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.2, (N_RAYS, 3))
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _bounce_window(cs, seed):
    """Rays leaving the camera window's hits (misses keep their origin) in
    random directions."""
    o, d = _camera_window(seed)
    t, tri = (np.asarray(x) for x in ref_wave.wave_closest_hit(cs, _ref(o), _ref(d), BIG)[:2])
    o = np.where((tri >= 0)[:, None], o + d * (t * (1.0 - 1e-4))[:, None], o).astype(np.float32)
    d = np.random.default_rng(seed + 1).normal(size=(N_RAYS, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _ref(a):
    return RefVec3(*jnp.asarray(a.T))


def _got(a):
    return Vec3(*torch.as_tensor(a.T.copy()))


def _window(cs, name):
    return _camera_window(3) if name == "camera" else _bounce_window(cs, 3)


@pytest.mark.parametrize("name", ["camera", "bounce"])
def test_phase1_candidates_and_resume_cursor_equal(scenes, name):
    (ref_scene, _), (scene, _) = scenes
    o, d = _window(ref_scene.clusters, name)
    kc = 4
    ref_in = [jnp.asarray(x) for x in (*o.T, *(ref_wave._safe_inv(jnp.asarray(c)) for c in d.T))]
    got_in = [torch.as_tensor(np.array(x)) for x in ref_in]
    res_e = np.full(N_RAYS, -1.0, np.float32)
    res_c = np.full(N_RAYS, -1, np.int32)
    best = np.full(N_RAYS, BIG, np.float32)
    for _ in range(2):  # the first round, then the round after its cursor
        rc, re = (np.asarray(x) for x in ref_wave._phase1_round(
            ref_scene.clusters, *ref_in, jnp.asarray(best), jnp.asarray(res_e), jnp.asarray(res_c), kc))
        gc, ge = (x.numpy() for x in wave._phase1_round(
            scene.clusters, *got_in, torch.as_tensor(best), torch.as_tensor(res_e), torch.as_tensor(res_c), kc))
        np.testing.assert_array_equal(gc, rc)
        np.testing.assert_array_equal(ge, re)
        full = np.isfinite(re).sum(1) == kc
        res_e = np.where(full, re[:, -1], res_e).astype(np.float32)
        res_c = np.where(full, rc[:, -1], res_c).astype(np.int32)
        assert full.any()
    assert (rc < scene.clusters.num_clusters).any()


@pytest.mark.parametrize("name", ["camera", "bounce"])
@pytest.mark.parametrize("kc,max_rounds", [(16, 16), (2, 2)])
def test_closest_and_any_hit_equal_reference(scenes, name, kc, max_rounds):
    """The defaults, and kc = 2 over 2 rounds, where rays run out of rounds
    and overflow."""
    (ref_scene, _), (scene, _) = scenes
    o, d = _window(ref_scene.clusters, name)
    ref = [np.asarray(x) for x in ref_wave.wave_closest_hit(ref_scene.clusters, _ref(o), _ref(d), BIG, kc, max_rounds)]
    got = [x.numpy() for x in wave.wave_closest_hit(scene.clusters, _got(o), _got(d), BIG, kc, max_rounds)]
    np.testing.assert_array_equal(got[1], ref[1])  # tri ids
    np.testing.assert_array_equal(got[4], ref[4])  # overflow
    assert (ref[1] >= 0).mean() > 0.3
    assert ref[4].any() == (kc == 2)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-4)
    # the port's own t, u, v: bit-equal to Möller-Trumbore of the hit
    # triangle in numpy float32, in _mt_blocks' op order
    hit = got[1] >= 0
    ids, blocks = scene.clusters.tri_id.reshape(-1).numpy(), scene.clusters.tri_block.reshape(-1, 9).numpy()
    rows = np.zeros((ids.max() + 1, 9), np.float32)
    rows[ids[ids >= 0]] = blocks[ids >= 0]
    et, eu, ev = _mt_f32(rows[got[1][hit]], o[hit], d[hit])
    assert np.array_equal(got[0][hit], et) and np.array_equal(got[2][hit], eu) and np.array_equal(got[3][hit], ev)
    seen = []
    for reach in (7.0, 12.0):
        r_occ, r_ovf = (np.asarray(x) for x in ref_wave.wave_any_hit(
            ref_scene.clusters, _ref(o), _ref(d), reach, kc, max_rounds))
        g_occ, g_ovf = (x.numpy() for x in wave.wave_any_hit(scene.clusters, _got(o), _got(d), reach, kc, max_rounds))
        np.testing.assert_array_equal(g_occ, r_occ)
        np.testing.assert_array_equal(g_ovf, r_ovf)
        seen.append(r_occ.mean())
    assert 0 < min(seen) and max(seen) < 1, seen


def test_hits_carry_no_graph(scenes):
    (_, _), (scene, _) = scenes
    o, d = _camera_window(3)
    origin = Vec3(*(c.requires_grad_() for c in _got(o)))
    t, tri, u, v, _ = wave.wave_closest_hit(scene.clusters, origin, _got(d), BIG)
    assert all(x.grad_fn is None and not x.requires_grad for x in (t, u, v))


def test_render_under_wave_matches_reference(scenes, monkeypatch):
    """16^2, depth 2, MIS under ``wave`` in both packages: ray counters
    equal, every pixel within atol 1e-5 / rtol 1e-4."""
    ref, got = scenes
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    assert ref_traverse._resolved_mode(ref[0]) == "wave"  # the reference's auto on the CPU
    traverse.set_traversal_mode("wave")
    try:
        kw = dict(translation=(0.0, 0.0, 0.0))
        rv = RefViewport(*ref, ref_make_camera(RefRigidTransform(**kw), fov_deg=50.0),
                         RefViewportParams(16, 16, seed=0), RefRenderParams(max_depth=2, mis=True))
        pv = Viewport(*got, make_camera(RigidTransform(**kw), fov_deg=50.0, device="cpu"),
                      ViewportParams(16, 16, seed=0), RenderParams(max_depth=2, mis=True), device="cpu")
        a = rv.render(1).radiance()
        b = pv.render(1).radiance()
    finally:
        traverse.set_traversal_mode("auto")
    assert np.isfinite(b).all() and b.mean() > 0
    rp, pp = rv.progress(), pv.progress()
    for key in ("total_rays", "total_shadow_rays", "total_traversal_overflow"):
        assert pp[key] == rp[key], (key, pp[key], rp[key])
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-4)
