"""Port parity: motion blur (per-ray shutter time through
``ops/intersect.py``, ``ops/traverse.py``, the camera, the path tracer and
``ViewportParams.motion_blur_strength``) against the JAX package, on the
CPU.

The scenes are ``tools/torch_check_features.py``'s ``moving_prims`` (a
moving sphere and a moving box under a rect light) and ``moving_instance``
(a pyramid mesh placed twice, one instance moving, beside a moving sphere;
clusters at K = 8), built by the JAX package's builder and carried across
with ``scene/convert.py``.

- ``intersect_prims``, ``occluded_prims`` and ``eval_prim_frame`` on 4,096
  seeded rays, each at its own shutter time: prim ids and occlusion equal,
  the frames of the same hits within rtol 1e-6 / atol 1e-6 (the frame's normal and tangent
  go through a normalize and an atan2 / arccos, where torch and XLA may
  differ by an ulp), t within rtol 1e-5: XLA fuses the multiply-adds of
  the sphere's quadratic, and the two packages' sphere distances differ by
  up to 4.8e-6 relative on these rays without motion too (3.9e-6 with it).
- ``_instance_local_ray`` at per-lane times: object-space origins and
  directions within rtol 1e-6 / atol 1e-7.
- Renders at strength 1, per pixel within rtol 1e-4 / atol 1e-6 (the other
  render parity tests' tolerance) and ray counters equal: the moving prims
  (24^2, depth 3, MIS, after pass 0 and pass 1); the moving instance
  (16^2, depth 2, after pass 0 and pass 1), the port under its default
  wave2 engine (the kernel's twin on the CPU) and the JAX package under
  ``cluster``, which is exact at K = 8 and plain XLA (under wave2 its
  Pallas kernel runs in interpret mode and the render compiles for 69 s);
  the moving camera (a shutter-close pose) over the prims held still
  (24^2, depth 3, one pass).  One pixel of the moving instance's render
  is pinned in ``APART``: its camera ray grazes the moving sphere, whose
  shadow ray then meets the sphere again 2.6e-4 on, and the jitted JAX
  render (fused multiply-adds) lands the hit point so that it does not;
  the same JAX function run eagerly (``jax.disable_jit``) gives the port's
  value there (measured on the pixel's first segment, depth 0).
- Port only: at strength 0 a scene with velocities and a camera with a
  shutter pose render bit for bit as the same scene and camera without
  them, and no sample dimension is drawn for the time.
"""

import dataclasses
import os
import sys
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import intersect as ref_intersect, traverse as ref_traverse
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.scene import build as ref_build, clusters as ref_clusters, types as RT
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import intersect, traverse
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.convert import scene_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import torch_check_features as tfx  # noqa: E402

N = 4096
FILM_RTOL, FILM_ATOL = 1e-4, 1e-6
# (row, column) of the moving instance's render outside the tolerance
APART = [(6, 13)]


def carry(x):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")


def _both(make, k=None):
    """(JAX scene, meta, camera kwargs), (port scene, meta) of one of
    torch_check_features' scenes; clusters at ``k`` triangles if given."""
    with mock.patch.object(ref_clusters, "build_clusters", partial(ref_clusters.build_clusters, k=k or 64)):
        b, t_kw, c_kw = make(ref_build, RefRigidTransform, RT)
        scene, meta = b.build()
    return (scene, meta, (t_kw, c_kw)), (carry(scene), meta)


def _rays(seed):
    """Rays from around the camera toward the props, and shutter times."""
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 1.2, -2.5]) + rng.uniform(-0.5, 0.5, (N, 3))).astype(np.float32)
    d = np.array([0.0, -0.4, 1.0]) + rng.normal(scale=0.35, size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, rng.random(N, dtype=np.float32)


ref_vec = lambda a: RefVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
vec = lambda a: Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _close(got, want, rtol=1e-6, atol=1e-6, label=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=label)


def test_prims_at_per_lane_times_match_reference():
    (rs, _, _), (ps, _) = _both(tfx.moving_prims)
    o, d, time = _rays(1)
    t_max = np.full(N, 3.0e38, np.float32)
    ref_t, ref_id = ref_intersect.intersect_prims(rs.prims, ref_vec(o), ref_vec(d), jnp.asarray(t_max),
                                                  jnp.asarray(time))
    t, pid = intersect.intersect_prims(ps.prims, vec(o), vec(d), torch.as_tensor(t_max), torch.as_tensor(time))
    np.testing.assert_array_equal(pid.numpy(), np.asarray(ref_id))
    _close(t, ref_t, rtol=1e-5)
    static_id = intersect.intersect_prims(ps.prims, vec(o), vec(d), torch.as_tensor(t_max))[1].numpy()
    assert (static_id != pid.numpy()).mean() > 0.01  # the motion moved some hits
    assert set(np.unique(pid.numpy())) >= {0, 1, 2, 3}
    limit = np.random.default_rng(2).uniform(0.5, 6.0, N).astype(np.float32)
    occ = intersect.occluded_prims(ps.prims, vec(o), vec(d), torch.as_tensor(limit), torch.as_tensor(time))
    ref_occ = ref_intersect.occluded_prims(rs.prims, ref_vec(o), ref_vec(d), jnp.asarray(limit), jnp.asarray(time))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))
    assert 0.1 < occ.numpy().mean() < 0.9
    frame = intersect.eval_prim_frame(ps.prims, pid, vec(o), vec(d), t, time=torch.as_tensor(time))
    # the frame of the same hits (the port's t) in both packages
    ref_frame = ref_intersect.eval_prim_frame(rs.prims, ref_id, ref_vec(o), ref_vec(d), jnp.asarray(t.numpy()),
                                              time=jnp.asarray(time))
    for f in ("position", "normal", "tangent", "bitangent"):
        for c in "xyz":
            _close(getattr(getattr(frame, f), c), getattr(getattr(ref_frame, f), c), label=f"{f}.{c}")
    for f in ("tex_u", "tex_v"):
        _close(getattr(frame, f), getattr(ref_frame, f), label=f)
    for f in ("material_id", "light_id"):
        np.testing.assert_array_equal(getattr(frame, f).numpy(), np.asarray(getattr(ref_frame, f)))


def test_instance_local_rays_at_per_lane_times_match_reference():
    (rs, _, _), (ps, _) = _both(tfx.moving_instance, k=8)
    o, d, time = _rays(3)
    for i in range(ps.instances.count):
        got = traverse._instance_local_ray(ps, i, vec(o), vec(d), torch.as_tensor(time))
        want = ref_traverse._instance_local_ray(rs, i, ref_vec(o), ref_vec(d), jnp.asarray(time))
        for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
            _close(g, w, atol=1e-7, label=f"instance {i}")
    moved = traverse._instance_local_ray(ps, 0, vec(o), vec(d), torch.as_tensor(time))[0]
    still = traverse._instance_local_ray(ps, 0, vec(o), vec(d))[0]
    assert float((moved.x - still.x).abs().max()) > 0.5  # the first instance moves by 0.9 in x


@pytest.fixture
def restore_modes(monkeypatch):
    """Both packages back to 'auto' afterwards; the JAX package reads its
    mode while it traces, so its compiled renders are dropped too."""
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    yield
    traverse.set_traversal_mode("auto")
    ref_traverse.set_traversal_mode("auto")
    jax.clear_caches()


def _render_pair(ref_scene, port_scene, meta, t_kw, c_kw, size, depth, passes, end=None, apart=()):
    """The two Viewports' radiance after each pass, at strength 1: equal
    within the tolerance but at the pixels ``apart``."""
    kw = dict(transform_end=None if end is None else RefRigidTransform(**end))
    rv = RefViewport(ref_scene, meta, ref_make_camera(RefRigidTransform(**t_kw), **c_kw, **kw),
                     RefViewportParams(size, size, seed=0, motion_blur_strength=1.0),
                     RefRenderParams(max_depth=depth, mis=True))
    kw = dict(transform_end=None if end is None else RigidTransform(**end))
    pv = Viewport(port_scene, meta, make_camera(RigidTransform(**t_kw), **c_kw, **kw, device="cpu"),
                  ViewportParams(size, size, seed=0, motion_blur_strength=1.0), RenderParams(max_depth=depth, mis=True),
                  device="cpu")
    for p in range(passes):
        a, b = rv.render(1).radiance(), pv.render(1).radiance()
        assert np.isfinite(b).all() and b.mean() > 0
        off = ~np.isclose(b, a, rtol=FILM_RTOL, atol=FILM_ATOL).all(-1)
        assert [tuple(int(i) for i in j) for j in np.argwhere(off)] == list(apart), f"after pass {p}"
        for key in ("total_rays", "total_shadow_rays"):
            assert pv.progress()[key] == rv.progress()[key], key
        # (the JAX cluster engine flags rays whose candidate list it may
        # have cut; the port's wave2 engine has no such budget)
        assert pv.progress()["total_traversal_overflow"] == 0
    return b


def test_moving_prims_render_matches_reference():
    (rs, rm, (t_kw, c_kw)), (ps, _) = _both(tfx.moving_prims)
    _render_pair(rs, ps, rm, t_kw, c_kw, 24, 3, 2)


def test_moving_instance_render_matches_reference(restore_modes):
    (rs, rm, (t_kw, c_kw)), (ps, _) = _both(tfx.moving_instance, k=8)
    ref_traverse.set_traversal_mode("cluster")
    jax.clear_caches()
    assert traverse._resolved_mode(ps) == "wave2"
    _render_pair(rs, ps, rm, t_kw, c_kw, 16, 2, 2, apart=APART)


def test_moving_camera_render_matches_reference():
    (rs, rm, (t_kw, c_kw)), (ps, _) = _both(tfx.moving_prims)
    still = lambda s, z: s._replace(prims=s.prims._replace(vel=type(s.prims.vel)(*(z(c) for c in s.prims.vel))))
    _render_pair(still(rs, jnp.zeros_like), still(ps, torch.zeros_like), rm, t_kw, c_kw, 24, 3, 1, end=tfx.CAMERA_END)


def test_zero_strength_is_the_static_render_bit_for_bit():
    """At strength 0 no time is drawn: velocities and a shutter pose change
    nothing, bit for bit."""
    (_, _, (t_kw, c_kw)), (ps, pm) = _both(tfx.moving_prims)
    still = ps._replace(prims=ps.prims._replace(vel=Vec3(*(torch.zeros_like(c) for c in ps.prims.vel))))
    cam = make_camera(RigidTransform(**t_kw), **c_kw, device="cpu")
    moving_cam = make_camera(RigidTransform(**t_kw), transform_end=RigidTransform(**tfx.CAMERA_END), **c_kw,
                             device="cpu")
    assert moving_cam.enable_motion_blur and not cam.enable_motion_blur
    run = lambda s, c, strength: Viewport(s, pm, c, ViewportParams(16, 16, seed=0, motion_blur_strength=strength),
                                          RenderParams(max_depth=3, mis=True), device="cpu").render(2).radiance()
    base = run(still, cam, 0.0)
    np.testing.assert_array_equal(run(ps, moving_cam, 0.0), base)
    assert not np.array_equal(run(ps, cam, 1.0), base)
    assert dataclasses.replace(ViewportParams(), motion_blur_strength=0.0) == ViewportParams()
