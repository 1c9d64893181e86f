"""The light tracer of the port against the JAX package's, and the pieces
under it: photon emission (``emit``), the camera's film mapping and pdf
(``world_to_film``, ``camera_pdf_w``) and the film splat.

Inputs are built with numpy from a seed and given to both packages; scenes
are the reference's, carried across with ``scene/convert.py``.  Tolerances:
``emit`` and the camera functions within rtol 1e-5 / atol 1e-6 per lane
(XLA:CPU fuses multiply-adds; measured worst: ``emit`` 7.2e-7 absolute,
``world_to_film`` equal), validity masks equal; the splat equal bit for bit
(both add a pixel's samples in lane order on the CPU); full light-tracing
passes per pixel within rtol 1e-4 / atol 1e-6 with the ray counter equal:
on the analytic Cornell box, pass 0 and 1 (measured worst 1.2e-7 absolute),
and on the 2k-triangle bench mesh under wave2 with the reference's Pallas
kernel in interpret mode at K = 8 (9.5e-6 absolute, 9.9e-7 relative).
"""

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
from raytracer_tpu.integrators import light_tracer as ref_lt
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.io.scene_loader import load_scene as ref_load_scene
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import lights as ref_lights
from raytracer_tpu.ops import traverse as ref_traverse
from raytracer_tpu.render import film as ref_film
from raytracer_tpu.render.renderer import ViewportParams as RefViewportParams
from raytracer_tpu.scene import build as ref_build
from raytracer_tpu.scene import camera as ref_camera
from raytracer_tpu.scene import clusters as ref_clusters
from raytracer_tpu.scene import types as RT
from raytracer_tpu.scene.presets import cornell_box as ref_cornell_box, cornell_camera_kw
from raytracer_tpu_torch.integrators import light_tracer as lt
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import lights
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.render import film
from raytracer_tpu_torch.render.renderer import ViewportParams
from raytracer_tpu_torch.scene import camera
from raytracer_tpu_torch.scene.convert import scene_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import bench_mesh  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # emit and the camera functions
FILM_RTOL, FILM_ATOL = 1e-4, 1e-6  # films


def carry(x):
    """A reference object (arrays, tables, metadata) as the port's, on the CPU."""
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")


def cornell():
    t_kw, c_kw = cornell_camera_kw()
    scene, meta = ref_cornell_box()
    cam = ref_camera.make_camera(RefRigidTransform(**t_kw), **c_kw)
    return (scene, meta, cam), (carry(scene), meta, carry(cam))


def assert_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _light_scene():
    """One light of every kind and shape: area rect / sphere / box, point,
    spot, a delta and a wide directional light, a background light."""
    b = ref_build.SceneBuilder()
    m = b.add_material(ref_build.MaterialDesc(bsdf="diffuse", base_color=(0.5,) * 3))
    b.add_sphere(RefRigidTransform(), 1.0, m)
    rt = lambda t, e=(0, 0, 0): RefRigidTransform(translation=t, euler_deg=e)
    for kw in (dict(kind=RT.LIGHT_AREA, transform=rt((0, 2, 1), (60, 10, 0)), shape_kind=RT.SHAPE_RECT,
                    shape_param=(0.7, 0.4, 0.0)),
               dict(kind=RT.LIGHT_AREA, transform=rt((1, 1, 3)), shape_kind=RT.SHAPE_SPHERE, shape_param=(0.3, 0, 0)),
               dict(kind=RT.LIGHT_AREA, transform=rt((-1, 1, 2), (20, 30, 40)), shape_kind=RT.SHAPE_BOX,
                    shape_param=(0.2, 0.5, 0.3)),
               dict(kind=RT.LIGHT_POINT, transform=rt((0, 3, 0))),
               dict(kind=RT.LIGHT_SPOT, transform=rt((0, 3, -1), (70, 0, 0)), angle_rad=0.4),
               dict(kind=RT.LIGHT_DIRECTIONAL, transform=rt((0, 0, 0), (120, 20, 0))),
               dict(kind=RT.LIGHT_DIRECTIONAL, transform=rt((0, 0, 0), (100, -30, 0)), angle_rad=0.2),
               dict(kind=RT.LIGHT_BACKGROUND)):
        b.add_light(ref_build.LightDesc(color=(2.0, 3.0, 4.0), **kw))
    return b.build()


def test_emit_matches_reference_for_every_light_kind():
    scene, meta = _light_scene()
    port = carry(scene)
    n_lights = meta.n_lights
    rng = np.random.default_rng(0)
    n = 4096
    idx = np.arange(n, dtype=np.int32) % n_lights
    u = rng.random((5, n), dtype=np.float32)
    ref = ref_lights.emit(ref_lights.gather_light(scene.lights, jnp.asarray(idx)), *(jnp.asarray(x) for x in u),
                          scene_radius=meta.scene_radius)
    got = lights.emit(lights.gather_light(port.lights, torch.as_tensor(idx)), *(torch.as_tensor(x) for x in u),
                      scene_radius=meta.scene_radius)
    assert set(np.asarray(scene.lights.kind).tolist()) == {RT.LIGHT_AREA, RT.LIGHT_POINT, RT.LIGHT_SPOT,
                                                            RT.LIGHT_DIRECTIONAL, RT.LIGHT_BACKGROUND}
    for name in ref_lights.Emission._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if isinstance(a, RefVec3):
            for ca, cb in zip(a, b):
                assert_close(cb, ca)
        else:
            assert_close(b, a)


def test_world_to_film_and_camera_pdf_match_reference():
    (_, _, ref_cam), (_, _, cam) = cornell()
    rng = np.random.default_rng(1)
    p = rng.uniform(-3, 3, (3, 20000)).astype(np.float32)
    p[2] += 1.0  # most points in front of the camera, some behind
    d = rng.normal(size=(3, 20000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    u_ref, v_ref, ok_ref = ref_camera.world_to_film(ref_cam, RefVec3(*(jnp.asarray(x) for x in p)))
    u, v, ok = camera.world_to_film(cam, Vec3(*(torch.as_tensor(x) for x in p)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert 0.05 < float(ok.float().mean()) < 0.95
    assert_close(u, u_ref)
    assert_close(v, v_ref)
    pdf_ref = ref_camera.camera_pdf_w(ref_cam, RefVec3(*(jnp.asarray(x) for x in d)))
    pdf = camera.camera_pdf_w(cam, Vec3(*(torch.as_tensor(x) for x in d)))
    assert_close(pdf, pdf_ref)
    assert float((pdf == 0).float().mean()) > 0.3  # directions behind the camera have pdf 0


def test_splat_matches_reference_bit_for_bit():
    rng = np.random.default_rng(2)
    w, h, n = 13, 9, 5000
    px = rng.integers(-3, w + 3, n).astype(np.int32)  # some lanes off the film
    py = rng.integers(-3, h + 3, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    color = rng.random((3, n), dtype=np.float32)
    start = rng.random((h, w, 3), dtype=np.float32)
    ref = ref_film.splat(ref_film.make_film(w, h)._replace(sum=jnp.asarray(start)), jnp.asarray(px), jnp.asarray(py),
                         RefVec3(*(jnp.asarray(c) for c in color)), jnp.asarray(mask))
    got = film.splat(film.make_film(w, h, "cpu")._replace(sum=torch.as_tensor(start)), torch.as_tensor(px),
                     torch.as_tensor(py), Vec3(*(torch.as_tensor(c) for c in color)), torch.as_tensor(mask))
    np.testing.assert_array_equal(got.sum.numpy(), np.asarray(ref.sum))
    assert not np.array_equal(got.sum.numpy(), start)


def _lt_passes(ref, port, size, depth, passes=(0, 1)):
    """Each pass of the reference (one jit compile) and of the port from an
    empty film: [(reference film sum, port film sum, ref rays, port rays)]."""
    vp = ViewportParams(size, size, seed=0)
    ref_vp = RefViewportParams(size, size, seed=0)
    (rs, rm, rc), (ps, pm, pc) = ref, port
    fn = jax.jit(lambda s, c, f, p: ref_lt.render_pass_light_tracer(
        s, rm, c, f, p, None, ref_vp, RefRenderParams(max_depth=depth)))
    out = []
    for p in passes:
        rf, rcount = fn(rs, rc, ref_film.make_film(size, size), jnp.int32(p))
        pf, pcount = lt.render_pass_light_tracer(ps, pm, pc, film.make_film(size, size, "cpu"), p, None, vp,
                                                 RenderParams(max_depth=depth))
        assert pf.num_passes == int(rf.num_passes) == 1
        out.append((np.asarray(rf.sum), pf.sum.numpy(), float(rcount.num_rays), float(pcount.num_rays)))
    return out


def test_light_tracer_pass_matches_reference_on_the_cornell_box():
    for a, b, ra, rb in _lt_passes(*cornell(), size=16, depth=4):
        assert rb == ra > 0
        assert np.isfinite(b).all() and b.mean() > 0
        np.testing.assert_allclose(b, a, rtol=FILM_RTOL, atol=FILM_ATOL)


@pytest.fixture
def restore_modes(monkeypatch):
    """Both packages back to 'auto' afterwards; the JAX package reads its
    mode while it traces, so its compiled passes are dropped too."""
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    yield
    traverse.set_traversal_mode("auto")
    ref_traverse.set_traversal_mode("auto")
    jax.clear_caches()


def small_mesh(tmp_path, monkeypatch):
    """The 2k-triangle bench mesh (a mesh, a background and a directional
    light), the reference's clusters at K = 8, carried across."""
    monkeypatch.setattr(bench_mesh, "BENCH_DIR", str(tmp_path))
    with mock.patch.object(ref_clusters, "build_clusters", partial(ref_clusters.build_clusters, k=8)):
        ref = ref_load_scene(bench_mesh.ensure_scene(2000))
    return ref, (carry(ref[0]), ref[1], carry(ref[2]))


def test_light_tracer_pass_matches_reference_on_a_mesh_under_wave2(restore_modes, tmp_path, monkeypatch):
    ref, port = small_mesh(tmp_path, monkeypatch)
    assert port[0].clusters.tris_per_cluster == 8
    jax.clear_caches()
    ref_traverse.set_traversal_mode("wave2")
    for a, b, ra, rb in _lt_passes(ref, port, size=16, depth=3, passes=(0,)):
        assert rb == ra > 0
        assert np.isfinite(b).all() and b.mean() > 0
        np.testing.assert_allclose(b, a, rtol=FILM_RTOL, atol=FILM_ATOL)
