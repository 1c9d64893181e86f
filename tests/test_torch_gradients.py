"""Port parity: reverse-mode gradients of the MIS path tracer through
autograd (``render/renderer.py::trace_rows``) against ``jax.grad`` of the
same loss, on the CPU.

One module fixture compiles the JAX ``value_and_grad`` of one loss, the
mean of ``r + 2 g + 0.5 b`` over ``tests/test_gradients.py::_scene`` at 8^2,
depth 4, MIS, with respect to six parameters at once: ``base_color``,
``emission``, ``roughness``, the light colours, the camera origin's z and a
yaw of the camera basis (``TestCameraGradients``' rotation).  It evaluates
it at the scene's tables; with ``base_color`` exactly on the Russian
roulette threshold's clip bounds (a channel of exactly 1.0; all zero), where
``jnp.clip`` passes half the gradient and the port's ``math.vec.clip`` must
too; and with the material as each rough and each smooth BSDF kind (the kind
table is an input of the compiled function).  The port's loss is held within
rtol 1e-5 and its gradients within rtol 2e-4 / atol 1e-6, the JAX package's
own bounds for the same gradients computed two ways
(``tests/test_parallel.py``), with the two departures that the tests below
name: roughDielectric's rounding, and the reference's NaN roughness gradient
of a specular material at roughness 0.  One more compile holds motion blur:
the gradient with respect to a camera's shutter-close origin at 16^2, depth
3, strength 1 (about two minutes of this file's time).

Then, port only (cheap, no JAX): the six finite-difference checks of
``tests/test_gradients.py`` with their steps and tolerances; hits that carry
no graph in every traversal mode; the same gradients under every exact
mode on a small mesh; and no graph from ``Viewport.render``.
"""

import os
import sys
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from tests.test_gradients import PARAMS as REF_PARAMS, VP as REF_VP, _scene, _smooth_scene
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.render.renderer import trace_rows as ref_trace_rows
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu_torch.integrators import path_tracer
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3, clip
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams, trace_rows
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.convert import scene_from_numpy
from raytracer_tpu_torch.scene import types as T
from raytracer_tpu_torch.scene.build import LightDesc, MaterialDesc, SceneBuilder

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import torch_check_gradients as tcg  # noqa: E402
from torch_check_gradients import yawed  # noqa: E402

VP = ViewportParams(width=REF_VP.width, height=REF_VP.height, seed=REF_VP.seed)
PARAMS = RenderParams(max_depth=REF_PARAMS.max_depth, mis=REF_PARAMS.mis)
BASE_COLORS = ("table", "channel at 1", "zero")


def _carried(ref):
    return tuple(scene_from_numpy(x if i == 1 else jax.tree_util.tree_map(np.asarray, x), "cpu")
                 for i, x in enumerate(ref))


def _with(scene, base_color, emission, roughness, light_color):
    mats = scene.materials._replace(base_color=base_color, emission=emission, roughness=roughness)
    return scene._replace(materials=mats, lights=scene.lights._replace(color=light_color))


def _base_color(name, bc, V, ones, zeros):
    if name == "channel at 1":
        return V(ones(bc.x), bc.y, bc.z)
    return bc if name == "table" else V(zeros(bc.x), zeros(bc.y), zeros(bc.z))


def _port_loss(scene, meta, cam, vp=VP, params=PARAMS, weights=(1.0, 2.0, 0.5)):
    def loss(base_color, emission, roughness, light_color, origin_z, yaw):
        s = _with(scene, base_color, emission, roughness, light_color)
        r, _ = trace_rows(s, meta, yawed(cam, torch.cos(yaw), torch.sin(yaw), (0.0, 0.0, origin_z)), 0, None, vp, params)
        return torch.mean(r.x * weights[0] + r.y * weights[1] + r.z * weights[2])
    return loss


def _port_params(scene, name="table"):
    """The six parameters as leaves that require grad, and the flat list."""
    m = scene.materials
    bc = _base_color(name, m.base_color, Vec3, torch.ones_like, torch.zeros_like)
    flat = [x.clone().requires_grad_() for x in (*bc, *m.emission, m.roughness, *scene.lights.color,
                                                 torch.tensor(0.0), torch.tensor(0.0))]
    return (Vec3(*flat[0:3]), Vec3(*flat[3:6]), flat[6], Vec3(*flat[7:10]), flat[10], flat[11]), flat


# (BSDF kind, roughness) of the one material, beside the scene's diffuse
ROUGH_KINDS = (("roughDiffuse", 0.5), ("roughMetal", 0.35), ("roughPlastic", 0.3), ("roughDielectric", 0.3))
SMOOTH_KINDS = (("metal", 0.0), ("plastic", 0.0), ("dielectric", 0.0))


@pytest.fixture(scope="module")
def reference():
    """JAX: the loss and its gradients (flat, in ``_port_params``' order)
    for each base colour, and for each BSDF kind of the one material (its
    kind table is an input, so every case runs the one compile)."""
    scene, meta = _scene()
    cam = ref_make_camera(RefRigidTransform(), fov_deg=40.0)

    def loss(p, kind):
        bc, em, ro, lc, oz, yaw = p
        s = _with(scene._replace(materials=scene.materials._replace(bsdf=kind)), bc, em, ro, lc)
        r, _ = ref_trace_rows(s, meta, yawed(cam, jnp.cos(yaw), jnp.sin(yaw), (0.0, 0.0, oz)), jnp.int32(0), None, REF_VP, REF_PARAMS)
        return jnp.mean(r.x + 2.0 * r.y + 0.5 * r.z)

    step = jax.jit(jax.value_and_grad(loss))
    m = scene.materials
    cases = {name: (_base_color(name, m.base_color, RefVec3, jnp.ones_like, jnp.zeros_like), m.bsdf, m.roughness)
             for name in BASE_COLORS}
    for kind, rough in ROUGH_KINDS + SMOOTH_KINDS:
        cases[kind] = (m.base_color, jnp.full_like(m.bsdf, T.BSDF_NAMES[kind]), jnp.full_like(m.roughness, rough))
    out = {}
    for name, (bc, kind, rough) in cases.items():
        value, grads = step((bc, m.emission, rough, scene.lights.color, jnp.float32(0.0), jnp.float32(0.0)), kind)
        out[name] = (float(value), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])
    return out


def _port_case(name, kind=None, rough=None):
    """The port's loss and its 12 gradients for one case of ``reference``."""
    scene, meta = _carried(_scene())
    if kind is not None:
        m = scene.materials
        scene = scene._replace(materials=m._replace(bsdf=torch.full_like(m.bsdf, T.BSDF_NAMES[kind]),
                                                    roughness=torch.full_like(m.roughness, rough)))
    params, flat = _port_params(scene, name)
    loss = _port_loss(scene, meta, make_camera(RigidTransform(), fov_deg=40.0, device="cpu"))(*params)
    return loss.item(), torch.autograd.grad(loss, flat, materialize_grads=True), (scene, meta)


@pytest.mark.parametrize("name", BASE_COLORS)
def test_gradients_match_jax(reference, name):
    loss, grads, (scene, meta) = _port_case(name)
    ref_loss, ref_grads = reference[name]
    if name == "zero":  # nothing the camera sees reflects: the loss and the material gradients are 0
        assert ref_loss == loss == 0.0
    else:
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert len(grads) == len(ref_grads) == 12
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-6, err_msg=f"parameter {i}")
    assert np.isfinite(np.concatenate([g.numpy().ravel() for g in grads])).all()
    if name == "channel at 1":
        # the case pins the tie rule: with torch.clamp's, the gradient of the
        # channel on the bound moves by more than the tolerance
        with mock.patch.object(path_tracer, "clip", torch.clamp):
            params, flat = _port_params(scene, name)
            loss = _port_loss(scene, meta, make_camera(RigidTransform(), fov_deg=40.0, device="cpu"))(*params)
            g = torch.autograd.grad(loss, flat[0])[0].numpy()
        assert not np.allclose(g, ref_grads[0], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("kind,rough", ROUGH_KINDS)
def test_gradients_match_jax_for_each_rough_bsdf(reference, kind, rough):
    """The one material as each rough BSDF: roughness now moves the image
    (GGX, Oren-Nayar).  Within rtol 2e-4 / atol 1e-6 but for roughDielectric,
    whose roughness and yaw gradients differ by 3.0e-4 and 3.4e-4 relative
    (measured at this scene; its loss within 3e-7): the refraction chain's float32
    rounding, held at rtol 1e-3."""
    loss, grads, _ = _port_case("table", kind, rough)
    ref_loss, ref_grads = reference[kind]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    rtol = 1e-3 if kind == "roughDielectric" else 2e-4
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol, atol=1e-6, err_msg=f"parameter {i}")
    assert grads[6].abs().max() > 0  # roughness


@pytest.mark.parametrize("kind,rough", SMOOTH_KINDS)
def test_smooth_bsdf_roughness_gradient_is_zero_where_the_reference_gives_nan(reference, kind, rough):
    """A specular material at roughness 0: the image does not depend on its
    roughness, and the port's gradient is 0.  The reference's is NaN: its
    GGX sample evaluates D(m) at a2 = 1e-10 for every lane, and the cotangent
    of (d*d) = 1e-40 is a denormal that XLA:CPU flushes to 0, so the
    quotient's backward divides by 0 and 0 x inf = NaN reaches the roughness
    (ROADMAP, queue 3).  Every other gradient agrees within rtol 2e-4 / atol
    1e-6."""
    loss, grads, _ = _port_case("table", kind, rough)
    ref_loss, ref_grads = reference[kind]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert np.isnan(ref_grads[6]).all() and float(grads[6].abs().max()) == 0.0
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        if i != 6:
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-6, err_msg=f"parameter {i}")
    assert np.isfinite(np.concatenate([g.numpy().ravel() for g in grads])).all()


def test_clip_passes_half_the_gradient_at_a_bound_like_jnp_clip():
    x = np.array([-1.0, 0.0, 0.25, 1.0, 2.0], np.float32)
    ref = np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0) * jnp.arange(1.0, 6.0)))(jnp.asarray(x)))
    t = torch.as_tensor(x).requires_grad_()
    (clip(t, 0.0, 1.0) * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), ref)
    assert ref[1] == 1.0 and ref[3] == 2.0  # half of 2 and of 4
    with torch.no_grad():
        assert torch.equal(clip(t, 0.0, 1.0), torch.clamp(t, 0.0, 1.0))


def test_the_float64_run_that_holds_the_card_is_float64_and_agrees():
    """The card's gradients are held against the CPU port run in float64
    (``tools/torch_check_gradients.py::check_against_cpu``): that run
    really computes in float64, and at 8^2 its gradients agree with the
    float32 run's within rtol 2e-4 / atol 1e-6, element by element."""
    vp, params = ViewportParams(8, 8, seed=1), RenderParams(max_depth=4, mis=True)
    scene, meta, cam = tcg.test_scene("cpu")
    loss32, g32 = tcg.scene_gradients(scene, meta, cam, vp, params)
    loss64, g64 = tcg.scene_gradients(tcg.as_float64(scene), meta, tcg.as_float64(cam), vp, params)
    assert loss64.dtype == torch.float64 and all(g.dtype == torch.float64 for g in g64)
    assert len(g64) == len(tcg.SCENE_PARAMS)
    np.testing.assert_allclose(float(loss32), float(loss64), rtol=1e-5)
    for name, a, b in zip(tcg.SCENE_PARAMS, g32, g64):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=2e-4, atol=1e-6, err_msg=name)
    assert any(not torch.equal(a.double(), b) for a, b in zip(g32, g64))


# --- the finite-difference checks of tests/test_gradients.py, port only ------


def _fd(f, x, h):
    return (float(f(x + h)) - float(f(x - h))) / (2 * h)


@pytest.mark.parametrize("comp", [0, 1, 2])
def test_grad_matches_finite_difference(comp):
    scene, meta = _carried(_scene())
    loss = _port_loss(scene, meta, make_camera(RigidTransform(), fov_deg=40.0, device="cpu"))
    params, flat = _port_params(scene)
    ad = float(torch.autograd.grad(loss(*params), flat[comp])[0][0])

    def f(v):
        bc = list(scene.materials.base_color)
        bc[comp] = bc[comp].clone()
        bc[comp][0] = v
        with torch.no_grad():
            return loss(Vec3(*bc), *params[1:])

    fd = _fd(f, float(scene.materials.base_color[comp][0]), 1e-3)
    assert np.isfinite(ad)
    np.testing.assert_allclose(ad, fd, rtol=0.05, atol=1e-3, err_msg=f"component {comp}")


def test_grad_emission():
    scene, meta = _carried(_scene())
    loss = _port_loss(scene, meta, make_camera(RigidTransform(), fov_deg=40.0, device="cpu"), weights=(1.0, 0.0, 0.0))
    params, flat = _port_params(scene)
    ad = float(torch.autograd.grad(loss(*params), flat[3])[0][0])

    def f(v):
        em = scene.materials.emission
        x = em.x.clone()
        x[0] = v
        with torch.no_grad():
            return loss(params[0], Vec3(x, em.y, em.z), *params[2:])

    np.testing.assert_allclose(ad, _fd(f, float(scene.materials.emission.x[0]), 1e-3), rtol=0.05, atol=1e-4)


def test_grad_light_color():
    scene, meta = _carried(_scene())
    loss = _port_loss(scene, meta, make_camera(RigidTransform(), fov_deg=40.0, device="cpu"), weights=(1.0, 0.0, 0.0))
    params, flat = _port_params(scene)
    g = torch.autograd.grad(loss(*params), flat[7])[0]
    assert torch.isfinite(g).all()
    assert float(g[0]) > 0.0  # the background light (index 0) lights the red channel


def test_grad_camera_pose_finite():
    scene, meta = _carried(_scene())
    loss = _port_loss(scene, meta, make_camera(RigidTransform(), fov_deg=40.0, device="cpu"), weights=(1.0, 0.0, 0.0))
    params, flat = _port_params(scene)
    assert np.isfinite(float(torch.autograd.grad(loss(*params), flat[10])[0]))


@pytest.mark.parametrize("which", ["origin", "yaw"])
def test_grad_camera_fd(which):
    """``TestCameraGradients``: the silhouette-free scene at depth 2, h = 1e-2,
    rtol 0.1 / atol 1e-3."""
    scene, meta = _carried(_smooth_scene())
    loss = _port_loss(scene, meta, make_camera(RigidTransform(), fov_deg=40.0, device="cpu"),
                      params=RenderParams(max_depth=2, mis=True), weights=(1.0, 1.0, 1.0))
    params, flat = _port_params(scene)
    i = 10 if which == "origin" else 11
    ad = float(torch.autograd.grad(loss(*params), flat[i])[0])

    def f(v):
        p = list(params)
        p[i - 6] = torch.tensor(v)
        with torch.no_grad():
            return loss(*p)

    assert np.isfinite(ad) and ad != 0.0
    np.testing.assert_allclose(ad, _fd(f, 0.0, 1e-2), rtol=0.1, atol=1e-3)


def test_gradient_through_the_shutter_close_pose_matches_jax():
    """Motion blur: at 16^2, depth 3, MIS, strength 1, a camera that moves
    over the shutter; the loss and its gradient with respect to
    ``origin_end`` (each ray's origin is the lerp of the two poses at its
    time) against ``jax.grad``, within this file's rtol 1e-5 for the loss
    and rtol 2e-4 / atol 1e-6 for the gradient."""
    import dataclasses

    from raytracer_tpu.render.renderer import ViewportParams as RefViewportParams

    ref_scene, meta = _scene()
    scene, _ = _carried((ref_scene, meta))
    vp = dict(width=16, height=16, seed=1, motion_blur_strength=1.0)
    end = dict(translation=(0.3, 0.1, -0.2), euler_deg=(0.0, 3.0, 0.0))
    ref_cam = ref_make_camera(RefRigidTransform(), fov_deg=40.0, transform_end=RefRigidTransform(**end))

    def ref_loss(origin_end):
        cam = dataclasses.replace(ref_cam, origin_end=RefVec3(*origin_end))
        r, _ = ref_trace_rows(ref_scene, meta, cam, jnp.int32(0), None, RefViewportParams(**vp),
                              dataclasses.replace(REF_PARAMS, max_depth=3))
        return jnp.mean(r.x + 2.0 * r.y + 0.5 * r.z)

    want, want_grad = jax.jit(jax.value_and_grad(ref_loss))(tuple(ref_cam.origin_end))
    cam = make_camera(RigidTransform(), fov_deg=40.0, transform_end=RigidTransform(**end), device="cpu")
    leaves = [c.clone().requires_grad_() for c in cam.origin_end]
    r, _ = trace_rows(scene, meta, dataclasses.replace(cam, origin_end=Vec3(*leaves)), 0, None, ViewportParams(**vp),
                      RenderParams(max_depth=3, mis=True))
    loss = torch.mean(r.x + 2.0 * r.y + 0.5 * r.z)
    got = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose([float(g) for g in got], [float(g) for g in want_grad], rtol=2e-4, atol=1e-6)
    assert np.abs([float(g) for g in got]).max() > 1e-3


# --- traversal stays detached; every exact mode gives the same gradients ----

MODES = ("wave2", "wave", "bvh", "cluster", "sorted-pallas")


@pytest.fixture(scope="module")
def mesh():
    """``random_mesh_scene(2000)``'s triangles, a rough-metal and a plastic
    material beside the diffuse one, and a point light beside the
    background, so that the camera pose moves the shading too."""
    rng = np.random.default_rng(0)
    b = SceneBuilder()
    mats = [b.add_material(MaterialDesc(bsdf="diffuse", base_color=(0.7, 0.7, 0.7))),
            b.add_material(MaterialDesc(bsdf="roughMetal", base_color=(0.9, 0.6, 0.3), roughness=0.4)),
            b.add_material(MaterialDesc(bsdf="roughPlastic", base_color=(0.2, 0.5, 0.8), roughness=0.3))]
    v = (rng.uniform(-4, 4, (2000, 1, 3)) + [0.0, 0.0, 8.0] + rng.normal(0, 0.25, (2000, 3, 3))).astype(np.float32)
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = np.repeat((n / np.linalg.norm(n, axis=1, keepdims=True))[:, None], 3, axis=1)
    b.add_mesh(v.reshape(-1, 3), np.arange(6000).reshape(-1, 3), n.reshape(-1, 3), None, rng.choice(mats, 2000))
    b.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.7, 0.8, 1.0)))
    b.add_light(LightDesc(kind=T.LIGHT_POINT, color=(20.0, 16.0, 12.0),
                          transform=RigidTransform(translation=(1.0, 2.0, 1.0))))
    scene, meta = b.build("cpu")
    return scene, meta, make_camera(RigidTransform(), fov_deg=50.0, device="cpu")


@pytest.fixture
def mode_restored(monkeypatch):
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    yield
    traverse.set_traversal_mode("auto")


@pytest.mark.parametrize("mode", MODES)
def test_hits_carry_no_graph(mesh, mode_restored, mode):
    """Rays whose origin, direction and limit require grad: the mesh
    engine's t, u, v and attributes carry no graph, closest-hit and
    any-hit, in every mode.  The closest hit on analytic prims keeps its
    graph: its t is differentiable, as in the reference."""
    scene, _, _ = mesh
    rng = np.random.default_rng(4)
    n = 256
    grad = lambda a: Vec3(*(torch.as_tensor(c).requires_grad_() for c in a))
    o = grad(rng.uniform(-2, 2, (3, n)).astype(np.float32))
    d = rng.normal([[0.0], [0.0], [1.0]], 0.2, (3, n)).astype(np.float32)
    d = grad(d / np.linalg.norm(d, axis=0))
    cap = torch.full((n,), 3.0e38).requires_grad_()
    for signed in (cap, torch.where(torch.arange(n) % 2 == 1, -cap, cap)):
        t, tri, u, v, _, attr = traverse._cs_closest(mode, scene.clusters, scene.bvh, scene.tris, o, d, signed)
        assert (tri >= 0).any()
        for x in (t, u, v, *(attr or ())):
            assert x.grad_fn is None and not x.requires_grad
    occ, _ = traverse._cs_occluded(mode, scene.clusters, scene.bvh, scene.tris, o, d, cap * 0 + 9.0)
    assert occ.any() and not occ.requires_grad
    prims, _ = _carried(_scene())
    assert traverse.scene_traverse(prims, o, d).t.grad_fn is not None


def test_gradients_equal_across_exact_modes(mesh, mode_restored):
    """On the 2k-triangle mesh (8^2, depth 3, MIS) the gradients of every
    parameter are the same under wave2, wave, bvh and cluster: the same hits,
    and the shading that follows them is the same code."""
    scene, meta, cam = mesh
    out = {}
    for mode in ("wave2", "wave", "bvh", "cluster"):
        traverse.set_traversal_mode(mode)
        params, flat = _port_params(scene)
        loss = _port_loss(scene, meta, cam, params=RenderParams(max_depth=3, mis=True))(*params)
        out[mode] = (loss.item(), [g.numpy() for g in torch.autograd.grad(loss, flat, materialize_grads=True)])
    first = out["wave2"]
    assert first[0] > 0 and all(np.abs(first[1][i]).max() > 0 for i in (0, 6, 7, 10, 11))
    for mode, (value, grads) in out.items():
        np.testing.assert_allclose(value, first[0], rtol=1e-5, err_msg=mode)
        for i, (g, r) in enumerate(zip(grads, first[1])):
            np.testing.assert_allclose(g, r, rtol=2e-4, atol=1e-6, err_msg=f"{mode} parameter {i}")


def test_viewport_render_records_no_graph(mesh):
    scene, meta, cam = mesh
    params, _ = _port_params(scene)
    s = _with(scene, *params[:4])
    vp = Viewport(s, meta, cam, ViewportParams(8, 8, seed=0), RenderParams(max_depth=2, mis=True), device="cpu")
    vp.render(2)
    assert not vp.film.sum.requires_grad and vp.film.sum.grad_fn is None
    assert vp.radiance().mean() > 0
    r, _ = trace_rows(s, meta, cam, 0, None, VP, PARAMS)  # the differentiable entry point still records
    assert r.x.grad_fn is not None
