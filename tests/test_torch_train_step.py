"""Port parity: ``parallel/mesh.py::train_step``, the one-device body of the
JAX package's ``train_step_sharded``, against ``train_step_sharded`` on a
one-device mesh, on the CPU.

The scene is ``random_mesh_scene(2000)`` (carried across with
``scene/convert.py``), the camera at the origin looking down +z, 8^2,
depth 3, MIS, pass 0, a seeded random target; both packages trace the mesh
under ``wave`` (the JAX package's ``auto`` on the CPU).  One JAX compile.
The loss is held within rtol 1e-5, the gradients of ``base_color``,
``emission`` and ``roughness`` within rtol 2e-4 / atol 1e-6
(``tests/test_parallel.py``'s bounds).  Then, port only: the caller's tables
gain no ``.grad``; a target rendered from the same tables gives a zero loss
and zero gradients; and plain gradient descent on ``base_color`` lowers the
loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.parallel.mesh import make_mesh, train_step_sharded
from raytracer_tpu.render.renderer import ViewportParams as RefViewportParams
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import random_mesh_scene
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.parallel.mesh import train_step
from raytracer_tpu_torch.render.renderer import ViewportParams, trace_rows
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.convert import scene_from_numpy

SIZE = 8
DEPTH = 3


@pytest.fixture(scope="module")
def scenes():
    ref = random_mesh_scene(2000)
    got = tuple(scene_from_numpy(x if i == 1 else jax.tree_util.tree_map(np.asarray, x), "cpu")
                for i, x in enumerate(ref))
    return ref, got


@pytest.fixture
def wave_mode(monkeypatch):
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    traverse.set_traversal_mode("wave")
    yield
    traverse.set_traversal_mode("auto")


def _target():
    return np.random.default_rng(3).random((SIZE, SIZE, 3)).astype(np.float32) * 0.5


def _cam():
    return make_camera(RigidTransform(), fov_deg=50.0, device="cpu")


def _step(scene, meta, target, pass_idx=0):
    return train_step(scene, meta, _cam(), torch.as_tensor(target), pass_idx, ViewportParams(SIZE, SIZE, seed=0),
                      RenderParams(max_depth=DEPTH, mis=True))


def _flat(grads):
    return [*grads[0], *grads[1], grads[2]]


def test_train_step_matches_reference(scenes, wave_mode):
    (ref_scene, ref_meta), (scene, meta) = scenes
    cam = ref_make_camera(RefRigidTransform(), fov_deg=50.0)
    vp, params = RefViewportParams(SIZE, SIZE, seed=0), RefRenderParams(max_depth=DEPTH, mis=True)
    mesh = make_mesh(jax.devices()[:1])
    step = jax.jit(lambda s, t: train_step_sharded(s, ref_meta, cam, t, jnp.int32(0), vp, params, mesh))
    ref_loss, ref_grads = step(ref_scene, jnp.asarray(_target()))
    loss, grads = _step(scene, meta, _target())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref_flat = jax.tree_util.tree_leaves(ref_grads)
    assert len(ref_flat) == len(_flat(grads)) == 7
    for i, (g, r) in enumerate(zip(_flat(grads), ref_flat)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=1e-6, err_msg=f"table {i}")
    assert float(loss) > 0 and np.abs(grads[0].x.numpy()).max() > 0


def test_train_step_leaves_the_callers_tables_alone(scenes, wave_mode):
    (_, _), (scene, meta) = scenes
    loss, grads = _step(scene, meta, _target())
    m = scene.materials
    for t in (*m.base_color, *m.emission, m.roughness):
        assert not t.requires_grad and t.grad is None
    assert not loss.requires_grad and all(g.grad_fn is None for g in _flat(grads))
    assert torch.isfinite(torch.stack([g.sum() for g in _flat(grads)])).all()


def test_train_step_at_its_own_render_is_stationary(scenes, wave_mode):
    """A target rendered from the same tables at the same pass: loss 0 and
    every gradient 0 (the samples are the same)."""
    (_, _), (scene, meta) = scenes
    with torch.no_grad():
        r, _ = trace_rows(scene, meta, _cam(), 2, None, ViewportParams(SIZE, SIZE, seed=0),
                          RenderParams(max_depth=DEPTH, mis=True))
    target = torch.stack([c.reshape(SIZE, SIZE) for c in r], -1).numpy()
    loss, grads = _step(scene, meta, target, pass_idx=2)
    assert float(loss) == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in _flat(grads))


def test_gradient_descent_on_base_color_lowers_the_loss(scenes, wave_mode):
    """The target rendered with the true tables; start from base_color
    halved; three steps of plain gradient descent."""
    (_, _), (scene, meta) = scenes
    with torch.no_grad():
        r, _ = trace_rows(scene, meta, _cam(), 0, None, ViewportParams(SIZE, SIZE, seed=0),
                          RenderParams(max_depth=DEPTH, mis=True))
    target = torch.stack([c.reshape(SIZE, SIZE) for c in r], -1).numpy()
    m = scene.materials
    bc = Vec3(*(c * 0.5 for c in m.base_color))
    losses = []
    for _ in range(3):
        s = scene._replace(materials=m._replace(base_color=bc))
        loss, (g_bc, _, _) = _step(s, meta, target)
        losses.append(float(loss))
        bc = Vec3(*(c - 2.0 * g for c, g in zip(bc, g_bc)))
    assert losses[-1] < losses[0] and all(np.isfinite(losses)), losses
