"""The debug renderer, the traversal-cost estimate and the path tracer's
traversal counters of the port against the JAX package's.

Scenes: ``random_mesh_scene(2000)`` (one baked mesh) and the ``pyramids``
scene of ``tests/test_torch_instancing.py`` (a baked grid, three instances
of a pyramid, a sphere), built by each package's own builder.  On the CPU
the reference traverses with its ``wave`` engine and the port with wave2
(its kernel's twin): both exact, so hit triangles agree.

Held: ``scene_traversal_cost`` box and triangle counts equal on every ray
(integers); ``render_debug`` in all 14 modes, ``TriangleID`` equal bit for
bit and the other modes within atol 5e-5 / rtol 1e-5 per channel (measured
worst 1.3e-5, CameraLight on an instanced pyramid: the two engines'
barycentrics differ in their last bits, as ``tests/test_torch_wave.py``
holds u, v at atol 1e-4; 4.1e-7 on the baked mesh);
``RenderParams.count_traversal``'s totals and the ray counters equal; with
it off, the totals are 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from tests.test_torch_instancing import _fill
from raytracer_tpu.integrators import debug as ref_debug
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.ops import traverse as ref_traverse
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.render.renderer import pixel_grid as ref_pixel_grid
from raytracer_tpu.sampler.sampler import make_stream as ref_make_stream
from raytracer_tpu.scene import build as ref_build
from raytracer_tpu.scene.camera import generate_rays as ref_generate_rays, make_camera as ref_make_camera
from raytracer_tpu.scene.presets import random_mesh_scene as ref_random_mesh_scene
from raytracer_tpu_torch.integrators import debug
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams, pixel_grid
from raytracer_tpu_torch.sampler.sampler import make_stream
from raytracer_tpu_torch.scene import build
from raytracer_tpu_torch.scene.camera import generate_rays, make_camera
from raytracer_tpu_torch.scene.presets import random_mesh_scene

SIZE = 24
CAMS = {"mesh": dict(translation=(0.0, 0.0, -4.0)), "pyramids": dict(translation=(0.0, 1.0, -7.0))}
FOV = {"mesh": 55.0, "pyramids": 45.0}


def _scene(name):
    """((ref scene, meta, cam), (port scene, meta, cam))."""
    if name == "mesh":
        ref, got = ref_random_mesh_scene(2000, seed=0), random_mesh_scene(2000, seed=0, device="cpu")
    else:
        rb, pb = ref_build.SceneBuilder(), build.SceneBuilder()
        _fill(rb, ref_build, RefRigidTransform, "pyramids")
        _fill(pb, build, RigidTransform, "pyramids")
        ref, got = rb.build(), pb.build("cpu")
    rc = ref_make_camera(RefRigidTransform(**CAMS[name]), fov_deg=FOV[name])
    pc = make_camera(RigidTransform(**CAMS[name]), fov_deg=FOV[name], device="cpu")
    return (*ref, rc), (*got, pc)


@pytest.fixture(scope="module")
def scenes():
    return {name: _scene(name) for name in ("mesh", "pyramids")}


def _rays(ref, got, size=SIZE):
    cx, cy, pids = ref_pixel_grid(size, size)
    ref_rays, _ = ref_generate_rays(ref[2], cx, cy, ref_make_stream(pids, jnp.int32(0), seed=0))
    cx, cy, pids = pixel_grid(size, size, device="cpu")
    rays, _ = generate_rays(got[2], cx, cy, make_stream(pids.to(torch.int64), 0, seed=0))
    return ref_rays, rays


@pytest.mark.parametrize("name", ["mesh", "pyramids"])
def test_traversal_cost_matches_reference(scenes, name):
    ref, got = scenes[name]
    ref_rays, rays = _rays(ref, got)
    rb, rt = ref_traverse.scene_traversal_cost(ref[0], ref_rays.origin, ref_rays.dir)
    b, t = traverse.scene_traversal_cost(got[0], rays.origin, rays.dir)
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
    assert float(t.max()) > 0 and float(t.min()) < float(t.max())
    if name == "pyramids":
        assert got[0].instances is not None and got[0].instances.count == 3


def test_traversal_cost_blocks_change_nothing(scenes, monkeypatch):
    """Rays go through the slab test in blocks of COST_BLOCK_PAIRS // C."""
    _, got = scenes["pyramids"]
    _, rays = _rays(*scenes["pyramids"])
    whole = traverse.scene_traversal_cost(got[0], rays.origin, rays.dir)
    monkeypatch.setattr(traverse, "COST_BLOCK_PAIRS", 1000)
    blocked = traverse.scene_traversal_cost(got[0], rays.origin, rays.dir)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocked))


@pytest.mark.parametrize("name", ["mesh", "pyramids"])
def test_every_debug_mode_matches_reference(scenes, name):
    ref, got = scenes[name]
    ref_rays, rays = _rays(ref, got)
    assert len(debug.ALL_MODES) == len(ref_debug.ALL_MODES) == 14 and debug.ALL_MODES == ref_debug.ALL_MODES
    for mode in debug.ALL_MODES:
        a = np.stack([np.asarray(c) for c in ref_debug.render_debug(ref[0], ref[1], ref_rays, mode)], -1)
        b = np.stack([c.numpy() for c in debug.render_debug(got[0], got[1], rays, mode)], -1)
        assert b.shape == (SIZE * SIZE, 3) and np.isfinite(b).all(), mode
        if mode == debug.MODE_TRIANGLE_ID:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, atol=5e-5, rtol=1e-5, err_msg=mode)
    with pytest.raises(ValueError, match="unknown debug mode"):
        debug.render_debug(got[0], got[1], rays, "Albedo")


@pytest.mark.parametrize("count", [True, False])
def test_count_traversal_counters_match_reference(scenes, count):
    ref, got = scenes["pyramids"]
    kw = dict(max_depth=2, mis=True, count_traversal=count)
    rv = RefViewport(*ref, RefViewportParams(16, 16, seed=0), RefRenderParams(**kw))
    pv = Viewport(*got, ViewportParams(16, 16, seed=0), RenderParams(**kw), device="cpu")
    rp, pp = rv.render(2).progress(), pv.render(2).progress()
    assert set(pp) == set(rp)
    for key in ("total_rays", "total_shadow_rays", "total_box_tests", "total_tri_tests"):
        assert pp[key] == rp[key], (key, pp[key], rp[key])
    assert (pp["total_tri_tests"] > 0) == count and (pp["total_box_tests"] > 0) == count
