"""Per-pixel path replay of the port (``render/path_debug.py``) against the
JAX package's ``debug_pixel_path``, on the CPU.

The Cornell box (carried across from the JAX package) at 32^2, depth 4,
MIS, and the 2k-triangle bench mesh through both scene loaders at 32^2,
depth 1 (the port's wave2 engine on a one-ray window, the JAX package's
``auto`` engine): for several pixels and passes, the same number of
vertices, the same prim, tri and material ids, BSDF events and
termination, and every float of every vertex (ray, hit distance,
position, normal, base colour, throughput, BSDF pdf) within rtol 1e-5 /
atol 1e-6.  Then the reference's own cases (``tests/test_path_debug.py``)
on the port.
"""

import os
import sys

import jax
import numpy as np
import pytest

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.io.scene_loader import load_scene as ref_load_scene
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.render import path_debug as ref_pd
from raytracer_tpu.render.renderer import ViewportParams as RefViewportParams
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import cornell_box as ref_cornell_box, cornell_camera_kw
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.render import path_debug as pd
from raytracer_tpu_torch.render.renderer import ViewportParams
from raytracer_tpu_torch.scene.convert import scene_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import bench_mesh  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FLOATS = ("origin", "direction", "hit_distance", "position", "normal", "base_color", "throughput", "bsdf_pdf")
EXACT = ("depth", "prim_id", "tri_id", "material_id", "bsdf_event_specular")
CASES = {"cornell": [(16, 24, 0), (16, 24, 3), (5, 5, 1), (20, 10, 2), (16, 3, 0), (8, 28, 5)],
         "mesh2k": [(15, 15, 1), (25, 10, 1), (30, 15, 1), (20, 20, 1), (0, 15, 1)]}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    scene, meta = ref_cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    cam = ref_make_camera(RefRigidTransform(**t_kw), **c_kw)
    carry = lambda x: scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")
    saved = bench_mesh.BENCH_DIR
    bench_mesh.BENCH_DIR = str(tmp_path_factory.mktemp("bench"))
    try:
        path = bench_mesh.ensure_scene(2000)
    finally:
        bench_mesh.BENCH_DIR = saved
    return {"cornell": ((scene, meta, cam), (carry(scene), meta, carry(cam)), 4),
            "mesh2k": (ref_load_scene(path), load_scene(path, device="cpu"), 1)}


def assert_same_path(got, want):
    assert got.pixel == want.pixel
    assert got.termination == want.termination
    assert len(got.vertices) == len(want.vertices)
    for a, b in zip(got.vertices, want.vertices):
        for f in EXACT:
            assert getattr(a, f) == getattr(b, f), f
        for f in FLOATS:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=RTOL, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_replay_matches_the_reference(scenes, name):
    ref, port, depth = scenes[name]
    seen = set()
    for x, y, p in CASES[name]:
        want = ref_pd.debug_pixel_path(*ref, x, y, RefViewportParams(32, 32, seed=0),
                                       RefRenderParams(max_depth=depth, mis=True), pass_idx=p)
        got = pd.debug_pixel_path(*port, x, y, ViewportParams(32, 32, seed=0), RenderParams(max_depth=depth, mis=True),
                                  pass_idx=p)
        assert_same_path(got, want)
        seen.add(got.termination)
    # the cases end in more than one way
    assert len(seen) >= 2, seen


def test_records_bounces(scenes):
    _, (scene, meta, cam), _ = scenes["cornell"]
    data = pd.debug_pixel_path(scene, meta, cam, 16, 24, ViewportParams(32, 32, seed=0),
                               RenderParams(max_depth=4, mis=True))
    assert data.pixel == (16, 24)
    assert data.termination in (pd.TERM_HIT_BACKGROUND, pd.TERM_HIT_LIGHT, pd.TERM_DEPTH_EXCEEDED,
                                pd.TERM_RUSSIAN_ROULETTE, pd.TERM_THROUGHPUT_ZERO)
    assert len(data.vertices) >= 1  # an interior pixel hits geometry at least once
    v0 = data.vertices[0]
    assert v0.depth == 0 and v0.hit_distance > 0.0 and v0.prim_id >= 0
    assert max(v0.throughput) == 1.0
    for a, b in zip(data.vertices, data.vertices[1:]):
        assert b.depth == a.depth + 1
        assert max(b.throughput) <= max(a.throughput) * 8.01


def test_deterministic_replay(scenes):
    _, (scene, meta, cam), _ = scenes["cornell"]
    vp, params = ViewportParams(32, 32, seed=0), RenderParams(max_depth=4, mis=True)
    a = pd.debug_pixel_path(scene, meta, cam, 16, 24, vp, params, pass_idx=3)
    b = pd.debug_pixel_path(scene, meta, cam, 16, 24, vp, params, pass_idx=3)
    assert a == b
    c = pd.debug_pixel_path(scene, meta, cam, 16, 24, vp, params, pass_idx=7)
    assert (len(c.vertices) != len(a.vertices)
            or any(va.bsdf_pdf != vc.bsdf_pdf for va, vc in zip(a.vertices, c.vertices)))
