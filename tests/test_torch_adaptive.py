"""Adaptive rendering of the port (``render/adaptive.py``) and
``trace_pixels`` against the JAX package's, on the CPU.

- the reference's four cases (``tests/test_adaptive.py``) on the port; its
  agreement with the uniform ``Viewport`` is held bit for bit here (the
  reference allows atol 1e-5);
- the port's ``AdaptiveViewport`` against the JAX package's on the Cornell
  box at 32^2, depth 2, six passes with two adaptations: the block lists
  (position, size, error) and ``progress()`` equal, ``total_rays`` (which
  counts the padded lanes) too, the buffers within the render tolerance of
  ``tests/test_torch_render.py`` (rtol 1e-3 / atol 1e-4) but at two pinned
  pixels from the fifth pass on, where the packages' plain renders differ;
- the JAX package's own buffers fed to the port's ``_update_blocks`` give
  its block list exactly: the bookkeeping is the same numpy float32 code;
- ``trace_pixels`` on a shuffled set of pixels (a wavefront in another
  order, padded with pixel 0) gives each pixel the radiance ``trace_rows``
  gives it, bit for bit, on the Cornell box and on the 2k-triangle bench
  mesh under the wave2 engine.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.render import adaptive as ref_adaptive
from raytracer_tpu.render.renderer import ViewportParams as RefViewportParams
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import cornell_box as ref_cornell_box, cornell_camera_kw
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.render.adaptive import AdaptiveSettings, AdaptiveViewport, Block, _pad_to_bucket
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams, trace_pixels, trace_rows
from raytracer_tpu_torch.sampler.sampler import halton_frame_vector
from raytracer_tpu_torch.scene import types as T
from raytracer_tpu_torch.scene.build import LightDesc, SceneBuilder
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.convert import scene_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import bench_mesh  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4
# pixels (row, column) whose pass-4 radiance differs between the packages'
# plain ``trace_rows`` (eager or jitted JAX alike) at 32^2, depth 2: (5, 12),
# (5, 15) and (5, 21), by up to 1.9e-4 on values of ~7e-4 next to the light
# (a last-bit sensitivity of the existing render, not of the adaptive
# renderer); in the buffers from pass 4 on, (5, 15) stays within the
# tolerance and the other two do not
APART_FROM_PASS_4 = [(5, 12), (5, 21)]
# thresholds at which the 32^2 box, after 2 and 4 passes, drops some blocks,
# splits others and keeps the rest
PARITY = dict(num_initial_passes=2, adaptation_period=2, convergence_threshold=0.15,
              subdivision_threshold=0.6, max_block_size=16, min_block_size=4)


def _simple_setup(width=32, height=32):
    """Flat-background scene: converges essentially at once."""
    b = SceneBuilder()
    b.default_material_id()
    b.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.25, 0.5, 0.75)))
    scene, meta = b.build("cpu")
    return scene, meta, make_camera(RigidTransform(), fov_deg=60.0, aspect=width / height, device="cpu")


def _cornell():
    """The reference's Cornell box and its carried copy: (ref, port) triples."""
    scene, meta = ref_cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    cam = ref_make_camera(RefRigidTransform(**t_kw), **c_kw)
    carry = lambda x: scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")
    return (scene, meta, cam), (carry(scene), meta, carry(cam))


def _blocks(bs):
    return [(b.y0, b.x0, b.h, b.w, b.error) for b in bs]


class TestAdaptive:
    def test_flat_scene_converges_and_stops(self):
        scene, meta, cam = _simple_setup()
        av = AdaptiveViewport(scene, meta, cam, ViewportParams(width=32, height=32, seed=0),
                              RenderParams(max_depth=2, mis=True),
                              AdaptiveSettings(num_initial_passes=2, convergence_threshold=0.01,
                                               max_block_size=16, min_block_size=4), device="cpu")
        av.render(8)
        p = av.progress()
        assert p["active_blocks"] == 0 and p["active_pixels"] == 0
        assert p["converged_fraction"] == 1.0
        np.testing.assert_allclose(av.radiance().reshape(-1, 3).mean(0), (0.25, 0.5, 0.75), atol=0.01)
        rays_before = p["total_rays"]
        av.render(4)  # further passes are free no-ops
        assert av.progress()["total_rays"] == rays_before
        assert av.passes == 12
        assert av.image().shape == (32, 32, 3) and av.image().dtype == np.uint8

    def test_agrees_with_uniform_viewport(self):
        _, (scene, meta, cam) = _cornell()
        vp_params = ViewportParams(width=24, height=24, seed=0)
        params = RenderParams(max_depth=3, mis=True)
        uniform = Viewport(scene, meta, cam, vp_params, params, device="cpu").render(16)
        adaptive = AdaptiveViewport(scene, meta, cam, vp_params, params,
                                    AdaptiveSettings(num_initial_passes=16), device="cpu").render(16)
        # the same pixel ids and pass keys: the same radiance, bit for bit
        np.testing.assert_array_equal(adaptive.radiance(), uniform.radiance())
        # 576 pixels padded to a 1,024-lane wavefront: its rays all count
        assert adaptive.progress()["total_rays"] >= 16 * 1024 > uniform.progress()["total_rays"] / 2

    def test_subdivision_splits_blocks(self):
        _, (scene, meta, cam) = _cornell()
        av = AdaptiveViewport(scene, meta, cam, ViewportParams(width=32, height=32, seed=0),
                              RenderParams(max_depth=4, mis=True),
                              AdaptiveSettings(num_initial_passes=2, adaptation_period=2,
                                               convergence_threshold=1e-9,  # never drop
                                               subdivision_threshold=1e9,  # always split
                                               max_block_size=32, min_block_size=8), device="cpu")
        assert len(av.blocks) == 1
        av.render(2)
        assert len(av.blocks) == 2  # split once
        av.render(2)
        assert len(av.blocks) == 4

    def test_error_decreases_with_passes(self):
        _, (scene, meta, cam) = _cornell()
        av = AdaptiveViewport(scene, meta, cam, ViewportParams(width=24, height=24, seed=0),
                              RenderParams(max_depth=4, mis=True),
                              AdaptiveSettings(num_initial_passes=2, adaptation_period=2, convergence_threshold=0.0),
                              device="cpu")
        av.render(4)
        e4 = av.progress()["average_error"]
        av.render(20)
        assert av.progress()["average_error"] < e4


def test_pad_to_bucket_is_the_reference():
    for n in (1, 255, 256, 257, 576, 1024, 1025, 262144, 300000):
        assert _pad_to_bucket(n) == ref_adaptive._pad_to_bucket(n)


@pytest.fixture(scope="module")
def both_runs():
    """The JAX and the port AdaptiveViewport after each of 6 passes:
    [(blocks, progress, buffers)] per package."""
    (rs, rm, rc), (ps, pm, pc) = _cornell()
    ref = ref_adaptive.AdaptiveViewport(rs, rm, rc, RefViewportParams(32, 32, seed=0),
                                        RefRenderParams(max_depth=2, mis=True), ref_adaptive.AdaptiveSettings(**PARITY))
    port = AdaptiveViewport(ps, pm, pc, ViewportParams(32, 32, seed=0), RenderParams(max_depth=2, mis=True),
                            AdaptiveSettings(**PARITY), device="cpu")
    runs = {"ref": [], "port": []}
    for _ in range(6):
        for name, av in (("ref", ref), ("port", port)):
            av.render(1)
            bufs = [np.asarray(x) if name == "ref" else x.numpy() for x in (av.sum, av.sec, av.weight, av.sec_weight)]
            runs[name].append((_blocks(av.blocks), av.progress(), bufs))
    return runs, ref


def test_adaptive_viewport_matches_the_reference(both_runs):
    runs, _ = both_runs
    counts = [len(blocks) for blocks, _, _ in runs["ref"]]
    assert counts[0] == 4 and len(set(counts)) > 2  # the thresholds split and drop blocks
    for (rb, rp, rbuf), (pb, pp, pbuf) in zip(runs["ref"], runs["port"]):
        assert [b[:4] for b in pb] == [b[:4] for b in rb]
        np.testing.assert_allclose([b[4] for b in pb], [b[4] for b in rb], rtol=1e-3)
        assert {k: v for k, v in pp.items() if k not in ("average_error", "error_db")} == \
            {k: v for k, v in rp.items() if k not in ("average_error", "error_db")}
        np.testing.assert_allclose(pp["average_error"], rp["average_error"], rtol=1e-3)
    for i, ((_, _, rbuf), (_, _, pbuf)) in enumerate(zip(runs["ref"], runs["port"])):
        apart = np.zeros((32, 32), bool)
        for a, b in zip(pbuf, rbuf):
            far = ~np.isclose(a, b, rtol=RTOL, atol=ATOL)
            apart |= far.any(-1) if far.ndim == 3 else far
        assert [tuple(int(j) for j in ij) for ij in np.argwhere(apart)] == (APART_FROM_PASS_4 if i >= 4 else [])


def test_update_blocks_on_the_reference_buffers_is_the_reference_list(both_runs):
    runs, _ = both_runs
    _, (ps, pm, pc) = _cornell()
    for i in (1, 3, 5):  # the passes after which each package adapted
        before, _, _ = runs["ref"][i - 1]
        after, progress, bufs = runs["ref"][i]
        av = AdaptiveViewport(ps, pm, pc, ViewportParams(32, 32, seed=0), RenderParams(max_depth=2, mis=True),
                              AdaptiveSettings(**PARITY), device="cpu")
        av.sum, av.sec, av.weight, av.sec_weight = (torch.as_tensor(b.copy()) for b in bufs)
        av.blocks = [Block(*b) for b in before]
        av.passes = i + 1
        av._update_blocks()
        assert _blocks(av.blocks) == after
        assert av.converged_fraction == progress["converged_fraction"]
        assert av.average_error == progress["average_error"]


def _shuffled_pixels(n_pixels, seed=5):
    ids = np.random.default_rng(seed).permutation(n_pixels)[: n_pixels * 3 // 4]
    return np.concatenate([ids, np.zeros(256 - len(ids) % 256, np.int64)])  # padded with pixel 0


@pytest.mark.parametrize("scene_name", ["cornell", "mesh2k"])
def test_trace_pixels_is_trace_rows_in_another_order(scene_name, tmp_path, monkeypatch):
    if scene_name == "cornell":
        _, (scene, meta, cam) = _cornell()
    else:
        monkeypatch.setattr(bench_mesh, "BENCH_DIR", str(tmp_path))
        scene, meta, cam = load_scene(bench_mesh.ensure_scene(2000), device="cpu")
    vp, params = ViewportParams(16, 16, seed=0), RenderParams(max_depth=3, mis=True)
    halton = torch.as_tensor(halton_frame_vector(1))
    whole, _ = trace_rows(scene, meta, cam, 1, halton, vp, params)
    ids = _shuffled_pixels(vp.width * vp.height)
    got, counters = trace_pixels(scene, meta, cam, torch.as_tensor(ids), 1, halton, vp, params)
    assert float(counters.num_rays) >= len(ids)
    for a, b in zip(got, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy()[ids])
