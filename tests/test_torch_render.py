"""The slice as a whole: the port's Viewport against the JAX Viewport.

MIS path tracer, depth 6, one pass, seed 0, at 32^2, on the analytic
Cornell box and on the 2k-triangle bench mesh loaded through both scene
loaders.  On the CPU the JAX side resolves its traversal to the exact
``wave`` engine and the port runs wave2 (with its kernel's twin): tri ids
may differ only on ties, and a path may diverge after one.

Measured on this slice (PR 1): ray counters equal, every pixel within
atol 1e-4 / rtol 1e-3 (max |diff| ~1.3e-5), means equal to 1e-7.  The
asserted bounds are tighter than the ISSUE's first ones (0.5% counters,
98% pixels, 1% mean) but keep room for a tie or two:
counters within 0.1%, >= 99.5% of pixels within atol 1e-4 / rtol 1e-3,
mean radiance within 0.1%, all values finite.
"""

import os
import sys

import numpy as np
import pytest

from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.io.scene_loader import load_scene as ref_load_scene
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import cornell_box as ref_cornell_box
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3 as Vec3t
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import bench_mesh  # noqa: E402

SIZE = 32


def _cornell():
    t_kw, c_kw = cornell_camera_kw()
    ref = (*ref_cornell_box(), ref_make_camera(RefRigidTransform(**t_kw), **c_kw))
    got = (*cornell_box(device="cpu"), make_camera(RigidTransform(**t_kw), **c_kw, device="cpu"))
    return ref, got


def _bench_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_mesh, "BENCH_DIR", str(tmp_path))
    path = bench_mesh.ensure_scene(2000)
    return ref_load_scene(path), load_scene(path, device="cpu")


@pytest.mark.parametrize("scene_name", ["cornell", "mesh2k"])
def test_viewport_matches_reference(scene_name, tmp_path, monkeypatch):
    ref, got = _cornell() if scene_name == "cornell" else _bench_mesh(tmp_path, monkeypatch)
    rv = RefViewport(*ref, RefViewportParams(SIZE, SIZE, seed=0), RefRenderParams(max_depth=6, mis=True))
    pv = Viewport(*got, ViewportParams(SIZE, SIZE, seed=0), RenderParams(max_depth=6, mis=True), device="cpu")
    a = rv.render(1).radiance()
    b = pv.render(1).radiance()
    assert b.shape == a.shape == (SIZE, SIZE, 3)
    assert np.isfinite(b).all()
    rp, pp = rv.progress(), pv.progress()
    for key in ("total_rays", "total_shadow_rays"):
        assert abs(pp[key] - rp[key]) <= 1e-3 * rp[key], (key, pp[key], rp[key])
    assert pp["passes_finished"] == 1 and pp["total_traversal_overflow"] == 0
    close = np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(b.mean() - a.mean()) <= 1e-3 * abs(a.mean())
    assert b.mean() > 0


def test_viewport_accumulates_passes_like_reference():
    ref, got = _cornell()
    rv = RefViewport(*ref, RefViewportParams(16, 16, seed=3), RefRenderParams(max_depth=3, mis=False))
    pv = Viewport(*got, ViewportParams(16, 16, seed=3), RenderParams(max_depth=3, mis=False), device="cpu")
    a = rv.render(2).render(1).radiance()
    b = pv.render(2).render(1).radiance()
    assert pv.progress()["passes_finished"] == 3
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)
    assert pv.progress()["total_rays"] == rv.progress()["total_rays"]


def test_all_lights_strategy_matches_reference(tmp_path, monkeypatch):
    """'all'-strategy NEE over the mesh's two lights traces its own shadow
    queries (scene_occluded -> wave2_any_hit) instead of fusing them."""
    ref, got = _bench_mesh(tmp_path, monkeypatch)
    kw = dict(max_depth=3, mis=True, light_strategy="all")
    rv = RefViewport(*ref, RefViewportParams(16, 16, seed=1), RefRenderParams(**kw))
    pv = Viewport(*got, ViewportParams(16, 16, seed=1), RenderParams(**kw), device="cpu")
    a = rv.render(1).radiance()
    b = pv.render(1).radiance()
    assert pv.progress()["total_shadow_rays"] == rv.progress()["total_shadow_rays"] > 0
    assert np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1).mean() >= 0.995


def test_viewport_needs_scene_on_its_device():
    _, got = _cornell()
    with pytest.raises(ValueError, match="must live on"):
        Viewport(*got, device="meta")


# --- the traversal mode dispatch and the renders under the other modes ------

from unittest import mock  # noqa: E402

import jax  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.ops import pallas_traverse as ref_pallas_traverse  # noqa: E402
from raytracer_tpu.ops import traverse as ref_traverse  # noqa: E402
from raytracer_tpu_torch.ops import traverse  # noqa: E402


@pytest.fixture
def restore_modes(monkeypatch):
    """Both packages back to 'auto' afterwards; the JAX package reads its
    mode while it traces, so its compiled renders are dropped too."""
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    yield
    traverse.set_traversal_mode("auto")
    ref_traverse.set_traversal_mode("auto")
    jax.clear_caches()


def test_traversal_mode_selection(restore_modes, monkeypatch):
    assert traverse.get_traversal_mode() == "auto" and traverse._resolved_mode() == "wave2"
    with pytest.raises(ValueError, match="not in"):
        traverse.set_traversal_mode("sorted_pallas")  # a typo raises
    assert traverse.get_traversal_mode() == "auto"
    for mode in ("wave2", "wave", "sorted-pallas", "cluster", "null"):
        traverse.set_traversal_mode(mode)
        assert traverse.get_traversal_mode() == mode and traverse._resolved_mode() == mode
    assert traverse._VALID_MODES == ref_traverse._VALID_MODES
    # the environment overrides, through the same validation
    monkeypatch.setenv("RT_TRAVERSAL_MODE", "cluster")
    traverse.set_traversal_mode("wave2")
    assert traverse._resolved_mode() == "cluster"
    monkeypatch.setenv("RT_TRAVERSAL_MODE", "clutser")
    with pytest.raises(ValueError, match="RT_TRAVERSAL_MODE"):
        traverse._resolved_mode()


@pytest.mark.parametrize("mode", ["wave", "bvh"])
@pytest.mark.parametrize("how", ["set", "env"])
def test_wave_and_bvh_render_through_their_own_engines_and_neither_becomes_another(
        restore_modes, monkeypatch, tmp_path, mode, how):
    """``wave`` renders through the binned-wavefront engine and ``bvh``
    through the skip-link walk; neither reaches wave2's engine, whether the
    mode is set or comes through the environment."""
    _, got = _bench_mesh(tmp_path, monkeypatch)
    if how == "set":
        traverse.set_traversal_mode(mode)
    else:
        monkeypatch.setenv("RT_TRAVERSAL_MODE", mode)
    pv = Viewport(*got, ViewportParams(8, 8, seed=0), RenderParams(max_depth=2, mis=True), device="cpu")
    engine = {"wave": "wave_closest_hit", "bvh": "bvh_closest_hit"}[mode]
    calls = {engine: 0, "wave2_closest_hit": 0, "mt_chunks": 0}
    count = lambda name, real: lambda *a, **k: (calls.__setitem__(name, calls[name] + 1), real(*a, **k))[1]
    from raytracer_tpu_torch.ops import wave2_traverse

    with mock.patch.object(traverse, engine, count(engine, getattr(traverse, engine))), \
            mock.patch.object(traverse, "wave2_closest_hit", count("wave2_closest_hit", traverse.wave2_closest_hit)), \
            mock.patch.object(wave2_traverse, "mt_chunks", count("mt_chunks", wave2_traverse.mt_chunks)):
        rad = pv.render(1).radiance()
    assert calls[engine] > 0 and calls["wave2_closest_hit"] == calls["mt_chunks"] == 0, calls
    assert np.isfinite(rad).all() and rad.mean() > 0


def test_each_mode_reaches_its_own_engine(restore_modes, tmp_path, monkeypatch):
    """No mode silently becomes another: each one's mesh queries go to its
    own engine and to no other."""
    _, got = _bench_mesh(tmp_path, monkeypatch)
    engines = {"wave2": "wave2_closest_hit", "sorted-pallas": "pallas_sorted_closest_hit",
               "cluster": "cluster_closest_hit", "bvh": "bvh_closest_hit", "wave": "wave_closest_hit"}
    for mode in ("auto", "wave2", "sorted-pallas", "cluster", "bvh", "wave", "null"):
        calls = {name: 0 for name in engines.values()}
        with mock.patch.multiple(traverse, **{
            name: (lambda real, name: lambda *a, **k: (calls.__setitem__(name, calls[name] + 1), real(*a, **k))[1])(
                getattr(traverse, name), name) for name in engines.values()}):
            traverse.set_traversal_mode(mode)
            pv = Viewport(*got, ViewportParams(8, 8, seed=0), RenderParams(max_depth=2, mis=True), device="cpu")
            rad = pv.render(1).radiance()
        want = engines.get("wave2" if mode == "auto" else mode)
        assert [n for n, c in calls.items() if c] == ([want] if want else []), (mode, calls)
        assert np.isfinite(rad).all()


def test_null_mode_skips_the_mesh(restore_modes, tmp_path, monkeypatch):
    _, got = _bench_mesh(tmp_path, monkeypatch)
    scene = got[0]
    traverse.set_traversal_mode("null")
    pv = Viewport(*got, ViewportParams(8, 8, seed=0), RenderParams(max_depth=2, mis=True), device="cpu")
    pv.render(1)
    assert pv.progress()["total_traversal_overflow"] == 0
    n = 64
    o = Vec3t(torch.zeros(n), torch.full((n,), 5.0), torch.zeros(n))
    d = Vec3t(torch.zeros(n), torch.full((n,), -1.0), torch.zeros(n))
    hits = traverse.scene_traverse(scene, o, d)
    assert (hits.tri_id < 0).all() and hits.attr is None
    traverse.set_traversal_mode("wave2")
    assert (traverse.scene_traverse(scene, o, d).tri_id >= 0).all()  # straight down onto the heightfield


@pytest.mark.parametrize("mode", ["sorted-pallas", "cluster", "bvh"])
def test_viewport_matches_reference_under_mode(restore_modes, tmp_path, monkeypatch, mode):
    """32^2, depth 6, MIS render of the 2k-triangle mesh scene with both
    packages in the same traversal mode (the JAX package's stream kernel in
    Pallas interpret mode; under ``bvh`` both run the same skip-link walk).
    Same tolerances as the default-mode render; the overflow counters of the
    two packages must be equal, not zero."""
    ref, got = _bench_mesh(tmp_path, monkeypatch)
    jax.clear_caches()
    ref_traverse.set_traversal_mode(mode)
    traverse.set_traversal_mode(mode)
    real = ref_pallas_traverse.pl.pallas_call
    with mock.patch.object(ref_pallas_traverse.pl, "pallas_call",
                           lambda kernel, **kw: real(kernel, interpret=True, **kw)):
        rv = RefViewport(*ref, RefViewportParams(SIZE, SIZE, seed=0), RefRenderParams(max_depth=6, mis=True))
        a = rv.render(1).radiance()
    pv = Viewport(*got, ViewportParams(SIZE, SIZE, seed=0), RenderParams(max_depth=6, mis=True), device="cpu")
    b = pv.render(1).radiance()
    assert np.isfinite(b).all() and b.mean() > 0
    rp, pp = rv.progress(), pv.progress()
    for key in ("total_rays", "total_shadow_rays"):
        assert abs(pp[key] - rp[key]) <= 1e-3 * rp[key], (key, pp[key], rp[key])
    assert pp["total_traversal_overflow"] == rp["total_traversal_overflow"]
    close = np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(b.mean() - a.mean()) <= 1e-3 * abs(a.mean())
