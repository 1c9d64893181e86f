"""The program's own spans and sync counts (``raytracer_tpu_torch/utils/
profiler.py``) held against the card; every test here needs one and skips
without it.

- Under ``torch.cuda.set_sync_debug_mode("warn")``, a Cornell pass with its
  displayed image and a pass of a small mesh scene raise exactly as many
  synchronizing-call warnings as the program counts, site by site: each
  warning falls inside a ``host_sync`` span of the site it is counted
  under, and none outside one.
- In a profiled pass of the hall, at least 99% of the device time is
  launched inside some program span; the ``wave2.*`` spans hold at least
  95% of the traversal's, and the five stage spans at least 90%.
"""

import collections
import warnings

import pytest
import torch

from harness import cells, scenes
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.presets import random_mesh_scene
from raytracer_tpu_torch.utils import profiler

PARAMS = RenderParams(max_depth=6, mis=True)
STAGES = ("wave2.extract", "wave2.join", "wave2.mt", "wave2.select", "wave2.compact")


def cell_viewport(name, size, device):
    cell = cells.find(name)
    scene, meta, cam = load_scene(scenes.scene_path(cell.config_name, cell.config), device=device)
    return Viewport(scene, meta, cam, ViewportParams(size, size, seed=4500000001), PARAMS, device=device)


def sync_warnings(unit) -> collections.Counter:
    """``unit()`` with tracing on and the sync debug mode at "warn": the
    warnings by the site of the ``host_sync`` span open at each, and under
    ``profiler.OUTSIDE`` those raised outside one."""
    got, inside = collections.Counter(), [False]

    def show(message, category, filename, lineno, file=None, line=None):
        if inside[0] and "synchroniz" in str(message):
            cur = profiler.current()
            got[cur[1]["site"] if cur and cur[0] == "host_sync" else profiler.OUTSIDE] += 1

    torch.cuda.synchronize()
    profiler.reset()
    with warnings.catch_warnings(), profiler.enable():
        warnings.simplefilter("always")
        warnings.showwarning = show  # catch_warnings puts the hook back
        # switching the mode on can warn once in a process (torch's own call): only the unit's count
        torch.cuda.set_sync_debug_mode("warn")
        inside[0] = True
        try:
            unit()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(0)
    return got


@pytest.mark.card
def test_cornell_pass_and_image_syncs_are_counted_site_by_site(card):
    vp = cell_viewport("cornell_render", 512, card)
    vp.render(1)
    vp.image()
    got = sync_warnings(lambda: (vp.render(1), vp.image()))
    assert sum(got.values()) > 0 and got == collections.Counter(profiler.syncs()), (got, profiler.syncs())
    profiler.reset()


@pytest.mark.card
def test_mesh_pass_syncs_are_counted_site_by_site(card):
    scene, meta = random_mesh_scene(20000, seed=1, device=card)
    cam = make_camera(RigidTransform(), device=card)
    vp = Viewport(scene, meta, cam, ViewportParams(256, 256, seed=7), PARAMS, device=card)
    vp.render(1)
    got = sync_warnings(lambda: vp.render(1))
    assert got["wave2.unresolved"] > 0 and got["wave2.live_count"] > 0
    assert got == collections.Counter(profiler.syncs()), (got, profiler.syncs())
    profiler.reset()


@pytest.mark.card
def test_a_profiled_hall_pass_is_launched_inside_the_spans(card):
    from torch.profiler import ProfilerActivity, profile

    vp = cell_viewport("interior800k_render", 512, card)
    vp.render(1)
    torch.cuda.synchronize()
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vp.render(1)
        torch.cuda.synchronize()
    ops = profiler.device_ops(prof)
    by = profiler.device_ms_by_span(ops)
    total = sum((e - s) * 1e-6 for _, s, e, _ in ops)
    assert total > 0 and by.get(profiler.OUTSIDE, 0.0) <= 0.01 * total, (by.get(profiler.OUTSIDE), total)
    assert by["wave2.trace"] >= 0.95 * by["traverse"]
    assert sum(by.get(k, 0.0) for k in STAGES) >= 0.90 * by["traverse"], by
    profiler.reset()
