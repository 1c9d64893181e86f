"""The port's texture and env-map spans and counters on the CPU, on the small
textured scene of ``benchmark/generators/hall_tex.py::write_small`` (two
meshes, a textured, normal-mapped slab, textured props, a lat-long sky that
NEE importance-samples).

- Each ``sample_texture_many`` call is a ``textures`` span carrying its
  ``site``: four material columns, the normal map and the sky twice (miss
  path and NEE) a bounce; the sky's calls sit inside ``lights.env`` spans.
- ``textures.lanes.<site>`` is the lanes times the site's calls;
  ``textures.lanes_textured.<site>`` the lanes whose id is not
  ``INVALID_ID``, counted here by hand.
- ``lights.env`` spans the env map's sample, its pdf and both sky lookups;
  ``load.textures`` the bitmap decodes, the atlas and the env distribution.
- A pass makes the same blocking calls with tracing on as with it off, and
  with it off the texture stack records nothing.
"""

import importlib.util
import os

import pytest

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu_torch.integrators import path_tracer
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.ops import materials, textures, wave2_traverse
from raytracer_tpu_torch.render import postprocess, renderer
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.sampler import sampler
from raytracer_tpu_torch.scene.types import INVALID_ID
from raytracer_tpu_torch.utils import profiler

HALL_TEX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark", "generators",
                        "hall_tex.py")

SIZE = 8
DEPTH = 2
BOUNCES = DEPTH + 1  # the last step resolves the last segment's hit
SITES = {"material": 4, "normal": 1, "env": 2}  # calls a bounce


@pytest.fixture(autouse=True)
def clean():
    profiler.reset()
    yield
    profiler.reset()


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("hall_tex_for_texture_trace", HALL_TEX)
    hall_tex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hall_tex)
    return hall_tex.write_small(str(tmp_path_factory.mktemp("small_tex")))


@pytest.fixture(scope="module")
def viewport(scene_file):
    scene, meta, cam = load_scene(scene_file, strict=True, device="cpu")
    assert scene.textures is not None and scene.env_dist is not None
    return Viewport(scene, meta, cam, ViewportParams(SIZE, SIZE, seed=5), RenderParams(max_depth=DEPTH, mis=True),
                    device="cpu")


def traced_pass(vp):
    with profiler.enable():
        vp.render(1)
    return profiler.records()


def test_texture_spans_carry_their_site(viewport):
    recs = traced_pass(viewport)
    by_id = {r.id: r for r in recs}
    tex = [r for r in recs if r.name == "textures"]
    got = {site: sum(1 for r in tex if r.attrs["site"] == site) for site in SITES}
    assert got == {site: n * BOUNCES for site, n in SITES.items()} and len(tex) == sum(got.values())
    # the sky's lookups hang under a lights.env span, the others do not
    for r in tex:
        assert (by_id[r.parent].name == "lights.env") == (r.attrs["site"] == "env")


def test_lane_counters_are_the_calls_lanes_and_the_textured_ones(viewport, monkeypatch):
    textured = {site: 0 for site in SITES}
    real = textures.sample_texture_many

    def counted(atlas, tex_ids, u, v, site="material"):
        textured[site] += int((tex_ids != INVALID_ID).sum())
        return real(atlas, tex_ids, u, v, site=site)

    for mod in (materials, path_tracer):
        monkeypatch.setattr(mod, "sample_texture_many", counted)
    recs = traced_pass(viewport)
    calls = {site: sum(1 for r in recs if r.name == "textures" and r.attrs["site"] == site) for site in SITES}
    c = profiler.counters()
    assert {k for k in c if k.startswith("textures.")} == {
        f"textures.{k}.{site}" for k in ("lanes", "lanes_textured") for site in SITES}
    for site in SITES:
        assert calls[site] == SITES[site] * BOUNCES
        assert c[f"textures.lanes.{site}"] == SIZE * SIZE * calls[site]
        assert c[f"textures.lanes_textured.{site}"] == textured[site]
    # the material columns are textured on some lanes only, the sky on every lane
    assert 0 < c["textures.lanes_textured.material"] < c["textures.lanes.material"]
    assert c["textures.lanes_textured.env"] == c["textures.lanes.env"]


def test_env_and_load_spans_are_recorded(viewport, scene_file):
    recs = traced_pass(viewport)
    # a bounce: the sky on the miss path and its MIS pdf, the NEE sample and the sky in NEE
    assert sum(1 for r in recs if r.name == "lights.env") == 4 * BOUNCES
    profiler.reset()
    with profiler.enable():
        load_scene(scene_file, strict=True, device="cpu")
    stages = [r.attrs["stage"] for r in profiler.records() if r.name == "load.textures"]
    assert sorted(stages) == ["atlas", "decode", "decode", "decode", "decode", "decode", "env_dist"]


def test_a_pass_blocks_as_often_with_tracing_on_as_off(viewport, monkeypatch):
    calls = []
    real = profiler.host_sync

    def counted(site):
        calls.append(site)
        return real(site)

    for mod in (renderer, postprocess, sampler, wave2_traverse):
        monkeypatch.setattr(mod, "host_sync", counted)
    viewport.reset()  # the same pass both times: wave2's rounds follow the rays
    viewport.render(1)
    off = list(calls)
    assert off and profiler.records() == [] and profiler.counters() == {}
    calls.clear()
    viewport.reset()
    traced_pass(viewport)
    assert sorted(calls) == sorted(off)
    assert sum(profiler.syncs().values()) == len(off)
