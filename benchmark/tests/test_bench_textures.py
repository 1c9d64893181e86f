"""The textured hall (``configs/interior800k_tex.json``, written by
``generators/hall_tex.py``) and the readers of its texture and env-map
metrics.

- The generator is deterministic, writes the hall's meshes byte for byte
  and bitmaps at the configuration's sizes, and imports neither package.
- The hall's roof is placed so that half the hall is open to the sky.
- Its small layout (the same textures and materials over two small meshes,
  open to the sky) runs through the ``render`` loop at 16^2 on the CPU:
  correct against the reference, and not correct under the bf16 control,
  with every texture sample off by 1%, or with the sky's lookups or the
  env pdf of a BSDF ray off by 1%; its sky is bright overhead.
- ``texture_ms_per_pass``, ``texture_launches_per_pass``,
  ``texture_lane_fill_pct`` and ``env_ms_per_pass`` on a synthetic traced
  run, and None where they find nothing to read.
- On the card, a textured pass's blocking calls are counted site by site."""

import collections
import filecmp
import json
import os
import subprocess
import sys
import time
import types

import pytest

from conftest import ROOT, tiny
from harness import cells, check, guard, runner, scenes
from raytracer_tpu_torch.utils import profiler
from raytracer_tpu_torch.utils.profiler import Record

CELL = "interior800k_tex_render"
NAMES = ("texture_ms_per_pass", "texture_launches_per_pass", "texture_lane_fill_pct", "env_ms_per_pass")
SEED = 2**31 + 1717
MS = 1_000_000


def generator():
    return cells.load_module("generators", "hall_tex")


def read_bmp(path):
    check.reference()
    from rt.io.bmp import read_bmp

    return read_bmp(path)


@pytest.fixture(scope="module")
def hall_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hall_tex")
    return d, generator().write(str(d))


def test_the_generator_keeps_the_halls_meshes_and_the_sizes(tmp_path, hall_dir):
    config = cells.find(CELL).config
    a_dir, a = hall_dir
    generator().write(str(tmp_path / "b"))
    cells.load_module("generators", "hall").write(str(tmp_path / "hall"))
    names = sorted(os.listdir(a_dir))
    assert os.path.basename(a) == config["scene_file"] and names == sorted(os.listdir(tmp_path / "b"))
    assert filecmp.cmpfiles(a_dir, tmp_path / "b", names, shallow=False)[0] == names
    meshes = [n for n in os.listdir(tmp_path / "hall") if n.endswith((".obj", ".mtl"))]
    assert len(meshes) == 6 and filecmp.cmpfiles(tmp_path / "hall", a_dir, meshes, shallow=False)[0] == meshes
    faces = 0
    for n in meshes:
        with open(a_dir / n) as f:
            faces += sum(1 for line in f if line.startswith("f "))
    assert faces == config["triangles"] == 799964
    doc = json.load(open(a))
    bitmaps = {t["name"]: t["path"] for t in doc["textures"] if t["type"] == "bitmap"}
    assert set(bitmaps) == {"tiles", "plaster", "marble", "ripples", "sky"}
    for name, path in bitmaps.items():
        assert not os.path.isabs(path)
        assert read_bmp(str(a_dir / path)).shape == ((512, 1024, 3) if name == "sky" else (1024, 1024, 3))
    assert config["reduced"] == [] and config["image_size"] == [1920, 1080]
    assert {"scene", "texture_size", "sky", "textured_surfaces", "open_court"} <= set(config["assumed"])


def test_the_roof_leaves_half_the_hall_open_to_the_sky(hall_dir):
    """The ceiling mesh, its file the hall's, is placed half the hall's
    width toward -x: it covers x < 0 up to the wall, nothing above x > 0."""
    directory, path = hall_dir
    meshes = {o["path"]: o for o in json.load(open(path))["objects"] if o["type"] == "mesh"}
    assert [p for p, o in meshes.items() if "transform" in o] == ["shell_ceiling.obj"]
    shift = meshes["shell_ceiling.obj"]["transform"]["translation"]
    hx = cells.load_module("generators", "hall").HX
    assert shift == [-hx, 0.0, 0.0]
    with open(directory / "shell_ceiling.obj") as f:
        xs = [float(line.split()[1]) + shift[0] for line in f if line.startswith("v ")]
    assert min(xs) == pytest.approx(-2 * hx) and max(xs) == pytest.approx(0.0, abs=1e-4)


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_generator_and_the_readers_import_no_jax():
    gen = _modules("import sys, json; sys.path[:0] = ['benchmark', '.']; from harness import cells; "
                   "cells.load_module('generators', 'hall_tex'); print(json.dumps(sorted(sys.modules)))")
    assert guard.loaded(guard.FORBIDDEN_IN_REFERENCE, gen) == []
    readers = _modules("import sys, json; sys.path[:0] = ['benchmark', '.']; from harness import cells; "
                       f"[cells.load_module('metrics', n) for n in {list(NAMES)!r}]; "
                       "print(json.dumps(sorted(sys.modules)))")
    assert guard.loaded(modules=readers) == []


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return generator().write_small(str(tmp_path_factory.mktemp("small_tex")))


def run_small(monkeypatch, small, trace=False):
    monkeypatch.setattr(scenes, "scene_path", lambda name, config, cache=None: small)
    return runner.run(tiny(cells.find(CELL)), SEED, 0.5, trace, "cpu", time.perf_counter(), lambda m: None)


def test_the_small_layout_is_lit_by_the_sky_and_textured(small):
    from raytracer_tpu_torch.io.scene_loader import load_scene

    scene, meta, _ = load_scene(small, strict=True, device="cpu")
    assert scene.textures is not None and scene.env_dist is not None
    assert tuple(scene.textures.data.shape) == (4 * 1024 + 512, 1024, 3)
    assert meta.background_light_index >= 0


def test_a_sound_run_of_the_small_layout_is_correct(monkeypatch, small):
    got = run_small(monkeypatch, small)
    assert got["correct"] is True and got["failed"] == 0, got["checks"]


def test_the_control_fails_on_the_small_layout(small):
    cell = tiny(cells.find(CELL))
    found = check.control_numbers(cell, small, SEED, "cpu", 2)
    assert check.judge(found, cell.limits)[0] is False, found


def test_texture_samples_off_by_one_percent_are_caught(monkeypatch, small):
    import raytracer_tpu_torch.integrators.path_tracer as pt
    import raytracer_tpu_torch.ops.materials as materials
    from raytracer_tpu_torch.ops.textures import sample_texture_many

    def off(*a, **k):
        return sample_texture_many(*a, **k) * 1.01

    for mod in (pt, materials):
        monkeypatch.setattr(mod, "sample_texture_many", off)
    assert run_small(monkeypatch, small)["correct"] is False


@pytest.mark.parametrize("fault", ["sky_lookups", "env_direction_pdf"])
def test_env_faults_off_by_one_percent_are_caught(monkeypatch, small, fault):
    """The sky lights the layout and fills much of its image, so a fault of
    1% in its lookups, or in the pdf that weighs a BSDF ray reaching it
    against NEE, makes the run incorrect."""
    import raytracer_tpu_torch.integrators.path_tracer as pt
    import raytracer_tpu_torch.ops.lights as lights
    from raytracer_tpu_torch.ops.textures import sample_texture_many

    if fault == "sky_lookups":
        def off(*a, site="material", **k):
            out = sample_texture_many(*a, site=site, **k)
            return out * 1.01 if site == "env" else out

        monkeypatch.setattr(pt, "sample_texture_many", off)
    else:
        real = lights.env_direction_pdf
        monkeypatch.setattr(pt, "env_direction_pdf", lambda *a, **k: real(*a, **k) * 1.01)
    assert run_small(monkeypatch, small)["correct"] is False


def test_the_small_layouts_sky_is_bright_straight_up(small):
    """The sky BMP is stored so that the loaders' BMP convention puts its
    zenith, not its ground, straight up, and NEE samples it upward."""
    import torch

    from raytracer_tpu_torch.integrators.path_tracer import _env_radiance
    from raytracer_tpu_torch.io.scene_loader import load_scene
    from raytracer_tpu_torch.math.vec import Vec3
    from raytracer_tpu_torch.ops.lights import env_sample_direction

    scene, meta, _ = load_scene(small, strict=True, device="cpu")
    up = Vec3(torch.tensor([0.0, 0.0]), torch.tensor([0.8, -0.8]), torch.tensor([0.6, 0.6]))
    sky = _env_radiance(scene, meta.background_light_index, up)
    assert sky.z[0] > 0.2 > 0.01 > sky.z[1]  # blue overhead, the dim ground below
    u = torch.linspace(0.01, 0.99, 99)
    d, _ = env_sample_direction(scene.env_dist, u.repeat(99), u.repeat_interleave(99))
    assert (d.y > 0).float().mean() > 0.9


def test_a_traced_cpu_run_reports_no_texture_metric(monkeypatch, small):
    got = run_small(monkeypatch, small, trace=True)
    assert set(got["metrics"]) == {"rays_per_pass.render"} and not set(NAMES) & set(got["metrics"])


def reader(name):
    return cells.load_module("metrics", name).read


def traced(monkeypatch, loop="render"):
    """Two passes of 100 ms: each a material texture call [10, 30] ms and
    an env lookup [40, 70] ms holding a sky texture call [45, 65] ms; the
    device runs 12 ms in 3 operations launched in the material call, 4 ms
    in the env span outside its texture call and 9 ms in 2 operations in
    the sky's, and 20 ms outside every span."""
    recs, ops, i = [], [], 0
    for k in range(2):
        t = k * 100 * MS
        ids = range(i + 1, i + 5)
        i += 4
        recs += [Record("frame.pass", t, t + 100 * MS, ids[0], 0, 1, {"index": k}),
                 Record("textures", t + 10 * MS, t + 30 * MS, ids[1], ids[0], 1, {"site": "material"}),
                 Record("lights.env", t + 40 * MS, t + 70 * MS, ids[2], ids[0], 1, {}),
                 Record("textures", t + 45 * MS, t + 65 * MS, ids[3], ids[2], 1, {"site": "env"})]
        ops += [("gather", t + 11 * MS, t + 15 * MS, t + 11 * MS), ("mul", t + 15 * MS, t + 19 * MS, t + 12 * MS),
                ("where", t + 19 * MS, t + 23 * MS, t + 13 * MS),        # 12 ms in 3 ops: the material call
                ("pdf", t + 41 * MS, t + 45 * MS, t + 41 * MS),          # 4 ms: env, outside its texture call
                ("gather", t + 46 * MS, t + 51 * MS, t + 46 * MS), ("mul", t + 51 * MS, t + 55 * MS, t + 47 * MS),
                ("trace", t + 75 * MS, t + 95 * MS, t + 75 * MS)]        # 20 ms outside both
    monkeypatch.setattr(profiler, "_buffer", recs)
    monkeypatch.setattr(profiler, "counters", lambda: {  # the sky's lanes, every one textured, are left out
        "textures.lanes.material": 6000, "textures.lanes_textured.material": 1000, "textures.lanes.normal": 2000,
        "textures.lanes_textured.normal": 1000, "textures.lanes.env": 4000, "textures.lanes_textured.env": 4000})
    return {"loop": loop, "window": {"units": 3, "wall_s": 0.3},
            "profile": {"units": 2, "ops": ops, "busy_s": 0.09}}


def test_each_reader_on_a_synthetic_traced_run(monkeypatch):
    ctx = traced(monkeypatch)
    assert reader("texture_ms_per_pass")(ctx) == pytest.approx(12.0 + 9.0)
    assert reader("texture_launches_per_pass")(ctx) == pytest.approx(5.0)
    assert reader("texture_lane_fill_pct")(ctx) == pytest.approx(25.0)
    assert reader("env_ms_per_pass")(ctx) == pytest.approx(4.0 + 9.0)


def test_texture_ops_are_counted_where_their_time_is():
    recs = [Record("textures", 0, 10, 1, 0, 1, {"site": "normal"}), Record("lights.env", 20, 40, 2, 0, 1, {}),
            Record("textures", 25, 35, 3, 2, 1, {"site": "env"})]
    ops = [("a", 0, 4 * MS, 1), ("b", 0, 2 * MS, 26), ("c", 0, MS, 21), ("d", 0, MS, 50), ("e", 0, MS, None)]
    assert profiler.device_ops_by_span(ops, recs) == {"textures": 2, "lights.env": 2, profiler.OUTSIDE: 2}
    assert profiler.device_ms_by_span(ops, recs) == pytest.approx(
        {"textures": 6.0, "lights.env": 3.0, profiler.OUTSIDE: 2.0})


@pytest.mark.parametrize("name", NAMES)
def test_none_where_nothing_was_recorded(monkeypatch, name):
    ctx = traced(monkeypatch)
    read = reader(name)
    assert read(dict(ctx, loop="viewer")) is None and read(dict(ctx, loop="grad")) is None
    assert read(dict(ctx, profile=None)) is None
    assert read(dict(ctx, profile=dict(ctx["profile"], ops=[]))) is None  # a CPU run traces no device op
    monkeypatch.setattr(profiler, "_buffer", [])
    monkeypatch.setattr(profiler, "counters", lambda: {})
    assert read(ctx) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_with_a_program_without_texture_spans(monkeypatch, name):
    """The parent's profiler attributes device time to spans but has no
    ``device_ops_by_span`` and records no ``textures`` or ``lights.env``
    span and no texture counter: each reader finds nothing and raises
    nothing."""
    ctx = traced(monkeypatch)
    mod = cells.load_module("metrics", name)
    parent = types.SimpleNamespace(device_ms_by_span=lambda ops: {"integrator": 1.0}, counters=lambda: {})
    monkeypatch.setattr(mod, "profiler", parent)
    assert mod.read(ctx) is None


@pytest.mark.card
def test_a_textured_pass_syncs_are_counted_site_by_site(card, small):
    from test_bench_program_syncs import PARAMS, sync_warnings

    from raytracer_tpu_torch.io.scene_loader import load_scene
    from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams

    scene, meta, cam = load_scene(small, device=card)
    vp = Viewport(scene, meta, cam, ViewportParams(256, 256, seed=4500000001), PARAMS, device=card)
    vp.render(1)
    got = sync_warnings(lambda: vp.render(1))
    assert profiler.counters()["textures.lanes.material"] > 0
    assert got == collections.Counter(profiler.syncs()), (got, profiler.syncs())
    profiler.reset()
