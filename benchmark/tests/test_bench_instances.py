"""The instanced hall (``configs/interior800k_inst.json``, written by
``generators/hall_inst.py``), the reference's two-level traversal
(``reference/rt/ops/instances.py``) and the readers of the instance metrics.

- The generator writes the hall's shell byte for byte, the column and the
  knot once each in object space, and a scene of 31 placements of the two
  whose world holds the baked hall's 799,964 triangles; it imports neither
  package, and the reference's instance module imports no program.
- Its small layout runs through the ``render_inst`` loop at 16^2 on the
  CPU: correct against the reference, and not correct under the bf16
  control, with the last instance's translation off by 1%, with the last
  instance dropped, or with a cull that rejects the pairs within 1% of a
  box's size of its edge.  The faults are judged on every pixel of a 12 s
  window (4 to 6 passes): a fault that changes a few paths a pass shows in
  a share of the pixels that grows with the passes.
- A program without the top level is refused before any scene is loaded.
- The four instance metrics on a synthetic traced run, and None where they
  find nothing to read; a traced CPU run reports none of them."""

import dataclasses
import filecmp
import json
import os
import time
import types

import pytest
import torch

from conftest import tiny
from harness import cells, check, guard, runner, scenes
from raytracer_tpu_torch.utils import profiler
from raytracer_tpu_torch.utils.profiler import Record
from test_bench_textures import _modules

CELL = "interior800k_inst_render"
NAMES = ("instance_ms_per_pass", "instance_launches_per_pass", "instance_queries_per_pass",
         "instance_pair_fill_pct")
SEED = 2**31 + 2222
MS = 1_000_000


def generator():
    return cells.load_module("generators", "hall_inst")


def faces(path) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.startswith("f "))


def test_the_generator_places_the_halls_columns_and_knots(tmp_path):
    config = cells.find(CELL).config
    path = generator().write(str(tmp_path / "inst"))
    hall = cells.load_module("generators", "hall")
    hall.write(str(tmp_path / "hall"))
    a, b = tmp_path / "inst", tmp_path / "hall"
    shell = ["shell_floor.obj", "shell_ceiling.obj", "shell_walls.obj", "interior.mtl"]
    assert filecmp.cmpfiles(a, b, shell, shallow=False)[0] == shell
    assert sorted(os.listdir(a)) == sorted(shell[:3] + ["column.obj", "knot.obj", "interior.mtl",
                                                        config["scene_file"]])
    doc = json.load(open(path))
    meshes = [o for o in doc["objects"] if o["type"] == "mesh"]
    placed = [o["path"] for o in meshes]
    assert placed.count("column.obj") == 28 and placed.count("knot.obj") == 3 and len(placed) == 34
    world = sum(faces(a / p) for p in placed)
    assert world == config["triangles"] == 799964
    assert faces(a / "column.obj") * 28 == faces(b / "columns.obj")
    assert faces(a / "knot.obj") * 3 == faces(b / "knots.obj")
    baked = json.load(open(b / "interior.json"))
    assert [o for o in doc["objects"] if o["type"] != "mesh"] == [o for o in baked["objects"] if o["type"] != "mesh"]
    assert doc["lights"] == baked["lights"] and doc["camera"] == baked["camera"]
    assert config["reduced"] == [] and config["image_size"] == [1920, 1080]
    assert config["instances"] == 31 and config["shared_meshes"] == 2
    assert {"scene", "instances"} <= set(config["assumed"])


def test_the_generator_and_the_reference_import_no_program():
    got = _modules("import sys, json; sys.path[:0] = ['benchmark', '.']; from harness import cells, check; "
                   "cells.load_module('generators', 'hall_inst'); check.reference(); import rt.ops.instances; "
                   "print(json.dumps(sorted(sys.modules)))")
    assert guard.loaded(guard.FORBIDDEN_IN_REFERENCE, got) == []
    readers = _modules("import sys, json; sys.path[:0] = ['benchmark', '.']; from harness import cells; "
                       f"[cells.load_module('metrics', n) for n in {list(NAMES)!r}]; "
                       "cells.load_module('loops', 'render_inst'); print(json.dumps(sorted(sys.modules)))")
    assert guard.loaded(modules=readers) == []


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return generator().write_small(str(tmp_path_factory.mktemp("small_inst")))


def run_small(monkeypatch, small, trace=False, seconds=0.5, every_pixel=False):
    monkeypatch.setattr(scenes, "scene_path", lambda name, config, cache=None: small)
    cell = tiny(cells.find(CELL))
    if every_pixel:
        cell.traffic["check_pixels"] = 16 * 16
    return runner.run(cell, SEED, seconds, trace, "cpu", time.perf_counter(), lambda m: None)


def faulty_run(monkeypatch, small):
    """A 12 s window judged on every pixel."""
    return run_small(monkeypatch, small, seconds=12.0, every_pixel=True)


def loaded_with(monkeypatch, change):
    """The render loop's scene loader with ``change(scene)`` applied to the
    program's scene."""
    render = cells.load_module("loops", "render")
    real = render.load_scene

    def load(*a, **k):
        scene, meta, cam = real(*a, **k)
        return change(scene), meta, cam

    monkeypatch.setattr(render, "load_scene", load)


def test_the_small_layout_holds_eighteen_instances_of_three_meshes(small):
    from raytracer_tpu_torch.io.scene_loader import load_scene

    scene, _, _ = load_scene(small, device="cpu")
    assert scene.instances.count == 18 and len(scene.mesh_geoms) == 3 and scene.tris is not None
    assert scene.instances.mesh_ids == (0,) * 12 + (1,) * 4 + (2, 2)


def test_a_sound_run_of_the_small_layout_is_correct(monkeypatch, small):
    got = run_small(monkeypatch, small)
    assert got["correct"] is True and got["failed"] == 0, got["checks"]
    assert all(c["value"] == 0.0 for c in got["checks"].values()), got["checks"]


def test_the_control_fails_on_the_small_layout(small):
    cell = tiny(cells.find(CELL))
    found = check.control_numbers(cell, small, SEED, "cpu", 2)
    assert check.judge(found, cell.limits)[0] is False, found


def test_an_instance_moved_by_one_percent_is_caught(monkeypatch, small):
    def moved(scene):
        for c in scene.instances.trans:
            c[-1].mul_(1.01)  # the turned knot
        return scene

    loaded_with(monkeypatch, moved)
    assert faulty_run(monkeypatch, small)["correct"] is False


def test_the_last_instance_dropped_is_caught(monkeypatch, small):
    def dropped(scene):
        inst = scene.instances
        cut = lambda v: type(v)(*(c[:-1] for c in v))
        fewer = dataclasses.replace(inst, rot=type(inst.rot)(*(cut(r) for r in inst.rot)), trans=cut(inst.trans),
                                    vel=cut(inst.vel), mesh_ids=inst.mesh_ids[:-1])
        return scene._replace(instances=fewer)

    loaded_with(monkeypatch, dropped)
    assert faulty_run(monkeypatch, small)["correct"] is False


def test_a_cull_that_drops_pairs_near_a_box_edge_is_caught(monkeypatch, small):
    """Each world box shrunk on every side by 1% of its largest extent (a
    box that closes culls every pair): the pairs whose rays meet an instance
    only within that band of its box's edge are culled.  The poles lose the
    outer half of their width."""
    from raytracer_tpu_torch.ops import traverse

    real = traverse._cull

    def shrunk(top, *a, **k):
        lo, hi = top.box[:3], top.box[3:]
        ext = 0.01 * (hi - lo).amax(0, keepdim=True)
        lo, hi = lo + ext, hi - ext
        return real(top._replace(box=torch.cat([lo, hi])), *a, **k) & (lo <= hi).all(0)[:, None]

    monkeypatch.setattr(traverse, "_cull", shrunk)
    assert faulty_run(monkeypatch, small)["correct"] is False


def test_a_program_without_the_top_level_is_refused_at_once(monkeypatch, small):
    from raytracer_tpu_torch.ops import traverse

    monkeypatch.delattr(traverse, "top_level")
    never = lambda *a, **k: pytest.fail("a scene was loaded")
    monkeypatch.setattr(cells.load_module("loops", "render"), "load_scene", never)
    with pytest.raises(RuntimeError, match="top level"):
        run_small(monkeypatch, small)


def test_a_traced_cpu_run_reports_no_instance_metric(monkeypatch, small):
    got = run_small(monkeypatch, small, trace=True)
    assert "rays_per_pass.render" in got["metrics"] and not set(NAMES) & set(got["metrics"])


def reader(name):
    return cells.load_module("metrics", name).read


def traced(monkeypatch, loop="render"):
    """Two passes of 100 ms, each with two ``traverse.instances`` spans
    [10, 30] and [50, 60] ms; the device runs 12 ms in 3 operations launched
    in the first, 5 ms in 2 in the second and 20 ms outside both; the
    queries and pairs counters of the two passes."""
    recs, ops, i = [], [], 0
    for k in range(2):
        t = k * 100 * MS
        ids = range(i + 1, i + 4)
        i += 3
        recs += [Record("frame.pass", t, t + 100 * MS, ids[0], 0, 1, {"index": k}),
                 Record("traverse.instances", t + 10 * MS, t + 30 * MS, ids[1], ids[0], 1, {}),
                 Record("traverse.instances", t + 50 * MS, t + 60 * MS, ids[2], ids[0], 1, {})]
        ops += [("cull", t + 11 * MS, t + 15 * MS, t + 11 * MS), ("mt", t + 15 * MS, t + 19 * MS, t + 12 * MS),
                ("fold", t + 19 * MS, t + 23 * MS, t + 13 * MS),          # 12 ms in 3 ops
                ("cull", t + 51 * MS, t + 53 * MS, t + 51 * MS), ("mt", t + 53 * MS, t + 56 * MS, t + 52 * MS),
                ("shade", t + 70 * MS, t + 90 * MS, t + 70 * MS)]         # 20 ms outside both
    monkeypatch.setattr(profiler, "_buffer", recs)
    monkeypatch.setattr(profiler, "counters", lambda: {
        "instances.queries": 8, "instances.pairs_tested": 4000, "instances.pairs_sent": 250})
    return {"loop": loop, "window": {"units": 3, "wall_s": 0.3},
            "profile": {"units": 2, "ops": ops, "busy_s": 0.074}}


def test_each_reader_on_a_synthetic_traced_run(monkeypatch):
    ctx = traced(monkeypatch)
    assert reader("instance_ms_per_pass")(ctx) == pytest.approx(12.0 + 5.0)
    assert reader("instance_launches_per_pass")(ctx) == pytest.approx(5.0)
    assert reader("instance_queries_per_pass")(ctx) == pytest.approx(4.0)
    assert reader("instance_pair_fill_pct")(ctx) == pytest.approx(6.25)


def test_the_loop_reads_as_a_render_loop_when_traced():
    loop = cells.load_module("loops", "render_inst").Loop.__new__(cells.load_module("loops", "render_inst").Loop)
    assert loop.traced()["loop"] == "render"


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
def test_none_with_a_program_without_the_top_level(monkeypatch, name):
    """A program without the top level keeps no ``instances.*`` counter and
    may lack ``device_ops_by_span``: the counter readers find nothing and
    no reader raises."""
    ctx = traced(monkeypatch)
    mod = cells.load_module("metrics", name)
    parent = types.SimpleNamespace(device_ms_by_span=lambda ops: {"integrator": 1.0}, counters=lambda: {})
    monkeypatch.setattr(mod, "profiler", parent)
    assert mod.read(ctx) is None
