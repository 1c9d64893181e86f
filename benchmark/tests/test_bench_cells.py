"""Cells are found by name, and BENCHMARK.json keeps to the contract's
shape."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT
from harness import cells

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_is_found_with_its_files(name):
    cell = cells.find(name)
    loop = cells.load_module("loops", cell.traffic["loop"])
    assert cell.config_name and all(callable(f) for f in (loop.Loop, loop.compare, loop.control))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert set(cell.limits["numbers"]), "every cell compares numbers"


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.find("no_such_cell")


def test_every_metric_has_its_reader_and_every_roofline_its_count():
    for m in BENCHMARK["per_layer"]:
        mod = cells.load_module("metrics", m["name"])
        assert callable(mod.read)
        if m["name"].endswith("_roofline"):
            count = cells.load_module("rooflines", m["name"][: -len("_roofline")])
            assert callable(count.count) and m["unit"] == "%"
    assert set(cells.rooflines()) == {"wave2_mt"}
    for sp in cells.spans():
        assert {"name", "module", "attr"} <= set(sp)


def test_benchmark_json_shape():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for x in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == len(b["end_to_end"]) + len(b["per_layer"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        layers.setdefault(m["layer"], m["layer"])
        for cell in m["workloads"]:
            # each cell a per-layer metric lists reports the metric it moves
            c = cells.find(cell)
            assert m["moves"] in {x["name"] for x in c.end_to_end}
    assert len(json.dumps(b)) < 64 * 1024


def test_only_data_and_code_of_the_benchmark_under_paths():
    for dirpath, _, files in os.walk(BENCH):
        if "_cache" in dirpath or "__pycache__" in dirpath or "_checkout" in dirpath:
            continue
        for f in files:
            assert re.match(r"^[A-Za-z0-9_.\-]+$", f), f


def test_generators_are_found_by_name():
    for c in BENCHMARK["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        if "generator" in cfg:
            assert callable(cells.load_module("generators", cfg["generator"]).write)


def test_a_generated_scene_is_written_once(tmp_path, monkeypatch):
    from harness import scenes

    calls = []

    class Gen:
        @staticmethod
        def write(directory):
            calls.append(directory)
            os.makedirs(directory)
            open(os.path.join(directory, "s.json"), "w").write("{}")
            return os.path.join(directory, "s.json")

    monkeypatch.setattr(scenes, "load_module", lambda kind, name: Gen if (kind, name) == ("generators", "g") else None)
    cfg = {"generator": "g", "scene_file": "s.json"}
    first = scenes.scene_path("c", cfg, str(tmp_path))
    assert scenes.scene_path("c", cfg, str(tmp_path)) == first == str(tmp_path / "c" / "s.json")
    assert len(calls) == 1 and os.path.exists(tmp_path / "c" / scenes.DONE)


def test_every_render_setting_of_the_traffic_reaches_both_sides():
    from dataclasses import asdict, fields

    from harness import check
    from raytracer_tpu_torch.integrators.path_tracer import RenderParams

    check.reference()
    import rt.integrators.path_tracer as ref

    assert [f.name for f in fields(RenderParams)] == [f.name for f in fields(ref.RenderParams)]
    cell = cells.find("cornell_render")
    cell.traffic = dict(cell.traffic, max_depth=3, mis=False, min_rr_depth=2, light_strategy="all")
    prog, theirs = cells.render_params(cell, RenderParams), cells.render_params(cell, ref.RenderParams)
    assert asdict(prog) == asdict(theirs) == dict(asdict(RenderParams()), max_depth=3, mis=False, min_rr_depth=2,
                                                  light_strategy="all")
    assert check.ref_params(cell) == (theirs, 512, 512)
