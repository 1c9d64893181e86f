"""The readers of the program's spans and counters
(``host_syncs_per_pass.render``, ``sync_idle_pct.render``,
``wave2_extract_ms_per_pass``, ``wave2_join_ms_per_pass``,
``wave2_pair_fill_pct``) on a synthetic traced run: a profile of two passes
whose device operations and program spans are made up, in the shape the
harness and ``raytracer_tpu_torch/utils/profiler.py`` give them.  Each
returns None where it finds nothing: CPU runs, other loops, a program that
records no spans."""

import json
import os
import types

import pytest

from conftest import ROOT
from harness import cells
from raytracer_tpu_torch.utils import profiler
from raytracer_tpu_torch.utils.profiler import Record

NAMES = ("host_syncs_per_pass.render", "sync_idle_pct.render", "wave2_extract_ms_per_pass",
         "wave2_join_ms_per_pass", "wave2_pair_fill_pct")
MS = 1_000_000


def reader(name):
    return cells.load_module("metrics", name).read


def traced(monkeypatch, loop="render"):
    """Two passes of 100 ms: each an extract [0, 40] ms and a join [40, 90]
    ms holding a sync [80, 82] ms; the device runs 30 ms launched in the
    extract and 46 in the join, and runs dry in the extract (5 ms), in the
    sync (8 ms) and after the join (11 ms)."""
    recs, ops, i = [], [], 0
    for k in range(2):
        t = k * 100 * MS
        ids = range(i + 1, i + 5)
        i += 4
        recs += [Record("frame.pass", t, t + 100 * MS, ids[0], 0, 1, {"index": k}),
                 Record("wave2.extract", t, t + 40 * MS, ids[1], ids[0], 1, {}),
                 Record("wave2.join", t + 40 * MS, t + 90 * MS, ids[2], ids[0], 1, {}),
                 Record("host_sync", t + 80 * MS, t + 82 * MS, ids[3], ids[2], 1, {"site": "wave2.compact_mask"})]
        ops += [("slab", t + 1 * MS, t + 31 * MS, t + 1 * MS),      # launched in the extract
                ("sort", t + 36 * MS, t + 81 * MS, t + 41 * MS),    # in the join; the device runs dry at 81
                ("gather", t + 89 * MS, t + 90 * MS, t + 85 * MS)]  # in the join, after the sync
    monkeypatch.setattr(profiler, "_buffer", recs)
    monkeypatch.setattr(profiler, "_syncs", {"wave2.compact_mask": 2, "viewport.counters": 8})
    monkeypatch.setattr(profiler, "counters", lambda: {"wave2.pair_slots_sent": 4000, "wave2.pair_slots_real": 1000})
    return {"loop": loop, "window": {"units": 3, "wall_s": 0.3},
            "profile": {"units": 2, "ops": ops, "busy_s": 0.152}}


def test_each_reader_on_a_synthetic_traced_run(monkeypatch):
    ctx = traced(monkeypatch)
    assert reader("host_syncs_per_pass.render")(ctx) == pytest.approx(5.0)
    # gaps: 31->36 ms (dry in the extract), 81->89 (in the sync), 90->101 (the join has closed at
    # 90: the pass), 131->136 and 181->189: the sync's share is 16 ms of 5 + 8 + 11 + 5 + 8
    assert reader("sync_idle_pct.render")(ctx) == pytest.approx(100.0 * 16 / 37)
    assert reader("wave2_extract_ms_per_pass")(ctx) == pytest.approx(30.0)
    assert reader("wave2_join_ms_per_pass")(ctx) == pytest.approx(46.0)
    assert reader("wave2_pair_fill_pct")(ctx) == pytest.approx(25.0)


@pytest.mark.parametrize("name", NAMES)
def test_none_where_nothing_was_recorded(monkeypatch, name):
    ctx = traced(monkeypatch)
    read = reader(name)
    assert read(dict(ctx, loop="viewer")) is None and read(dict(ctx, loop="grad")) is None
    assert read(dict(ctx, profile=None)) is None
    assert read(dict(ctx, profile=dict(ctx["profile"], ops=[]))) is None  # a CPU run traces no device op
    monkeypatch.setattr(profiler, "_buffer", [])
    monkeypatch.setattr(profiler, "_syncs", {})
    monkeypatch.setattr(profiler, "counters", lambda: {})
    assert read(ctx) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_with_a_program_that_records_no_spans(monkeypatch, name):
    """The parent's profiler had no buffer, counters or attribution: each
    reader finds nothing there and raises nothing."""
    ctx = traced(monkeypatch)
    mod = cells.load_module("metrics", name)
    monkeypatch.setattr(mod, "profiler", types.SimpleNamespace(collect=dict, report=str, reset=lambda: None))
    assert mod.read(ctx) is None


def test_the_five_metrics_are_entries_of_the_benchmark():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    got = {m["name"]: m for m in bench["per_layer"]}
    assert set(NAMES) <= set(got)
    assert got["host_syncs_per_pass.render"]["workloads"] == got["sync_idle_pct.render"]["workloads"] == [
        "interior800k_render", "cornell_render"]
    for name in NAMES[2:]:
        assert got[name]["workloads"] == ["interior800k_render"] and got[name]["layer"] == "traversal"
