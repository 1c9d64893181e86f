"""The port's spans and counters (``raytracer_tpu_torch/utils/profiler.py``)
on the CPU.

- With tracing off a pass records nothing and reads no clock.
- Spans nest: parent ids, and self times that add up to the roots' time.
- On a small mesh scene the blocking transfers counted by site agree with
  wave2's ``STATS``: ``wave2.live_count`` once a trace, ``wave2.unresolved``
  once a window and a continuation, ``wave2.compact_mask`` seven times a
  continuation; the pair-slot counters hold what ``_pair_join`` handed on.
- The clock is the profiler's: in a CPU ``torch.profiler`` capture a span
  around a torch op holds that op's event, and no span adds an event.
- ``device_ms_by_span`` and ``idle_by_span`` on synthetic operations.
- ``python -m raytracer_tpu_torch --trace DIR`` writes a Chrome trace with
  the program's spans beside torch's events, and prints the report.
"""

import json
import os

import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.ops import wave2_traverse as w2
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw, random_mesh_scene
from raytracer_tpu_torch.utils import profiler
from raytracer_tpu_torch.utils.profiler import OUTSIDE, Record

PARAMS = RenderParams(max_depth=2, mis=True)


@pytest.fixture(autouse=True)
def clean():
    profiler.reset()
    yield
    profiler.reset()


def cornell_viewport(size=8):
    scene, meta = cornell_box(device="cpu")
    t_kw, c_kw = cornell_camera_kw()
    cam = make_camera(RigidTransform(**t_kw), **c_kw, device="cpu")
    return Viewport(scene, meta, cam, ViewportParams(size, size, seed=3), PARAMS, device="cpu")


@pytest.fixture(scope="module")
def mesh_viewport():
    scene, meta = random_mesh_scene(2000, seed=1, device="cpu")
    cam = make_camera(RigidTransform(), device="cpu")
    return Viewport(scene, meta, cam, ViewportParams(16, 16, seed=3), PARAMS, device="cpu")


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    calls = []
    real = profiler._clock
    monkeypatch.setattr(profiler, "_clock", lambda: calls.append(1) or real())
    vp = cornell_viewport()
    vp.render(1)
    vp.image()
    assert not profiler.tracing()
    assert calls == [] and profiler.records() == [] and profiler.syncs() == {} and profiler.counters() == {}
    with profiler.enable():
        vp.render(1)
    assert len(calls) == 2 * len(profiler.records()) > 0


def test_spans_nest_and_self_times_add_up():
    with profiler.enable():
        with profiler.span("outer", k=1):
            with profiler.span("mid"):
                with profiler.span("inner"):
                    torch.ones(64).sum()
                with profiler.host_sync("unit.read"):
                    float(torch.ones(4).sum())
            with profiler.span("mid"):
                pass
    recs = {r.id: r for r in profiler.records()}
    by_name = {}
    for r in recs.values():
        by_name.setdefault(r.name, []).append(r)
    (outer,) = by_name["outer"]
    assert outer.parent == 0 and outer.attrs == {"k": 1}
    assert all(m.parent == outer.id for m in by_name["mid"])
    assert by_name["inner"][0].parent == by_name["host_sync"][0].parent == by_name["mid"][0].id
    assert by_name["host_sync"][0].attrs == {"site": "unit.read"} and profiler.syncs() == {"unit.read": 1}
    for r in recs.values():
        assert r.start_ns <= r.end_ns
        if r.parent:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    stats = profiler.collect()
    assert stats["mid"]["count"] == 2 and stats["outer"]["count"] == 1
    assert sum(e["self"] for e in stats.values()) == pytest.approx(stats["outer"]["total"], rel=1e-9, abs=1e-12)
    assert 0 <= stats["outer"]["self"] <= stats["outer"]["total"]
    text = profiler.report()
    assert "spans by self time" in text and "unit.read" in text


def test_sync_sites_match_wave2_stats(mesh_viewport, monkeypatch):
    monkeypatch.setenv("RT_WAVE2_KC", "1")  # one candidate a round: rays continue
    vp = mesh_viewport
    w2.reset_stats()
    with profiler.enable():
        vp.render(1)
    s, syncs = w2.STATS, profiler.syncs()
    traces = sum(1 for r in profiler.records() if r.name == "wave2.trace")
    assert s["continuations"] > 0 and traces > 0
    assert syncs["wave2.live_count"] == traces
    assert syncs["wave2.unresolved"] == s["windows"] + s["continuations"]
    assert syncs["wave2.compact_mask"] == 7 * s["continuations"]
    assert syncs["wave2.live_count"] + syncs["wave2.unresolved"] == s["host_syncs"]
    assert syncs["viewport.counters"] == 5 and syncs["viewport.halton"] == 1
    assert sum(1 for r in profiler.records() if r.name == "host_sync") == sum(syncs.values())
    c = profiler.counters()
    assert 0 < c["wave2.pair_slots_real"] <= s["pair_slots"] <= c["wave2.pair_slots_sent"]
    rounds = [r for r in profiler.records() if r.name == "wave2.round"]
    assert len(rounds) == s["rounds"]
    # every stage of a round hangs under its round
    ids = {r.id for r in rounds}
    for stage in ("wave2.extract", "wave2.join", "wave2.mt", "wave2.select"):
        got = [r for r in profiler.records() if r.name == stage]
        assert len(got) == s["rounds"] and all(r.parent in ids for r in got)


def test_a_pass_hangs_under_its_pass_span(mesh_viewport):
    with profiler.enable():
        mesh_viewport.render(1)
    recs = {r.id: r for r in profiler.records()}
    (unit,) = [r for r in recs.values() if r.name == "frame.pass"]

    def root(r):
        while r.parent and recs[r.parent].name != "frame.render":
            r = recs[r.parent]
        return r

    inside = [r for r in recs.values() if r.name not in ("frame.render", "frame.pass")
              and not (r.name == "host_sync" and r.attrs["site"] in ("viewport.halton", "viewport.counters"))]
    assert inside and all(root(r).id == unit.id for r in inside)
    names = {r.name for r in recs.values()}
    assert {"frame.camera", "integrator", "integrator.bounce", "integrator.shading", "traverse", "traverse.prims",
            "traverse.mesh", "wave2.trace", "wave2.window", "wave2.round", "film.accumulate"} <= names


def test_a_span_holds_its_ops_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiler.tracing()
        with profiler.span("unit.mul"):
            (x * 3.0).sum()
    assert not profiler.tracing()
    (rec,) = profiler.records()
    events = list(prof.profiler.kineto_results.events())
    mul = [e for e in events if e.name() == "aten::mul"]
    assert mul and all(rec.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= rec.end_ns for e in mul)
    assert not any(e.name() == "unit.mul" for e in events)  # a span opens no record_function range


def synthetic():
    """Spans on one thread, in ns: a pass [0, 100] holds a join [10, 40]
    that holds a sync [30, 35], and an extract [50, 90]; a second pass
    [200, 300].  Device operations (name, start, end, launch)."""
    r = lambda name, a, b, i, p, **attrs: Record(name, a, b, i, p, 1, attrs)
    recs = [r("pass", 0, 100, 1, 0), r("join", 10, 40, 2, 1), r("host_sync", 30, 35, 3, 2, site="w.mask"),
            r("extract", 50, 90, 4, 1), r("pass", 200, 300, 5, 0)]
    ops = [("k1", 20, 32, 12), ("k2", 36, 40, 31), ("k3", 60, 70, 60), ("k4", 150, 151, 150),
           ("k5", 160, 161, None), ("k6", 250, 260, 250)]
    return recs, ops


def test_device_ms_by_span_on_synthetic_ops():
    recs, ops = synthetic()
    got = profiler.device_ms_by_span(ops, recs)
    ns = {"pass": 12 + 4 + 10 + 10, "join": 12 + 4, "host_sync": 4, "extract": 10, OUTSIDE: 1 + 1}
    assert got == pytest.approx({k: v * 1e-6 for k, v in ns.items()})


def test_idle_by_span_on_synthetic_ops():
    recs, ops = synthetic()
    got = profiler.idle_by_span(ops, recs)
    # the device ran dry at 32 (inside the sync), 40 (the join has closed: the pass), 70 (the
    # extract), 151 and 161 (outside every span)
    ns = {"host_sync[w.mask]": 4, "pass": 20, "extract": 80, OUTSIDE: 9 + 89}
    assert got == pytest.approx({k: v * 1e-6 for k, v in ns.items()})
    assert profiler.idle_by_span([], recs) == {} and profiler.device_ms_by_span([], recs) == {}


def test_cli_trace_writes_the_spans_beside_torchs_events(tmp_path, capsys):
    out, trace = str(tmp_path / "img.png"), str(tmp_path / "trace")
    assert cli.main(["--cpu", "--width", "8", "--height", "8", "--passes", "1", "--max-depth", "2",
                     "--output", out, "--trace", trace]) == 0
    printed = capsys.readouterr().out
    assert "spans by self time" in printed and "host syncs by site" in printed and "viewport.counters" in printed
    (name,) = os.listdir(trace)
    events = json.load(open(os.path.join(trace, name)))["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and {"frame.render", "frame.pass", "integrator", "host_sync", "display"} <= {e["name"] for e in spans}
    (render,) = [e for e in spans if e["name"] == "frame.render"]
    inside = [e for e in ops if render["ts"] <= e["ts"] <= render["ts"] + render["dur"]]
    assert len(inside) > len(ops) // 2  # the spans sit on the trace's time base
    assert not profiler.tracing()
