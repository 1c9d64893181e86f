"""A run driven end to end on the CPU at a tiny size: the shape of its
last line, the control failing the comparison, and the comparison failing
each fault of the timed path that a cell can have.

The harness's look for a card is skipped (``runner.run`` is called on the
CPU); everything after it runs as on the card, the program's CUDA kernels
replaced by their plain twins as the program does on the CPU."""

import json
import time

import numpy as np
import pytest
import torch

from conftest import tiny
from harness import cells, check, loops, runner, scenes

grad, viewer = cells.load_module("loops", "grad"), cells.load_module("loops", "viewer")

SEED = 2**31 + 977  # more than 32 signed bits hold


def small_cell(name, **traffic):
    """The cell at a tiny size; the grad cell on the Cornell box, which the
    CPU traces in seconds (the hall's wave2 twin takes minutes a pass)."""
    cell = tiny(cells.find(name), **traffic)
    if cell.traffic["loop"] == "grad":
        box = cells.find("cornell_render")
        cell.config_name, cell.config = box.config_name, box.config
    return cell


def run(name, seconds=0.5, trace=False, **traffic):
    return runner.run(small_cell(name, **traffic), SEED, seconds, trace, "cpu", time.perf_counter(), lambda m: None)


def test_last_line_shape():
    result = run("cornell_render")
    err, line = runner.result_lines(result)
    got = json.loads(line)
    assert list(got)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device", "checks"} <= set(got)
    assert got["correct"] is True and got["failed"] == 0 and got["attempted"] >= 1
    assert set(got["metrics"]) == {"pass_ms", "setup_s"}
    assert all(m["unit"] and m["value"] > 0 for m in got["metrics"].values())
    assert set(got["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert err[0] == "correct: True" and all("limit" in e for e in err[1:]) and len(err) == 3
    assert set(got["checks"]) == {"mismatch_share", "mean_gap"}


def test_a_traced_cpu_run_writes_no_device_metric():
    """On the CPU the trace holds no device operation: the counters'
    metrics are read, the device trace's are left out, never zero."""
    result = run("cornell_render", trace=True)
    assert set(result["metrics"]) == {"rays_per_pass.render"}
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
    assert result["breakdown"] == {"device_ops": [], "idle_gaps": []}


@pytest.mark.card
@pytest.mark.parametrize("name", ["cornell_render", "interior800k_render"])
def test_traced_card_run_has_every_per_layer_metric(card, name):
    import subprocess
    import sys

    from conftest import ROOT

    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(SEED),
                          "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True and list(got)[-1] == "checks"
    assert {m["name"] for m in cells.find(name).per_layer} == set(got["metrics"])
    assert 0 < got["device"]["busy_s"] <= got["device"]["window_s"]


@pytest.mark.parametrize("name", ["cornell_render", "cornell_viewer", "interior800k_grad"])
def test_sound_runs_are_correct(name):
    assert run(name, segment_frames=2)["correct"] is True


@pytest.mark.parametrize("name,units", [("cornell_render", 6), ("cornell_viewer", 6), ("interior800k_grad", 3)])
def test_control_fails(name, units):
    cell = small_cell(name, segment_frames=2)
    scene_file = scenes.scene_path(cell.config_name, cell.config)
    found = check.control_numbers(cell, scene_file, SEED, "cpu", units)
    assert check.judge(found, cell.limits)[0] is False, found


def _unchanged(monkeypatch):
    """A unit that leaves its state as it was: a pass that does not add to
    the film (but counts itself); a step that returns the first step's
    loss and gradients again."""
    import raytracer_tpu_torch.parallel.mesh as pm
    import raytracer_tpu_torch.render.renderer as r

    real = r.accumulate_frame
    monkeypatch.setattr(r, "accumulate_frame", lambda film, rad, use_secondary: real(film, rad, use_secondary)._replace(
        sum=film.sum))
    step, first = pm._band_step, []

    def stale(*a, **k):
        if not first:
            first.append(step(*a, **k))
        return first[0]

    monkeypatch.setattr(pm, "_band_step", stale)


def _radiance(monkeypatch, change):
    """``change`` applied to the radiance the integrator hands the film
    and the training step."""
    import raytracer_tpu_torch.parallel.mesh as pm
    import raytracer_tpu_torch.render.renderer as r
    from raytracer_tpu_torch.math.vec import Vec3

    real = r.trace_radiance

    def changed(*a, **k):
        rad, c = real(*a, **k)
        w = change(rad.x)
        return Vec3(rad.x * w, rad.y * w, rad.z * w), c

    monkeypatch.setattr(r, "trace_radiance", changed)
    assert pm.trace_rows is r.trace_rows  # the step traces through the same integrator call


def _half_batch(monkeypatch):
    """Half of each unit's lanes left out, the rest weighted double (the
    mean over the rest)."""
    _radiance(monkeypatch, lambda x: (torch.arange(x.shape[0]) % 2 == 0).to(x.dtype) * 2.0)


def _altered(monkeypatch):
    """Each answer altered where it is produced: radiance off by 1%."""
    _radiance(monkeypatch, lambda x: 1.01)


@pytest.mark.parametrize("name", ["cornell_render", "cornell_viewer", "interior800k_grad"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_faults_of_the_timed_path_are_caught(monkeypatch, name, fault):
    fault(monkeypatch)
    assert run(name, segment_frames=2)["correct"] is False


def test_the_grad_check_never_compares_step_0():
    """Step 0 would pass a run whose steps all return the first step's
    answer, so it is compared only where it is the only step."""
    assert grad.step_compared(SEED, 1) == 0
    for units in (2, 3, 50):
        assert all(grad.step_compared(s, units) >= 1 for s in range(SEED, SEED + 200))


def test_a_stale_step_is_caught_on_a_seed_that_could_draw_step_0(monkeypatch):
    units = 3
    seed = next(s for s in range(SEED, SEED + 100) if check.sample(s, 4, units, 1)[0] == 0)
    _unchanged(monkeypatch)
    cell = small_cell("interior800k_grad")
    scene_file = scenes.scene_path(cell.config_name, cell.config)
    loop = loops.make(cell, scene_file, seed, torch.device("cpu"))
    loop.setup()  # the warm-up step is the first answer the fault keeps
    loop.pass_idx = 0
    steps = [loop.step() for _ in range(units)]
    out = {"steps": [(float(loss), [g.detach() for g in grads]) for loss, grads in steps], "target": loop.target}
    found = check.numbers(cell, scene_file, out, seed, "cpu")
    assert found["step"] >= 1 and check.judge(found, cell.limits)[0] is False, found


def test_camera_path_is_the_seeds():
    a = viewer.camera_path(SEED, {"translation": [0, 1, -3.6]}, 16, 0.1, 3.0, [[-0.4, -0.3, -0.5], [0.4, 0.3, 0.5]])
    b = viewer.camera_path(SEED, {"translation": [0, 1, -3.6]}, 16, 0.1, 3.0, [[-0.4, -0.3, -0.5], [0.4, 0.3, 0.5]])
    c = viewer.camera_path(SEED + 1, {"translation": [0, 1, -3.6]}, 16, 0.1, 3.0, [[-0.4, -0.3, -0.5], [0.4, 0.3, 0.5]])
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    pos = np.array([p[0] for p in a])
    assert (pos[:, 0] >= -0.4 - 1e-9).all() and (pos[:, 0] <= 0.4 + 1e-9).all()
