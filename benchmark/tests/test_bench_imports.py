"""No run loads JAX or the JAX package; the reference loads nothing of the
program either; a run without a card, with a program setting, or without
the program refuses and prints no result."""

import json
import os
import shutil
import subprocess
import sys


from conftest import BENCH, ROOT
from harness import guard

PY = sys.executable


def test_names_are_compared_whole():
    mods = {"raytracer_tpu_torch": 1, "raytracer_tpu_torch.ops": 1, "numpy": 1, "jaxtyping": 1}
    assert guard.loaded(modules=mods) == []
    assert guard.loaded(modules=dict(mods, **{"raytracer_tpu.ops": 1, "jax": 1})) == ["jax", "raytracer_tpu.ops"]
    assert guard.loaded(guard.FORBIDDEN_IN_REFERENCE, mods) == ["raytracer_tpu_torch", "raytracer_tpu_torch.ops"]
    assert guard.top_level("jaxlib.xla_client") == "jaxlib"


def test_program_settings_are_found():
    assert guard.program_settings({"RT_WAVE2_FTB": "1", "PATH": "x"}) == ["RT_WAVE2_FTB"]
    assert guard.program_settings({"PATH": "x"}) == []


def _loads(code: str) -> list:
    out = subprocess.run([PY, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys, json; sys.path.insert(0, 'benchmark/reference'); import rt.trace, rt.ops.traverse; "
            "print(json.dumps(sorted(sys.modules)))")
    mods = _loads(code)
    assert guard.loaded(guard.FORBIDDEN_IN_REFERENCE, mods) == []


def test_the_harness_loads_no_jax():
    code = ("import sys, json; sys.path[:0] = ['benchmark', '.']; from harness import runner, check; "
            "check.reference(); import run; print(json.dumps(sorted(sys.modules)))")
    mods = _loads(code)
    assert "raytracer_tpu_torch" in mods
    assert guard.loaded(modules=mods) == []


def _run(cwd, env=None, timeout=300):
    return subprocess.run([PY, "benchmark/run.py", "--workload", "cornell_render", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_without_a_card_a_run_refuses():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_a_program_setting_a_run_refuses():
    out = _run(ROOT, {"RT_TRAVERSAL_MODE": "bvh"})
    assert out.returncode != 0 and out.stdout.strip() == "" and "RT_TRAVERSAL_MODE" in out.stderr


def test_without_the_program_a_run_refuses(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
