"""The PyTorch port imports no jax, and its kernel wrapper refuses devices it
has no kernel for."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import raytracer_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(raytracer_tpu_torch.__file__)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="raytracer_tpu_torch.")
    )


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("math.vec", "math.transform", "math.sampling", "math.microfacet", "math.fresnel",
              "sampler.sampler", "scene.types", "scene.bvh", "scene.clusters", "scene.build",
              "scene.camera", "scene.convert", "io.scene_loader", "ops.intersect",
              "ops.wave2_traverse", "ops.traverse", "ops.bsdf", "ops.materials", "ops.lights",
              "integrators.path_tracer", "render.film", "render.renderer"):
        assert f"raytracer_tpu_torch.{m}" in mods, m


def test_importing_every_port_module_leaves_jax_out():
    # tests/conftest.py imports jax in this process, so check in a fresh one
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr[-2000:]


def test_no_port_source_mentions_a_jax_import():
    hits = []
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not the package
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                for line in open(path):
                    s = line.strip()
                    if s.startswith(("import jax", "from jax")) or "raytracer_tpu.ops" in s:
                        hits.append(f"{path}: {s}")
    assert not hits, hits


def test_mt_wrapper_raises_on_a_device_without_a_kernel():
    from raytracer_tpu_torch.ops.wave2_traverse import mt_chunks

    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    pairs = [meta(1, 8, 128) for _ in range(7)]
    with pytest.raises(ValueError, match="unsupported device"):
        mt_chunks(meta(1, dt=torch.int32), meta(1, 64, 16), meta(1, 8, 8), *pairs, any_hit=False)
