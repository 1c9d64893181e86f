"""The PyTorch port imports no jax and nothing of the JAX package, keeps its
own copies of what it shares with it, and its kernel wrappers refuse devices
they have no kernel for."""

import os
import pkgutil
import re
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
              "io.obj", "native", "ops.cluster_traverse", "ops.pallas_traverse", "ops.bvh_traverse",
              "ops.launch_probe", "ops.cuda_build",
              "integrators.path_tracer", "render.film", "render.renderer",
              "color.colorhelpers", "ops.textures", "math.distribution", "io.exr", "io.bmp",
              "render.postprocess", "ops.wave_traverse", "parallel.mesh",
              "integrators.light_tracer", "integrators.vcm", "integrators.debug", "ops.hashgrid", "cli",
              "__main__", "io.png", "utils", "utils.logger", "utils.profiler", "math.packed",
              "render.adaptive", "render.checkpoint", "render.path_debug"):
        assert f"raytracer_tpu_torch.{m}" in mods, m


def test_importing_every_port_module_leaves_jax_out():
    # tests/conftest.py imports jax in this process, so check in a fresh one
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'raytracer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr[-2000:]


def test_gradient_tool_and_its_modules_leave_jax_out():
    """``tools/torch_check_gradients.py`` (and through it ``parallel/`` and
    ``ops/wave_traverse.py``) imports no jax and nothing of the JAX package."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import torch_check_gradients\n"
        "import raytracer_tpu_torch.parallel.mesh, raytracer_tpu_torch.ops.wave_traverse\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'raytracer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr[-2000:]


_FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|raytracer_tpu)(?![_\w])")


def _port_sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for tool in sorted(os.listdir(os.path.join(ROOT, "tools"))):
        if tool.startswith("torch_") and tool.endswith(".py"):
            yield os.path.join(ROOT, "tools", tool)
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not the package
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_port_source_mentions_a_jax_import():
    """No source of the port, of its tools or of chip_smoke.py imports jax or
    anything of the JAX package (``raytracer_tpu_torch`` itself is fine)."""
    assert _FOREIGN_IMPORT.match("from raytracer_tpu.io.obj import load_obj")
    assert _FOREIGN_IMPORT.match("    import raytracer_tpu  # path only")
    assert not _FOREIGN_IMPORT.match("from raytracer_tpu_torch.io.obj import load_obj")
    hits = []
    for path in _port_sources():
        for line in open(path):
            if _FOREIGN_IMPORT.match(line) or "raytracer_tpu.ops" in line:
                hits.append(f"{path}: {line.strip()}")
    assert not hits, hits


def test_port_keeps_no_binary_and_equal_copies():
    """The port's copies of the shared host files: the blue-noise table is
    byte-equal, the OBJ loader and the BVH builder differ from the JAX
    package's only in comments, and no built library sits in the package."""
    ref = os.path.join(ROOT, "raytracer_tpu")
    with open(os.path.join(PKG, "sampler", "bluenoise128.npy"), "rb") as a, \
            open(os.path.join(ref, "sampler", "bluenoise128.npy"), "rb") as b:
        assert a.read() == b.read()
    code = lambda path, mark: [ln for ln in open(path).read().splitlines() if not ln.lstrip().startswith(mark)]
    assert code(os.path.join(PKG, "native", "bvh_builder.cpp"), "//") == \
        code(os.path.join(ref, "native", "bvh_builder.cpp"), "//")
    with open(os.path.join(PKG, "io", "obj.py")) as a, open(os.path.join(ref, "io", "obj.py")) as b:
        assert a.read() == b.read()
    built = [f for dirpath, dirs, files in os.walk(PKG) if "_build" not in dirpath
             for f in files if f.endswith((".so", ".o", ".a"))]
    assert not built, built


def test_native_builder_is_built_under_the_build_directory():
    from raytracer_tpu_torch import native

    lib = native.load_library("bvh_builder")
    assert lib is native.load_library("bvh_builder")  # loaded once
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert re.fullmatch(r"libbvh_builder-[0-9a-f]{12}\.so", os.path.basename(lib._name))
    with pytest.raises(FileNotFoundError):
        native.load_library("no_such_source")


def test_mt_wrapper_raises_on_a_device_without_a_kernel():
    from raytracer_tpu_torch.ops.wave2_traverse import mt_chunks

    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    pairs = [meta(1, 8, 128) for _ in range(7)]
    with pytest.raises(ValueError, match="unsupported device"):
        mt_chunks(meta(1, dt=torch.int32), meta(1, 64, 16), meta(1, 8, 8), *pairs, any_hit=False)


def test_add_one_wrapper_raises_on_a_device_without_a_kernel():
    from raytracer_tpu_torch.ops.launch_probe import add_one

    with pytest.raises(ValueError, match="unsupported device"):
        add_one(torch.empty((2048, 128), device="meta"))
    x = torch.arange(2048 * 128, dtype=torch.float32).reshape(2048, 128)
    for grid in (False, True):
        assert torch.equal(add_one(x, grid=grid), x + 1.0)  # CPU tensors take the plain version
    assert add_one.launches == 0
