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
              "render.adaptive", "render.checkpoint", "render.path_debug", "entry", "parallel.launch"):
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


NEW_TOOLS = ("torch_traversal_bench", "torch_check_wave2", "torch_check_pallas", "torch_microbench",
             "torch_probe_render", "torch_scaling_bench", "torch_check_helpers")


def test_entry_and_the_tools_leave_jax_out():
    """``raytracer_tpu_torch/entry.py`` and the counterparts of the
    reference's traversal, oracle, micro-bench, probe and scaling tools
    import no jax and nothing of the JAX package."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        f"for m in {NEW_TOOLS!r}:\n"
        "    __import__(m)\n"
        "import raytracer_tpu_torch.entry\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'raytracer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr[-2000:]


# Public top-level names of the JAX package without a counterpart of the
# same name in the port's module of the same path, by decision:
NOT_PORTED = {
    # a one-hot matmul for the TPU's matrix unit; plain indexing returns the
    # same table values (ROADMAP "Decisions")
    "ops/smallgather.py": None,
    # a typing alias of floats and jnp arrays
    ("math/vec.py", "Scalar"): None,
    # renamed: the port has no jax_ names
    ("math/distribution.py", "jax_searchsorted_rows"): "searchsorted_rows",
    # nothing called the decorator; spans are ``span`` / ``scoped_timer``
    ("utils/profiler.py", "profiled"): None,
    # its record_function range put an event on the device timeline that a
    # trace's reader counts as a device operation; a span shares the
    # profiler's clock instead
    ("utils/profiler.py", "device_trace"): None,
}


def _public_names(path, imported=False):
    """The module's public top-level definitions and assignments (and, with
    ``imported``, the names it imports)."""
    import ast

    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_of_the_reference_has_a_counterpart():
    ref = os.path.join(ROOT, "raytracer_tpu")
    missing = []
    for dirpath, _, files in os.walk(ref):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref)
            port = os.path.join(PKG, rel)
            if not os.path.exists(port):
                if rel not in NOT_PORTED:
                    missing.append(rel)
                continue
            have = _public_names(port, imported=True)
            for name in sorted(_public_names(os.path.join(dirpath, f)) - have):
                key = (rel, name)
                if key not in NOT_PORTED:
                    missing.append(f"{rel}::{name}")
                elif NOT_PORTED[key] is not None:
                    assert NOT_PORTED[key] in have, key
    assert not missing, missing


_ENV_NAME = re.compile(r"""["'](RT_[A-Z0-9_]+)["']""")


def _env_names(root, skip=()):
    """The ``RT_*`` names that the Python sources under ``root`` read: every
    string literal of that form."""
    names = set()
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in skip]
        for f in files:
            if f.endswith(".py"):
                names.update(_ENV_NAME.findall(open(os.path.join(dirpath, f)).read()))
    return names


def test_every_environment_variable_of_the_reference_is_read_by_the_port():
    """Every ``RT_*`` setting that the JAX package reads (the traversal mode,
    the log level, wave2's extraction order, candidates, chunk size,
    continuation size, pair key, and the two ablation switches) is read by
    the port too."""
    ref = _env_names(os.path.join(ROOT, "raytracer_tpu"))
    port = _env_names(PKG, skip=("_build",))
    assert {"RT_WAVE2_FTB", "RT_WAVE2_CHUNK", "RT_SKIP_TRI_FRAME"} <= ref
    assert not ref - port, sorted(ref - port)


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
    byte-equal, the OBJ loader differs from the JAX package's only in
    comments, the BVH builder's tree build (all before its C interface,
    which hands the children to the link threading as int32 arrays, not in
    float lanes) likewise, and no built library sits in the package."""
    ref = os.path.join(ROOT, "raytracer_tpu")
    with open(os.path.join(PKG, "sampler", "bluenoise128.npy"), "rb") as a, \
            open(os.path.join(ref, "sampler", "bluenoise128.npy"), "rb") as b:
        assert a.read() == b.read()
    code = lambda path, mark: [ln for ln in open(path).read().split('extern "C"')[0].splitlines()
                               if not ln.lstrip().startswith(mark)]
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
    from raytracer_tpu_torch.ops.cuda_build import launch_counts
    from raytracer_tpu_torch.ops.launch_probe import add_one

    before = launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        add_one(torch.empty((2048, 128), device="meta"))
    x = torch.arange(2048 * 128, dtype=torch.float32).reshape(2048, 128)
    for grid in (False, True):
        assert torch.equal(add_one(x, grid=grid), x + 1.0)  # CPU tensors take the plain version
    assert launch_counts() == before
