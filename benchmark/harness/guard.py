"""What a run checks about its process: the environment it starts in, where
build caches go, and the modules it may not load."""

from __future__ import annotations

import os
import sys

# top-level module names no run may load: JAX, and the JAX package the
# program was ported from.  Compared whole: ``raytracer_tpu_torch`` is the
# program, not ``raytracer_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")
# ... and the reference may not load the program either
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("raytracer_tpu_torch",)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(forbidden=FORBIDDEN, modules=None) -> list[str]:
    """Names in ``sys.modules`` (or ``modules``) whose top-level name is
    one of ``forbidden``, compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in forbidden)


def program_settings(environ=None) -> list[str]:
    """Settings of the program in the environment (``RT_*``): a cell runs
    the program's defaults, so any is an error (as ``chip_smoke.py``'s
    ``check_clean_environment`` holds)."""
    env = os.environ if environ is None else environ
    return sorted(k for k in env if k.startswith("RT_"))


def set_cache_dirs(root: str):
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run compiles.  The program's nvcc and g++
    libraries go to its own ``raytracer_tpu_torch/_build``; these cover
    anything built through torch or Triton."""
    cache = os.path.join(root, "benchmark", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
