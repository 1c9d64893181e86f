"""Native (C++) host components of the port, built with g++ and loaded with
ctypes (port of ``raytracer_tpu/native/__init__.py``).

``bvh_builder.cpp`` is the sweep-SAH BVH builder whose leaf order fixes the
triangle ids.  It is compiled at first use into ``raytracer_tpu_torch/_build/``
(git-ignored) under a name that carries a hash of the source and the flags,
so an edited source is rebuilt and a built one is reused; no binary is
kept in the repository.  The flags name no host architecture and forbid
contraction to FMA, so every host orders SAH ties the same way.  A failed
build raises: a slower builder could order ties differently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from ..utils.profiler import span

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``native/<name>.cpp``; raises when g++ is
    missing or the build fails."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(_DIR, f"{name}.cpp")
        with open(src, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
        out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        with span("build." + name, built=not os.path.exists(out)):
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                try:
                    res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src],
                                         capture_output=True, text=True, timeout=300)
                except (OSError, subprocess.TimeoutExpired) as e:
                    raise RuntimeError(f"g++ could not build {src}: {e}") from e
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed for {src}:\n{res.stderr[-4000:]}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
        _LIBS[name] = lib
        return lib
