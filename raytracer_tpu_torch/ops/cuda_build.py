"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled with ``nvcc`` into a shared library with a plain C
interface, under ``raytracer_tpu_torch/_build/`` (git-ignored), and loaded
with ctypes.  The library name carries a hash of the source and flags, so
an edited kernel is rebuilt and a built one is reused.  Nothing here runs
at import time: the CPU tests import every module on a host with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false and no fast math: every product and sum rounds as the plain
# PyTorch twin's separate ops round them, so kernel and twin agree bit for bit
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build time (0.0 if reused), "log": nvcc/ptxas output}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are built with it")


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        info = {"seconds": 0.0, "log": "reused " + out}
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                 capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr[-4000:]}")
            os.replace(tmp, out)
            info = {"seconds": time.perf_counter() - t0, "log": (res.stdout + res.stderr).strip()}
        lib = ctypes.CDLL(out)
        BUILD_INFO[name] = info
        _LIBS[name] = lib
        return lib
