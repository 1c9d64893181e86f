"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled with ``nvcc`` into a shared library with a plain C
interface, under ``raytracer_tpu_torch/_build/`` (git-ignored), and loaded
with ctypes.  The library name carries a hash of the source, of the shared
headers (``csrc/*.cuh``) and of the flags, so an edited kernel is rebuilt and
a built one is reused.  ``build_kernel_libraries`` starts one ``nvcc`` per
source, all together.  Nothing here runs at import time: the CPU tests
import every module on a host with no nvcc.

``launch`` is the one way the ops call a kernel: every C launch function
takes its pointers and C ints in order and the stream last, and returns its
``cudaError``.  ``launch_counts()`` counts the launches by library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter

import torch

from ..utils.profiler import count, span

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
_FUNCS: dict[tuple[str, str], object] = {}
# (library, symbol, argument types) -> profiler counter name, for the types a call was checked with
_CHECKED: dict[tuple, str] = {}
_LAUNCHES = Counter()  # library -> launches since the process began
# per kernel: {"seconds": build time (0.0 if reused), "log": nvcc/ptxas output}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are built with it")


def _paths(name: str):
    """(source, output library) of kernel ``name``."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_kernel_libraries(names) -> None:
    """Build every not-yet-built ``csrc/<name>.cu`` of ``names``, one nvcc
    process each, all started together; raises if one fails."""
    with _LOCK:
        jobs = []
        for name in names:
            src, out = _paths(name)
            if name in _LIBS or os.path.exists(out):
                BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "reused " + out})
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((name, src, out, tmp, proc, time.perf_counter()))
        failed = []
        for name, src, out, tmp, proc, t0 in jobs:
            try:
                stdout, stderr = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
                stderr += "\nnvcc timed out"
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src}:\n{stderr[-4000:]}")
                continue
            os.replace(tmp, out)
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": (stdout + stderr).strip()}
        if failed:
            raise RuntimeError("\n".join(failed))


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library: a
    span ``build.<name>``, ``built`` False where a built library was reused."""
    if name not in _LIBS:
        with span("build." + name, built=not os.path.exists(_paths(name)[1])):
            build_kernel_libraries([name])
            with _LOCK:
                if name not in _LIBS:
                    _LIBS[name] = ctypes.CDLL(_paths(name)[1])
    return _LIBS[name]


def kernel_function(name: str, symbol: str, argtypes):
    """The C launch function ``symbol`` of ``csrc/<name>.cu``, resolved and
    typed once per process; it returns the CUDA error of its launch as an
    int (0 = none)."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load_kernel_library(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def _check_call(name: str, symbol: str, sig: tuple) -> str:
    """Types ``symbol`` from the kinds of its first call's arguments and
    holds every later call's types ``sig`` to them; returns the call's
    profiler counter name."""
    types = []
    for i, t in enumerate(sig):
        if issubclass(t, torch.Tensor) or t is type(None):
            types.append(ctypes.c_void_p)
        elif issubclass(t, int):  # bool too
            types.append(ctypes.c_int)
        else:
            raise TypeError(f"{symbol}: argument {i} is a {t.__name__}, not a tensor, None or int")
    types.append(ctypes.c_void_p)  # the stream
    typed = list(kernel_function(name, symbol, types).argtypes)
    if typed != types:
        raise TypeError(f"{symbol}: called with {[t.__name__ for t in types]}, typed at its first call as "
                        f"{[t.__name__ for t in typed]}")
    _CHECKED[(name, symbol, sig)] = counter = "launches." + name
    return counter


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as its ``cudaStream_t``:
    the lookup torch's own generated kernels make.  ``torch.cuda.current_stream``
    builds a ``Stream`` object on the way: 4.4-5.5 µs a call against 0.12 µs
    on an H100's host, where the hall's passes are paced by the host."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, symbol: str, *args, device: torch.device) -> None:
    """Call the C launch function ``symbol`` of ``csrc/<name>.cu`` on
    ``device``'s current stream.  A tensor passes its ``data_ptr()``,
    ``None`` a null pointer, an ``int`` or ``bool`` a C int; the stream goes
    last.  The argument types are fixed at the first call from the
    arguments' kinds, and a later call of other kinds raises ``TypeError``.
    Raises ``RuntimeError`` when the launch is refused.  Counts the launch
    under ``name`` (``launch_counts``) and, while tracing, in the counter
    ``launches.<name>``."""
    sig = tuple(map(type, args))
    counter = _CHECKED.get((name, symbol, sig)) or _check_call(name, symbol, sig)
    index = device.index
    rc = _FUNCS[name, symbol](*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                              _raw_stream(torch.cuda.current_device() if index is None else index))
    if rc != 0:
        raise RuntimeError(f"{symbol} of csrc/{name}.cu failed to launch: cudaError {rc}")
    _LAUNCHES[name] += 1
    count(counter)


def launch_counts() -> Counter:
    """A copy of the launches so far by library; ``launch_counts() - before``
    gives those since ``before`` (a library that launched none reads 0)."""
    return Counter(_LAUNCHES)
