"""Time variants of the port's traversal kernels on the card in one run.

    python tools/torch_tune_wave2.py [KERNEL] [SOURCE.cu][,-DNAME=VALUE...] ...

KERNEL is ``wave2_mt`` (the default), ``phase2_stream`` or ``phase2_grid``.
Each further argument is one variant: a CUDA source with the C interface of
``raytracer_tpu_torch/csrc/KERNEL.cu`` (that file when none is named; a
source finds the headers beside it first) and extra ``nvcc`` flags,
comma-separated; an empty argument is the kernel as it stands.  Every variant
is built with ``cuda_build.NVCC_FLAGS`` into a temporary library, put in the
place of the wrapper's launch function, held against the plain version (EQ or
DIFF) and timed, on cases that are built once:

- ``wave2_mt``: one real window of 65,536 incoherent rays against the
  200k-triangle mesh (closest-hit and any-hit), and the five
  ``probe_mt_chunks`` sizes;
- ``phase2_stream`` / ``phase2_grid``: that kernel's cases of
  ``torch_check_traverse.phase2_cases`` (the path's shapes timed, the tie and
  edge cases and the K = 8 / 128 sets held only).

One line per variant: flags, registers, spills, times in ms.  Needs one CUDA
device and ``nvcc``.  Times of two variants compare within one run only.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_mesh  # noqa: E402
import torch_check_traverse as tct  # noqa: E402
import torch_probe_launch as tpl  # noqa: E402
from raytracer_tpu_torch.ops import cuda_build  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.scene.clusters import build_clusters  # noqa: E402

# kernel -> (launch symbol, its ctypes argument types)
LAUNCH = {
    "wave2_mt": ("wave2_mt_launch", [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "phase2_grid": ("phase2_grid_launch", [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "phase2_stream": ("phase2_stream_launch", [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def wave2_cells(cs, dev):
    """Returns a function that holds and times the wave2 kernel as installed."""
    o, d = tct.incoherent_rays(w2.SUBWAVE, np.random.default_rng(7))
    window = {any_hit: tct._window_chunks(cs, o, d, tl, dev) for any_hit, tl in ((False, tct.BIGF), (True, 4.0))}
    want = {any_hit: w2.mt_chunks_reference(*window[any_hit], any_hit=any_hit) for any_hit in window}

    def cells():
        out = ["| window:"]
        for any_hit, args in window.items():
            got = w2.mt_chunks(*args, any_hit=any_hit)
            torch.cuda.synchronize()
            ms = tct.cuda_ms(lambda: w2.mt_chunks(*args, any_hit=any_hit))
            out.append(f"{'any-hit' if any_hit else 'closest'} {'EQ' if _same(got, want[any_hit]) else 'DIFF'} {ms:.4f}")
        probe = tpl.probe_mt_chunks(cs, dev, log=lambda *a: None)
        return out + ["| 64 live, 64 sentinel, 512, 1024, 4096 chunks:", " ".join(f"{v:.4f}" for v in probe.values())]

    return cells


def phase2_cells(kernel, cs, dev):
    """Returns a function that holds and times one phase-2 kernel as installed."""
    cases = [c for c in tct.phase2_cases(cs, dev) if c["kernel"] == kernel]
    want = [c["plain"](None) for c in cases]

    def cells():
        out, held = [], []
        for case, w in zip(cases, want):
            got = case["run"]()
            torch.cuda.synchronize()
            same = "EQ" if _same(got, w) else "DIFF"
            if case["timed"]:
                out.append(f"| {case['label']}: {same} {tct.cuda_ms(case['run']):.4f}")
            else:
                held.append(same)
        return out + [f"| {len(held)} tie, edge and K = 8 / 128 cases:", " ".join(held)]

    return cells


def main():
    if not torch.cuda.is_available():
        raise SystemExit("this tool needs one CUDA device")
    args = sys.argv[1:]
    kernel = args.pop(0) if args and args[0] in LAUNCH else "wave2_mt"
    variants = [[f for f in arg.split(",") if f] for arg in args] or [[]]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi}); kernel: {kernel}")
    verts, faces = bench_mesh.make_mesh(200_000)
    tri = verts[faces].astype(np.float32)
    cs = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], device=dev)
    cells = wave2_cells(cs, dev) if kernel == "wave2_mt" else phase2_cells(kernel, cs, dev)
    symbol, argtypes = LAUNCH[kernel]
    with tempfile.TemporaryDirectory() as tmp:
        for i, flags in enumerate(variants):
            sources = [f for f in flags if f.endswith(".cu")]
            src = sources[0] if sources else os.path.join(cuda_build.CSRC_DIR, f"{kernel}.cu")
            out = os.path.join(tmp, f"variant{i}.so")
            built = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR,
                                    *(f for f in flags if f not in sources), "-o", out, src],
                                   capture_output=True, text=True)
            if built.returncode:
                print(flags, "BUILD FAILED\n" + built.stderr[-2000:], flush=True)
                continue
            info = built.stderr.splitlines()
            regs = [line.split("Used ")[1].split(",")[0] for line in info if "Used" in line]
            spills = [line.strip() for line in info if "spill" in line and "0 bytes spill stores" not in line]
            fn = getattr(ctypes.CDLL(out), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            cuda_build._FUNCS[(kernel, symbol)] = fn  # the wrapper now launches this variant
            try:
                print(flags, regs, spills, *cells(), flush=True)
            except RuntimeError as exc:  # a refused launch or a fault: say so and go on to the next variant
                print(flags, regs, spills, f"FAILED: {exc}", flush=True)
    cuda_build._FUNCS.pop((kernel, symbol), None)


if __name__ == "__main__":
    main()
