"""Time variants of the wave2 Möller-Trumbore kernel on the card in one run.

    python tools/torch_tune_wave2.py [SOURCE.cu][,-DNAME=VALUE...] ...

Each argument is one variant: a CUDA source with the C interface of
``raytracer_tpu_torch/csrc/wave2_mt.cu`` (that file when none is named) and
extra ``nvcc`` flags, comma-separated; an empty argument is the kernel as it
stands.  Every variant is built with ``cuda_build.NVCC_FLAGS`` into a
temporary library, put in the place of the wrapper's launch function, held
against the plain twin on one real window of 65,536 incoherent rays against
the 200k-triangle mesh (closest-hit and any-hit; EQ or DIFF), and timed there
and at the five ``probe_mt_chunks`` sizes.  One line per variant: flags,
registers, spills, times in ms.  Needs one CUDA device and ``nvcc``.  Times
of two variants compare within one run only.
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("this tool needs one CUDA device")
    variants = [[f for f in arg.split(",") if f] for arg in sys.argv[1:]] or [[]]
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}")
    verts, faces = bench_mesh.make_mesh(200_000)
    tri = verts[faces].astype(np.float32)
    cs = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], device=dev)
    o, d = tct.incoherent_rays(w2.SUBWAVE, np.random.default_rng(7))
    window = {any_hit: tct._window_chunks(cs, o, d, tl, dev) for any_hit, tl in ((False, tct.BIGF), (True, 4.0))}
    want = {any_hit: w2.mt_chunks_reference(*window[any_hit], any_hit=any_hit) for any_hit in window}
    key = ("wave2_mt", "wave2_mt_launch")
    with tempfile.TemporaryDirectory() as tmp:
        for i, flags in enumerate(variants):
            sources = [f for f in flags if f.endswith(".cu")]
            src = sources[0] if sources else os.path.join(cuda_build.CSRC_DIR, "wave2_mt.cu")
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
            fn = ctypes.CDLL(out).wave2_mt_launch
            fn.argtypes, fn.restype = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
            cuda_build._FUNCS[key] = fn  # the wrapper now launches this variant
            cells = []
            for any_hit, args in window.items():
                got = w2.mt_chunks(*args, any_hit=any_hit)
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(got, want[any_hit]))
                ms = tct.cuda_ms(lambda: w2.mt_chunks(*args, any_hit=any_hit))
                cells.append(f"{'any-hit' if any_hit else 'closest'} {'EQ' if same else 'DIFF'} {ms:.4f}")
            probe = tpl.probe_mt_chunks(cs, dev, log=lambda *a: None)
            print(flags, regs, spills, "| window:", *cells, "| 64 live, 64 sentinel, 512, 1024, 4096 chunks:",
                  " ".join(f"{v:.4f}" for v in probe.values()), flush=True)
    cuda_build._FUNCS.pop(key, None)


if __name__ == "__main__":
    main()
