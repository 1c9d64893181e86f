"""Dispatch and kernel-size probes of the PyTorch/CUDA port (counterpart of
the ``xla_add`` / ``triv`` / ``triv_grid`` probes of ``tools/probe_r4.py``
and of ``tools/probe_r5c.py::stage_pallas``).

    python tools/torch_probe_launch.py

Needs one CUDA device.  ``probe_dispatch``: the cost per call of ``x + 1``
on a (2048, 128) float32 array through PyTorch, through the hand-written
``add_one`` kernel as one grid sized to the card, and as 256 thread blocks,
chained (each call reads the one before), beside a kernel that does nothing.
``probe_mt_chunks``: the bare wave2 Möller-Trumbore kernel at 64 (live and
all-sentinel), 512, 1,024 and 4,096 chunks, which separates its fixed cost
from its size-dependent cost; before it, the kernel is held against its twin
and timed at one real window.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.ops.launch_probe import add_one, add_one_reference, empty_launch  # noqa: E402
from torch_check_traverse import check_wave2_kernel, cuda_ms, incoherent_rays  # noqa: E402

PROBE_SHAPE = (2048, 128)


def chain_us(fn, x, reps=200):
    """Dependency-chained timing: y = fn(y) ``reps`` times, then wait for the
    device.  Microseconds per call on the host's clock."""
    y = fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn(y)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def graph_us(fn, x, n=100, reps=20):
    """Device microseconds per call: ``n`` chained calls are captured into
    one CUDA graph, so the host's dispatch drops out and what remains is the
    kernels and the gaps between them on the device.  Median of ``reps``
    replays (CUDA events) over ``n``."""
    fn(x)  # build and load before capturing
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x
        for _ in range(n):
            y = fn(y)
    return cuda_ms(graph.replay, reps=reps) / n * 1e3


def check_add_one(dev, log=print) -> float:
    """``add_one`` in both launch forms against its plain version: equal or
    exit.  The probe's shape, sizes that end in a partial tile or a partial
    float4, and a view that starts 4 bytes past a 16-byte boundary.  Returns
    the largest absolute difference."""
    n_probe = PROBE_SHAPE[0] * PROBE_SHAPE[1]
    base = torch.arange(n_probe + 4, dtype=torch.float32, device=dev)
    inputs = [("the probe's shape", base[:n_probe].reshape(PROBE_SHAPE))]
    inputs += [(f"{n} elements", base[:n]) for n in (1, 1023, 1025, n_probe + 3)]
    inputs += [(f"{n} elements, unaligned", base[1:1 + n]) for n in (1024, n_probe + 3)]
    err = 0.0
    for label, x in inputs:
        for grid in (False, True):
            got, want = add_one(x, grid=grid), add_one_reference(x)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise SystemExit(f"FAIL: add_one(grid={grid}) differs from its plain version ({label})")
    log(f"ok: add_one equals its plain version bit for bit in both launch forms ({len(inputs)} inputs: "
        f"{', '.join(label for label, _ in inputs)})")
    return err


def probe_dispatch(dev, log=print):
    """Microseconds per chained call of ``x + 1`` through PyTorch and through
    the ``add_one`` kernel in both launch forms: dispatched from the host
    (``*_us``, host clock) and replayed from a CUDA graph (``*_graph_us``,
    device time without the host's dispatch).  ``empty_graph_us`` is a kernel
    that does nothing in the same replay: the floor of a launch."""
    x = torch.zeros(PROBE_SHAPE, dtype=torch.float32, device=dev)

    def empty(y):
        empty_launch(dev)
        return y

    # torch first and last: the order of the forms is not what separates them
    forms = (("torch_add", add_one_reference), ("add_one", lambda y: add_one(y, grid=False)),
             ("add_one_grid", lambda y: add_one(y, grid=True)), ("empty", empty),
             ("torch_add_again", add_one_reference))
    out = {}
    for name, fn in forms:
        out[f"{name}_us"] = chain_us(fn, x)
        out[f"{name}_graph_us"] = graph_us(fn, x)
    for key, what in (("us", "dispatched from the host"), ("graph_us", "replayed from a CUDA graph")):
        log(f"dispatch probe {PROBE_SHAPE} f32, chained, {what}, us per call: torch x+1 "
            f"{out['torch_add_' + key]:.3f} (again after the others: {out['torch_add_again_' + key]:.3f}), "
            f"add_one as one block per SM {out['add_one_' + key]:.3f}, "
            f"add_one as 256 blocks {out['add_one_grid_' + key]:.3f}, an empty kernel {out['empty_' + key]:.3f}")
    return out


def probe_mt_chunks(cs, dev, log=print, sizes=((64, True), (64, False), (512, True), (1024, True), (4096, True))):
    """Milliseconds of one ``mt_chunks`` launch per (chunks, live) size: the
    chunk table names real supers in turn, or only the sentinel.  The gates
    that open on these rays (counted by the twin) are the work it did."""
    rng = np.random.default_rng(7)
    n_sup = cs.num_supers
    out = {}
    for b2, live in sizes:
        tab = (torch.arange(b2, dtype=torch.int32, device=dev) % n_sup) if live else \
            torch.full((b2,), n_sup, dtype=torch.int32, device=dev)
        o, d = incoherent_rays(b2 * w2.CHUNK, rng)
        ch = lambda a: torch.as_tensor(a, device=dev).reshape(b2, w2.ROWS, 128).contiguous()
        pairs = [ch(o[:, i]) for i in range(3)] + [ch(d[:, i]) for i in range(3)]
        pairs.append(torch.full((b2, w2.ROWS, 128), 100.0, device=dev))
        args = (tab, cs.super_geom, cs.super_sbox, *pairs)
        ms = cuda_ms(lambda: w2.mt_chunks(*args, any_hit=False), reps=10)
        stats = {}
        w2.mt_chunks_reference(*args, any_hit=False, stats=stats)
        out[(b2, live)] = ms
        log(f"mt_chunks probe: {b2} chunks, {'live' if live else 'all-sentinel'}: {ms:.4f} ms "
            f"({stats['open_gates']} open (chunk, row, sub) gates)")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs one CUDA device")
    import bench_mesh
    from raytracer_tpu_torch.scene.clusters import build_clusters

    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}")
    check_add_one(dev)
    probe_dispatch(dev)
    verts, faces = bench_mesh.make_mesh(200_000)
    tri = verts[faces].astype(np.float32)
    cs = build_clusters(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], device=dev)
    check_wave2_kernel(cs, dev)  # the kernel is right, and its time at one real window
    probe_mt_chunks(cs, dev)


if __name__ == "__main__":
    main()
