"""The traced run's reading of the device: spans around the program's
layer entries, the profiler's device events, and what the reading yields.

Spans are opened from the benchmark's own files: for the profiled units
only, each ``benchmark/spans/<layer>.json`` names a function of the
program (``module``, ``attr``) that is wrapped in
``torch.profiler.record_function("bench::<layer>")``.  A device operation
belongs to a layer when the host call that launched it (the CUDA runtime
or driver event of the same correlation id) falls inside the layer's span.
Roofline counts name a function too: its calls' arguments are kept, not
copied, while the units run, and counted after the profiler has stopped.
"""

from __future__ import annotations

import importlib
import time
from contextlib import ExitStack, contextmanager

import torch

from .stats import union_seconds

PREFIX = "bench::"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")


@contextmanager
def patched(module: str, attr: str, make):
    """``module.attr`` (``attr`` may name a class's method, ``Cls.meth``)
    replaced by ``make(original)`` for the duration."""
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    orig = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
    new = make(orig)
    new.__dict__.update(orig.__dict__)  # attributes the function keeps on itself (launch counts)
    setattr(owner, name, new)
    try:
        yield
    finally:
        orig.__dict__.update(new.__dict__)
        setattr(owner, name, orig)


def _span(name, fn):
    def wrapped(*a, **k):
        with torch.profiler.record_function(PREFIX + name):
            return fn(*a, **k)

    return wrapped


def _keep(calls, fn):
    def wrapped(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)

    return wrapped


def kind(e) -> str:
    """An event's activity, from its device and name: a span
    (``user_annotation``, or ``gpu_user_annotation`` on the device), a
    launch (``cuda_runtime`` / ``cuda_driver``), a device operation
    (``kernel``, ``gpu_memcpy``, ``gpu_memset``) or a host op."""
    from torch.autograd import DeviceType

    name, on_device = e.name(), e.device_type() == DeviceType.CUDA
    if name.startswith(PREFIX):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if name.startswith("cuda") else "cuda_driver" if name.startswith("cu") else "cpu_op"


def read_events(events) -> dict:
    """Spans, device operations and launches from kineto events: ``spans``
    (name, start ns, end ns) of the ``bench::`` annotations on the host;
    ``ops`` (name, start ns, end ns, launch ns or None) on the device."""
    spans, ops, launch, device = [], [], {}, []
    for e in events:
        k = kind(e)
        if k == "user_annotation" and e.name().startswith(PREFIX):
            spans.append((e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns()))
        elif k in LAUNCH_ACTIVITIES:
            launch[e.correlation_id()] = e.start_ns()
        elif k in DEVICE_ACTIVITIES and e.duration_ns() > 0:
            device.append(e)
    for e in device:
        ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), launch.get(e.correlation_id())))
    return {"spans": spans, "ops": ops}


def attribute(spans, ops) -> dict:
    """Device seconds by layer: each op counts for every span that holds
    its launch (nested spans each count it)."""
    out = {}
    for name, a, b in spans:
        out.setdefault(name, 0.0)
    for _, s, e, t in ops:
        if t is None:
            continue
        for name, a, b in spans:
            if a <= t <= b:
                out[name] += (e - s) * 1e-9
    return out


def idle_gaps(spans, ops, top: int = 10) -> list:
    """The device's idle gaps between operations, summed by what the host
    was doing when each began (its innermost ``bench::`` span), longest
    first."""
    ivals = sorted((s, e) for _, s, e, _ in ops)
    by = {}
    end = None
    for s, e in ivals:
        if end is not None and s > end:
            inner = [(b - a, name) for name, a, b in spans if a <= end <= b]
            label = "host in " + min(inner)[1] if inner else "host outside the spans"
            by[label] = by.get(label, 0.0) + (s - end) * 1e-9
        end = e if end is None else max(end, e)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def top_ops(ops, top: int = 10) -> list:
    by = {}
    for name, s, e, _ in ops:
        by[name] = by.get(name, 0.0) + (e - s) * 1e-9
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def profile_units(step, units: int, spans: list, rooflines: dict, device) -> dict:
    """Run ``step()`` ``units`` times under the profiler with the spans
    opened; returns the reading: wall seconds, device busy seconds, device
    seconds by layer, device ops by name and count, idle gaps, and each
    roofline's kept calls."""
    from torch.profiler import ProfilerActivity, profile

    from .loops import sync

    calls = {k: [] for k in rooflines}
    sync(device)
    with ExitStack() as stack:
        for sp in spans:
            stack.enter_context(patched(sp["module"], sp["attr"], lambda fn, n=sp["name"]: _span(n, fn)))
        for kernel, mod in rooflines.items():
            stack.enter_context(patched(mod.MODULE, mod.ATTR, lambda fn, c=calls[kernel]: _keep(c, fn)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(units):
                step()
            sync(device)
            wall = time.perf_counter() - t0
    got = read_events(prof.profiler.kineto_results.events())
    ops = got["ops"]
    return {
        "units": units, "wall_s": wall,
        "busy_s": union_seconds((s * 1e-9, e * 1e-9) for _, s, e, _ in ops),
        "layers_s": attribute(got["spans"], ops),
        "ops": ops, "n_ops": len(ops),
        "unlinked_ops": sum(1 for op in ops if op[3] is None),
        "device_ops": top_ops(ops), "idle_gaps": idle_gaps(got["spans"], ops),
        "calls": calls,
    }
