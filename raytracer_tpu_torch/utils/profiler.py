"""Scoped-timer profiler registry (port of ``raytracer_tpu/utils/profiler.py``).

- ``scoped_timer(name)`` / ``@profiled(name)`` time a host-side region with
  a monotonic high-resolution clock and fold it into a process-global
  registry;
- ``collect()`` returns {name: {count, total, avg, min, max}} in seconds;
- ``device_trace(name)`` also opens ``torch.profiler.record_function(name)``,
  so the region shows in a ``torch.profiler`` trace;
- ``start_device_profile(log_dir)`` / ``stop_device_profile()`` record a
  ``torch.profiler`` trace of the host and the card and write it as a
  Chrome trace under ``log_dir``.

CUDA work is asynchronous: a scope measures the host's wall clock of
whatever the caller waits for, so synchronise the device inside the scope
(``torch.cuda.synchronize()``, or a copy to the host) for the region's
device work to count.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator

_lock = threading.Lock()
_registry: dict[str, dict] = {}
_device_profile = []  # the running torch.profiler.profile and its log_dir, if any


def reset() -> None:
    """Clear all collected timings."""
    with _lock:
        _registry.clear()


def _record(name: str, seconds: float) -> None:
    with _lock:
        e = _registry.get(name)
        if e is None:
            _registry[name] = {"count": 1, "total": seconds, "min": seconds, "max": seconds}
        else:
            e["count"] += 1
            e["total"] += seconds
            e["min"] = min(e["min"], seconds)
            e["max"] = max(e["max"], seconds)


@contextmanager
def scoped_timer(name: str) -> Iterator[None]:
    """Time a region and fold it into the registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0)


@contextmanager
def device_trace(name: str) -> Iterator[None]:
    """scoped_timer + a ``torch.profiler`` range of the same name."""
    import torch.profiler

    with torch.profiler.record_function(name):
        with scoped_timer(name):
            yield


def profiled(name: str | None = None) -> Callable:
    """Decorator form of ``scoped_timer``."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        def wrapper(*args, **kwargs):
            with scoped_timer(label):
                return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        return wrapper

    return deco


def collect() -> dict[str, dict]:
    """Aggregated stats per site: {name: {count,total,avg,min,max}} seconds."""
    with _lock:
        return {name: dict(e, avg=e["total"] / e["count"]) for name, e in _registry.items()}


def report() -> str:
    """Human-readable table of collected timings."""
    stats = collect()
    if not stats:
        return "(no profiler samples)"
    width = max(len(n) for n in stats)
    lines = [f"{'scope':<{width}}  count     total      avg      min      max"]
    for name in sorted(stats, key=lambda n: -stats[n]["total"]):
        e = stats[name]
        lines.append(
            f"{name:<{width}}  {e['count']:5d}  {e['total']*1e3:8.2f}ms"
            f" {e['avg']*1e3:7.2f}ms {e['min']*1e3:7.2f}ms {e['max']*1e3:7.2f}ms"
        )
    return "\n".join(lines)


def start_device_profile(log_dir: str) -> None:
    """Begin a ``torch.profiler`` capture of the host and, where there is
    one, the CUDA device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _device_profile:
        raise RuntimeError("a device profile is already running")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    prof.start()
    _device_profile.append((prof, log_dir))


def stop_device_profile() -> str:
    """End the capture and write it under its ``log_dir`` as a Chrome trace
    (open it in Perfetto or chrome://tracing).  Returns the file's path."""
    prof, log_dir = _device_profile.pop()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
