"""Spans and counters of the port, on the clock of ``torch.profiler``'s events.

Tracing is on while ``enable()`` is in force or while a ``torch.profiler``
capture runs (``torch.autograd._profiler_enabled()``); no environment
setting switches it.  Off, ``span`` and ``host_sync`` return one shared null
context: they read no clock and record nothing.  On:

- ``span(name, **attrs)`` appends one ``Record`` to an in-memory buffer
  when it ends: name, start and end (ns), its id, the id of the span that
  encloses it on its thread (0 = none), the thread and ``attrs``.  A span
  opens no ``record_function`` range: it shares the profiler's clock by
  its timestamps, and adds no event to the device trace.
- ``host_sync(site)`` is a span named ``host_sync`` around a call that
  blocks the host until the device has run dry: a read of a device value
  (``.item()``, ``bool()``, a copy to the host), a boolean-mask index (its
  ``nonzero``), a copy from pageable host memory to the device.  Each is
  counted under its ``site``.
- ``count(name, n)`` adds to a host counter; ``count_device(name, t)`` adds
  a device value to a counter kept on the device (one add), read once by
  ``counters()``.

``records()``, ``syncs()`` and ``counters()`` return what was recorded;
``reset()`` clears it.  ``collect()`` / ``report()`` aggregate the buffer:
count, total and self time (the part no child span covers) per span name,
and syncs by site.  ``device_ms_by_span``, ``device_ops_by_span`` and
``idle_by_span`` put a profiler's device operations, ``(name, start ns, end
ns, launch ns)``, down to the spans: the device time and the operations
launched inside each span, and each idle gap of the device under the
innermost span in force when the device ran dry.
``start_device_profile(log_dir)`` / ``stop_device_profile()`` record a
``torch.profiler`` capture of the host and the card and write it as a
Chrome trace, the program's spans a track of their own beside torch's
events.

The clock is ``time.time_ns()``: the profiler stamps its events in
nanoseconds of the Unix epoch (kineto's clock converter), host and device
events alike.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from bisect import bisect_right
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import torch

_clock = time.time_ns
_profiling = torch.autograd._profiler_enabled
_NULL = nullcontext()
_enabled = 0  # depth of ``enable()`` contexts in force
_buffer: list = []
_counts: dict = {}
_device_counts: dict = {}
_syncs: dict = {}
_ids = itertools.count(1)
_local = threading.local()
_device_profile = []  # the running torch.profiler.profile, its log_dir and the buffer's length at its start
OUTSIDE = "(outside)"  # device time or idle launched outside every span
SPAN_TRACK_PID = 1 << 30  # the Chrome trace's process id of the spans' track


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    thread: int
    attrs: dict


def tracing() -> bool:
    """Whether spans and counters record now."""
    return _enabled > 0 or _profiling()


@contextmanager
def enable():
    """Record spans and counters inside this context, with or without a
    ``torch.profiler`` capture."""
    global _enabled
    _enabled += 1
    try:
        yield
    finally:
        _enabled -= 1


def _stack() -> list:
    """This thread's open spans, innermost last."""
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "attrs", "start", "id", "parent")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else 0
        self.id = next(_ids)
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        _stack().pop()  # spans are context managers: they close innermost first
        _buffer.append(Record(self.name, self.start, end, self.id, self.parent, threading.get_ident(), self.attrs))
        return False


def current():
    """This thread's innermost open span as (name, attrs), or None."""
    stack = _stack()
    return (stack[-1].name, stack[-1].attrs) if stack else None


def span(name: str, **attrs):
    """A region of the host's time (see the module docstring)."""
    if _enabled or _profiling():
        return _Span(name, attrs)
    return _NULL


def scoped_timer(name: str):
    """The reference's name for ``span``."""
    return span(name)


def host_sync(site: str):
    """A span around one blocking transfer, counted under ``site``."""
    if _enabled or _profiling():
        _syncs[site] = _syncs.get(site, 0) + 1
        return _Span("host_sync", {"site": site})
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter kept on the host."""
    if _enabled or _profiling():
        _counts[name] = _counts.get(name, 0) + n


def count_device(name: str, value: torch.Tensor) -> None:
    """Add a 0-d integer tensor to a counter summed on its device."""
    if _enabled or _profiling():
        acc = _device_counts.get(name)
        if acc is None:
            _device_counts[name] = value.to(torch.int64, copy=True)
        else:
            acc.add_(value)


def records() -> list:
    """The spans recorded so far, in the order they ended."""
    return list(_buffer)


def syncs() -> dict:
    """Blocking transfers by site."""
    return dict(_syncs)


def counters() -> dict:
    """Every counter; the device ones are read here (one read each)."""
    out = dict(_counts)
    out.update({k: int(v.item()) for k, v in _device_counts.items()})
    return out


def reset() -> None:
    """Clear the buffer and every counter."""
    _buffer.clear()
    _counts.clear()
    _device_counts.clear()
    _syncs.clear()


def collect(recs=None) -> dict:
    """{span name: {count, total, self, avg, min, max}} in seconds over
    ``recs`` (default: the buffer); ``self`` leaves out the time of the
    span's children."""
    recs = _buffer if recs is None else recs
    covered = {}
    for r in recs:
        if r.parent:
            covered[r.parent] = covered.get(r.parent, 0) + r.end_ns - r.start_ns
    out = {}
    for r in recs:
        d = (r.end_ns - r.start_ns) * 1e-9
        e = out.get(r.name)
        if e is None:
            e = out[r.name] = {"count": 0, "total": 0.0, "self": 0.0, "min": d, "max": d}
        e["count"] += 1
        e["total"] += d
        e["self"] += d - covered.get(r.id, 0) * 1e-9
        e["min"] = min(e["min"], d)
        e["max"] = max(e["max"], d)
    for e in out.values():
        e["avg"] = e["total"] / e["count"]
    return out


def _innermost(recs):
    """(times, ids): from ``times[i]`` on, the innermost span in force is
    ``ids[i]`` (0 = none).  At one time spans open before they close, outer
    ones first, and close inner ones first.  Spans of a thread nest; a span
    that closes under another thread's is taken out where it stands."""
    bounds = []
    for r in recs:
        bounds.append((r.start_ns, 0, r.id))
        bounds.append((r.end_ns, 1, -r.id))
    bounds.sort()
    times, ids, stack = [], [], []
    for t, closing, sid in bounds:
        if not closing:
            stack.append(sid)
        elif stack and stack[-1] == -sid:
            stack.pop()
        else:
            stack.remove(-sid)
        times.append(t)
        ids.append(stack[-1] if stack else 0)
    return times, ids


def _locate(recs):
    """A function from a time (ns) to the innermost span's ``Record`` in
    force then, or None."""
    by_id = {r.id: r for r in recs}
    times, ids = _innermost(recs)

    def at(t):
        i = bisect_right(times, t) - 1
        return by_id.get(ids[i]) if i >= 0 and ids[i] else None

    return at, by_id


def device_ms_by_span(ops, recs=None) -> dict:
    """{span name: device ms of the operations launched inside a span of
    that name}; an operation counts once for each name among the spans that
    hold its launch.  Operations launched outside every span, or without a
    launch event, go under ``OUTSIDE``."""
    return _by_span(ops, recs, lambda s, e: (e - s) * 1e-6)


def device_ops_by_span(ops, recs=None) -> dict:
    """{span name: device operations launched inside a span of that name},
    placed as ``device_ms_by_span`` places their time."""
    return _by_span(ops, recs, lambda s, e: 1)


def _by_span(ops, recs, weight) -> dict:
    """{span name: the sum of ``weight(start, end)`` over the operations
    whose launch a span of that name holds}."""
    recs = _buffer if recs is None else recs
    at, by_id = _locate(recs)
    names = {}  # innermost span id -> the distinct names of it and its ancestors

    def chain(r):
        got = names.get(r.id)
        if got is None:
            seen, p = [], r
            while p is not None:
                if p.name not in seen:
                    seen.append(p.name)
                p = by_id.get(p.parent)
            got = names[r.id] = seen
        return got

    out = {}
    for _, s, e, launch in ops:
        r = at(launch) if launch is not None else None
        w = weight(s, e)
        for name in chain(r) if r is not None else (OUTSIDE,):
            out[name] = out.get(name, 0) + w
    return out


def idle_by_span(ops, recs=None) -> dict:
    """{label: ms}: each gap between the device's operations put down to
    the innermost span in force when the device ran dry (the end of the
    busy stretch before the gap).  A label is the span's name, and for a
    ``host_sync`` span ``host_sync[<site>]``; ``OUTSIDE`` where no span
    was in force."""
    recs = _buffer if recs is None else recs
    at, _ = _locate(recs)
    out, end = {}, None
    for s, e in sorted((s, e) for _, s, e, _ in ops):
        if end is not None and s > end:
            r = at(end)
            label = OUTSIDE if r is None else f"host_sync[{r.attrs['site']}]" if r.name == "host_sync" else r.name
            out[label] = out.get(label, 0.0) + (s - end) * 1e-6
        end = e if end is None else max(end, e)
    return out


def _table(title: str, head: str, rows: list) -> list:
    """A titled table of (label, text) rows, or nothing without rows."""
    if not rows:
        return []
    width = max(len(r[0]) for r in rows)
    return ["", title, f"{'':<{width}}  {head}"] + [f"{label:<{width}}  {text}" for label, text in rows]


def _ms_rows(by: dict) -> list:
    return [(k, f"{v:11.3f}") for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def report(ops=None) -> str:
    """The buffer as text: self time by span, syncs by site, the counters,
    and, given a capture's device operations (as ``device_ms_by_span``
    takes them), device ms by span and idle by span."""
    stats = collect()
    if not stats and not _syncs and not _counts and not _device_counts:
        return "(no spans recorded)"
    order = sorted(stats.items(), key=lambda kv: -kv[1]["self"])
    lines = _table("spans by self time", "  count    total ms     self ms    avg ms",
                   [(n, f"{e['count']:7d} {e['total'] * 1e3:11.3f} {e['self'] * 1e3:11.3f} {e['avg'] * 1e3:9.3f}")
                    for n, e in order])
    by_count = sorted(_syncs.items(), key=lambda kv: -kv[1])
    lines += _table("host syncs by site", "  count", [(k, f"{v:7d}") for k, v in by_count])
    lines += _table("counters", "value", [(k, str(v)) for k, v in sorted(counters().items())])
    if ops:
        lines += _table("device ms by span", "  device ms", _ms_rows(device_ms_by_span(ops)))
        lines += _table("device idle by span (where the device ran dry)", "    idle ms", _ms_rows(idle_by_span(ops)))
    return "\n".join(lines[1:])


def start_device_profile(log_dir: str) -> None:
    """Begin a ``torch.profiler`` capture of the host and, where there is
    one, the CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    if _device_profile:
        raise RuntimeError("a device profile is already running")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    prof.start()
    _device_profile.append((prof, log_dir, len(_buffer)))


def device_ops(prof) -> list:
    """A finished capture's device operations (kernels, copies, sets) as
    ``(name, start ns, end ns, launch ns or None)``, the launch being the
    host's CUDA API call (``cuda*`` / ``cu*``) of the same correlation id."""
    from torch.autograd import DeviceType

    launch, device = {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0 and not e.is_user_annotation():
                device.append(e)
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), launch.get(e.correlation_id())) for e in device]


def stop_device_profile():
    """End the capture and write it under its ``log_dir`` as a Chrome trace
    (open it in Perfetto or chrome://tracing), with the spans recorded
    during the capture on a track of their own.  Returns (the file's path,
    the capture's device operations as ``device_ops`` gives them)."""
    prof, log_dir, first = _device_profile.pop()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_TRACK_PID, "tid": 0,
               "args": {"name": "raytracer_tpu_torch spans"}}]
    for r in _buffer[first:]:
        events.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": SPAN_TRACK_PID, "tid": r.thread,
                       "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": dict(r.attrs, id=r.id, parent=r.parent)})
    trace["traceEvents"] = trace.get("traceEvents", []) + events
    with open(path, "w") as f:
        json.dump(trace, f)
    return path, device_ops(prof)
