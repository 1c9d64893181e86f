"""Share of the profiled passes' device idle time in gaps that began while
the host was inside a ``host_sync`` span of the program: the idle that
blocking transfers cause (``idle_by_span`` of ``raytracer_tpu_torch/utils/
profiler.py`` over the capture's device operations).  None on the CPU and
where the program records no spans."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p = ctx.get("profile")
    idle_by_span = getattr(profiler, "idle_by_span", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or idle_by_span is None or not profiler.records():
        return None
    idle = idle_by_span(p["ops"])
    total = sum(idle.values())
    if not total:
        return None
    return 100.0 * sum(v for k, v in idle.items() if k.startswith("host_sync")) / total
