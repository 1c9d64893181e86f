"""Device operations a pass launched inside the program's
``traverse.instances`` spans, placed as ``device_ms_by_span`` places their
time (``device_ops_by_span`` of ``raytracer_tpu_torch/utils/profiler.py``),
in the profiled passes: the instance path's dispatch count.  None on the
CPU and where the program records no such span."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p = ctx.get("profile")
    by_span = getattr(profiler, "device_ops_by_span", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or by_span is None:
        return None
    n = by_span(p["ops"]).get("traverse.instances")
    return n / p["units"] if n else None
