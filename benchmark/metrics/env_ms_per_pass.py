"""Device ms a pass of the operations launched inside the program's
``lights.env`` spans (the env map's NEE sample and pdf, and the sky's
radiance on the miss path and in NEE, its texture lookups included), in the
profiled passes.  None on the CPU and where the program records no such
span."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p = ctx.get("profile")
    by_span = getattr(profiler, "device_ms_by_span", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or by_span is None:
        return None
    ms = by_span(p["ops"]).get("lights.env")
    return ms / p["units"] if ms else None
