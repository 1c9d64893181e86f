"""Device ms a pass of the operations launched inside the program's
``textures`` spans (every ``ops/textures.py::sample_texture_many`` call:
material columns, the normal map, the sky on the miss path and in NEE), in
the profiled passes.  None on the CPU and where the program records no such
span."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p = ctx.get("profile")
    by_span = getattr(profiler, "device_ms_by_span", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or by_span is None:
        return None
    ms = by_span(p["ops"]).get("textures")
    return ms / p["units"] if ms else None
