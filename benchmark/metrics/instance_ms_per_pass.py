"""Device ms a pass of the operations launched inside the program's
``traverse.instances`` spans (the instance half of every closest-hit and
occlusion query: the top level's cull, the shared meshes' queries and the
fold), in the profiled passes.  None on the CPU and where the program
records no such span."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p = ctx.get("profile")
    by_span = getattr(profiler, "device_ms_by_span", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or by_span is None:
        return None
    ms = by_span(p["ops"]).get("traverse.instances")
    return ms / p["units"] if ms else None
