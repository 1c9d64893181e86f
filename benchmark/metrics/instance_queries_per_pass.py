"""Engine queries over shared meshes a pass: the program's counter
``instances.queries`` (one a mesh engine call of the top level) over the
profiled passes.  None on the CPU and where the program keeps no such
counter."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p, counters = ctx.get("profile"), getattr(profiler, "counters", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or counters is None:
        return None
    n = counters().get("instances.queries")
    return n / p["units"] if n else None
