"""Share of the (ray, instance) pairs that the top level's cull hands to
the shared meshes' engines, in the profiled passes: the program's counters
``instances.pairs_sent`` over ``instances.pairs_tested`` (rays times
instances of every query).  None on the CPU and where the program keeps no
such counter."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p, counters = ctx.get("profile"), getattr(profiler, "counters", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or counters is None:
        return None
    c = counters()
    tested = c.get("instances.pairs_tested")
    return 100.0 * c.get("instances.pairs_sent", 0) / tested if tested else None
