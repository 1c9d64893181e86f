"""Share of the pair slots that wave2's ``_pair_join`` hands to the sort,
the gathers and ``wave2_mt`` that hold a real (ray, super) pair, in the
profiled passes: the program's counters ``wave2.pair_slots_real`` over
``wave2.pair_slots_sent``.  None on the CPU and where the program keeps no
such counter."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p, counters = ctx.get("profile"), getattr(profiler, "counters", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or counters is None:
        return None
    c = counters()
    sent = c.get("wave2.pair_slots_sent")
    return 100.0 * c.get("wave2.pair_slots_real", 0) / sent if sent else None
