"""Share of the lanes the texture stack evaluates for surfaces that carry a
texture, in the profiled passes: the program's counters
``textures.lanes_textured.<site>`` (ids other than ``INVALID_ID``, summed
on the device) over ``textures.lanes.<site>`` (every lane of every
``sample_texture_many`` call, which evaluates them all), summed over the
surface sites.  The sky's lookups (site ``env``) are left out: every lane
of them names the sky.  None on the CPU and where the program keeps no
such counter."""

from raytracer_tpu_torch.utils import profiler

SITES = ("material", "normal", "decal")


def read(ctx):
    p, counters = ctx.get("profile"), getattr(profiler, "counters", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or counters is None:
        return None
    c = counters()
    lanes = sum(c.get(f"textures.lanes.{s}", 0) for s in SITES)
    textured = sum(c.get(f"textures.lanes_textured.{s}", 0) for s in SITES)
    return 100.0 * textured / lanes if lanes else None
