"""Blocking transfers between host and device a pass: every ``host_sync``
span the program recorded (``raytracer_tpu_torch/utils/profiler.py``) in
the profiled passes, over the passes.  None on the CPU (no device
operation was traced) and where the program records no spans."""

from raytracer_tpu_torch.utils import profiler


def read(ctx):
    p = ctx.get("profile")
    syncs = getattr(profiler, "syncs", None)
    if not p or not p["ops"] or ctx["loop"] != "render" or syncs is None:
        return None
    n = sum(syncs().values())
    return n / p["units"] if n else None
