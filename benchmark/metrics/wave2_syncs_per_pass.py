"""Host syncs of wave2's loops a pass (``STATS["host_syncs"]``) over the
window's passes."""


def read(ctx):
    w = ctx["window"]
    n = w["counters"].get("host_syncs", 0)
    return n / w["units"] if ctx["loop"] == "render" and n else None
