"""Share of a frame's wall time in which no operation ran on the device:
the profiled frames' busy time (union of device operations) a frame,
over the wall time a frame of the same run's unprofiled window."""


def read(ctx):
    p, w = ctx.get("profile"), ctx["window"]
    if not p or ctx["loop"] != "viewer" or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - (p["busy_s"] / p["units"]) / (w["wall_s"] / w["units"]))
