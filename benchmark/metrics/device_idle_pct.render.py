"""Share of a pass's wall time in which no operation ran on the device:
the profiled passs' busy time (union of device operations) a pass,
over the wall time a pass of the same run's unprofiled window."""


def read(ctx):
    p, w = ctx.get("profile"), ctx["window"]
    if not p or ctx["loop"] != "render" or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - (p["busy_s"] / p["units"]) / (w["wall_s"] / w["units"]))
