"""Device operations (kernels, copies, sets) a pass, from the profiled
passes' trace: the frame loop's dispatch count."""


def read(ctx):
    p = ctx.get("profile")
    return p["n_ops"] / p["units"] if p and ctx["loop"] == "render" and p["n_ops"] else None
