"""Device ms a pass of the operations the integrator launches outside its
traversal calls: materials, BSDFs, lights, MIS and roulette arithmetic and
the hit frame (the ``integrator`` span's self time)."""


def read(ctx):
    p = ctx.get("profile")
    if not p or ctx["loop"] != "render" or not p["layers_s"].get("integrator"):
        return None
    return (p["layers_s"]["integrator"] - p["layers_s"].get("traversal", 0.0)) / p["units"] * 1e3
