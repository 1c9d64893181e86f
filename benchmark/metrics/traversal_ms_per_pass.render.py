"""Device ms a pass of the operations launched inside
``integrators/path_tracer.py``'s calls to ``scene_traverse`` (the
``traversal`` span): prims, wave2 and its kernel."""


def read(ctx):
    p = ctx.get("profile")
    if not p or ctx["loop"] != "render" or not p["layers_s"].get("traversal"):
        return None
    return p["layers_s"]["traversal"] / p["units"] * 1e3
