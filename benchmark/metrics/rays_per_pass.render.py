"""Rays traced a pass (camera, bounce and shadow), in millions, from
``Viewport.progress()`` over the window's passes."""


def read(ctx):
    w = ctx["window"]
    return w["rays"] / w["units"] / 1e6 if ctx["loop"] == "render" and w.get("rays") else None
