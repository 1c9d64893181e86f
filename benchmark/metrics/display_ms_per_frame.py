"""Device ms a frame of the operations launched inside
``Viewport.image()`` (the ``display`` span: postprocess and u8)."""


def read(ctx):
    p = ctx.get("profile")
    if not p or ctx["loop"] != "viewer" or not p["layers_s"].get("display"):
        return None
    return p["layers_s"]["display"] / p["units"] * 1e3
