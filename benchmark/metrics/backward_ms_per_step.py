"""Device ms a step of the operations launched inside the step's
``torch.autograd.grad`` call (the ``backward`` span)."""


def read(ctx):
    p = ctx.get("profile")
    if not p or ctx["loop"] != "grad" or not p["layers_s"].get("backward"):
        return None
    return p["layers_s"]["backward"] / p["units"] * 1e3
