"""MiB that autograd saves for the backward in one step, counted by
``torch.autograd.graph.saved_tensors_hooks`` (each storage once)."""


def read(ctx):
    b = ctx.get("saved_bytes")
    return b / 2**20 if ctx["loop"] == "grad" and b else None
