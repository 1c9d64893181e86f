"""``wave2_mt``'s share of its roofline in the profiled passes: the least
time the card could take for every launch's inputs
(``benchmark/rooflines/wave2_mt.py``) over the kernel's device time."""


def read(ctx):
    r = ctx.get("rooflines", {}).get("wave2_mt")
    if not r or not r["kernel_s"] or not r["launches"]:
        return None
    return 100.0 * r["least_s"] / r["kernel_s"]
