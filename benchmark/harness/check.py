"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``benchmark/reference``) run after the window
on the same inputs.

The reference parses the scene files itself, builds its own tables and
intersection, and reproduces each sample from (pixel, pass, seed); it is
handed the program's outputs only to judge them.  What each kind of use
compares, drawn from the seed once the window has closed, is its loop's
(``benchmark/loops/<loop>.py``: ``compare`` and ``control``); this module
holds what they share, and each number is returned with the limit of
``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .cells import BENCH, image_size, load_module, render_params

REFERENCE_ROOT = os.path.join(BENCH, "reference")
# a lane's radiance is "the same" within this: far above float32 rounding
# of a path's sum, far below what one path that takes another turn changes
RTOL, ATOL = 1e-3, 1e-5
LANES = 1 << 17  # reference lanes traced at once


def reference():
    """The reference package ``rt`` (imports nothing of the program)."""
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)
    import rt.trace

    return rt


def sample(seed: int, salt: int, population: int, k: int) -> np.ndarray:
    rng = np.random.default_rng([seed % 2**63, salt])
    return np.sort(rng.choice(population, size=min(k, population), replace=False))


def ref_params(cell):
    """The reference's ``RenderParams`` for the cell, built as the timed
    loop builds the program's, and the image size."""
    reference()
    from rt.integrators.path_tracer import RenderParams

    return render_params(cell, RenderParams), *image_size(cell)


def ref_mean(scene, meta, cam, pixels: np.ndarray, n_passes: int, w, h, seed, params, device):
    """(S, 3) mean radiance of passes 0 to ``n_passes`` - 1 at the pixels,
    traced a few passes at a time."""
    rt = reference()
    from rt.math.vec import Vec3

    pix = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    per = max(1, LANES // len(pixels))
    parts = []
    for p0 in range(0, n_passes, per):
        ps = torch.arange(p0, min(n_passes, p0 + per), dtype=torch.int64, device=device)
        r = rt.trace.trace_samples(scene, meta, cam, pix.repeat(len(ps)), ps.repeat_interleave(len(pix)), w, h,
                                   seed, params)
        parts.append(torch.stack([r.x, r.y, r.z], -1))
    rgb = torch.cat(parts)
    return rt.trace.film_mean(Vec3(rgb[:, 0], rgb[:, 1], rgb[:, 2]), len(pixels), n_passes)


def _float32_exact():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def numbers(cell, scene_file, out, seed, device) -> dict:
    """The program's outputs against the reference's."""
    _float32_exact()
    return load_module("loops", cell.traffic["loop"]).compare(cell, scene_file, out, seed, device)


def control_numbers(cell, scene_file, seed, device, units: int) -> dict:
    """The control: the reference in bfloat16 put in the program's place,
    over a window of ``units`` passes, frames or steps, judged as the
    program is."""
    _float32_exact()
    return load_module("loops", cell.traffic["loop"]).control(cell, scene_file, seed, device, units)


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number that is not finite fails."""
    shown, ok = {}, True
    for name, spec in limits["numbers"].items():
        v = found.get(name, float("nan"))
        good = bool(np.isfinite(v)) and v <= spec["limit"]
        ok &= good
        shown[name] = {"value": v, "limit": spec["limit"]}
    return ok, shown
