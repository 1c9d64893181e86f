"""``render``: offline passes, 1 spp each, back to back through
``Viewport.render(1)``; the window ends with ``Viewport.radiance()`` on
the host.  Compared: ``check_pixels`` pixels drawn from the seed, of the
film after all the window's passes."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import check
from harness.cells import image_size
from harness.loops import Loop as Base
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams


class Loop(Base):
    def setup(self):
        self.scene, self.meta, self.cam = load_scene(self.scene_file, device=self.device)
        self.vp = Viewport(self.scene, self.meta, self.cam, ViewportParams(self.width, self.height, seed=self.seed),
                           self.params, device=self.device)
        self.step()
        self.vp.radiance()
        self.vp.reset()

    def step(self):
        self.vp.render(1)

    def window(self, seconds: float) -> dict:
        vp = self.vp
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        overflowed, n = 0, 0
        c0, p0 = self.counters(), vp.progress()
        t0 = time.perf_counter()
        while True:
            before = vp.total_overflow
            vp.render(1)
            overflowed += vp.total_overflow > before
            bad += (~torch.isfinite(vp.film.sum).all()).to(torch.int64)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.radiance = vp.radiance()  # the film on the host ends the window
        wall = time.perf_counter() - t0
        p1 = vp.progress()
        return {"units": n, "wall_s": wall, "attempted": n, "failed": min(n, int(bad) + overflowed),
                "metrics": {"pass_ms": wall / n * 1e3},
                "rays": (p1["total_rays"] - p0["total_rays"]) + (p1["total_shadow_rays"] - p0["total_shadow_rays"]),
                "counters": {k: v - c0[k] for k, v in self.counters().items()}}

    def outputs(self) -> dict:
        return {"radiance": self.radiance, "passes": self.vp.film.num_passes}

    def free(self):
        del self.vp, self.scene, self.cam


def pixels(cell, seed: int) -> np.ndarray:
    w, h = image_size(cell)
    return check.sample(seed, 1, w * h, int(cell.traffic["check_pixels"]))


def gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """``mismatch_share``: share of pixels with a channel beyond RTOL /
    ATOL of the reference's; ``mean_gap``: gap of the channel sums over
    the reference's."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    bad = ~np.isfinite(prog) | (np.abs(prog - ref) > check.RTOL * np.abs(ref) + check.ATOL)
    total = float(np.abs(ref).sum())
    return {"mismatch_share": float(bad.any(-1).mean()),
            "mean_gap": float(abs(np.nan_to_num(prog, nan=1e30).sum() - ref.sum()) / max(total, 1e-30))}


def reference(cell, scene_file, seed, device, n_passes, pix, low_precision=False) -> np.ndarray:
    """(S, 3) mean radiance of the film after ``n_passes`` at the pixels."""
    rt = check.reference()
    params, w, h = check.ref_params(cell)
    scene, meta, cam = rt.trace.load(scene_file, device, low_precision)
    return check.ref_mean(scene, meta, cam, pix, n_passes, w, h, seed, params, device).cpu().numpy()


def compare(cell, scene_file, out, seed, device) -> dict:
    pix = pixels(cell, seed)
    ref = reference(cell, scene_file, seed, device, out["passes"], pix)
    return gaps(out["radiance"].reshape(-1, 3)[pix], ref)


def control(cell, scene_file, seed, device, units: int) -> dict:
    pix = pixels(cell, seed)
    run = lambda low: reference(cell, scene_file, seed, device, units, pix, low)
    return gaps(run(True), run(False))
