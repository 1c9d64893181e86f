"""Adaptive rendering: per-block error estimation and block subdivision
(port of ``raytracer_tpu/render/adaptive.py``).

The film keeps a secondary every-2nd-pass accumulation; every adaptation
period the per-block relative error between the two estimates is measured,
converged blocks are dropped from the active list, and noisy blocks are
split in half, so sampling concentrates where the variance is.

The blocks live on the host.  Each pass traces one wavefront of the active
blocks' pixel ids, in block order, through ``trace_pixels``, and
scatter-adds into per-pixel sum / weight buffers.  As in the reference, the
wavefront is padded to a power of two of at least 256 lanes; padded lanes
trace pixel 0 with weight 0, and ``progress()["total_rays"]`` counts their
rays, as the reference's does.  The block bookkeeping (``_error_map``,
``_update_blocks``) is the reference's numpy float32 code, so a block error
an ulp from a threshold takes the same branch in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..integrators.path_tracer import RenderParams
from ..sampler.sampler import halton_frame_vector
from ..scene.types import Camera, SceneData, SceneMeta
from .postprocess import PostprocessParams, postprocess, to_u8
from .renderer import ViewportParams, trace_pixels


@dataclass(frozen=True)
class AdaptiveSettings:
    """The adaptive renderer's knobs, at the reference's defaults."""

    num_initial_passes: int = 4  # full-frame passes before adapting
    adaptation_period: int = 2  # adapt every N passes (secondary buffer cadence)
    convergence_threshold: float = 0.005  # drop blocks below this error
    subdivision_threshold: float = 0.02  # split blocks below this (but not converged)
    min_block_size: int = 8
    max_block_size: int = 64


@dataclass
class Block:
    y0: int
    x0: int
    h: int
    w: int
    error: float = float("inf")


def _pad_to_bucket(n: int) -> int:
    """Next power of two >= n, at least 256 (the reference's bucket)."""
    if n <= 256:
        return 256
    return 1 << (n - 1).bit_length()


@torch.no_grad()
def _trace_scatter(scene, meta, cam, pixel_ids, valid, pass_idx, halton, vp, params,
                   sum_img, sec_img, weight, sec_weight):
    """Trace a padded pixel-id wavefront and scatter-add into the buffers.
    The adds are ``index_put_(accumulate=True)``: sorted on CUDA, so a pass
    repeats bit for bit (as ``render/film.py::splat``)."""
    radiance, counters = trace_pixels(scene, meta, cam, pixel_ids, pass_idx, halton, vp, params)
    v = valid.to(torch.float32)
    rgb = torch.stack([radiance.x * v, radiance.y * v, radiance.z * v], dim=-1)
    idx = (pixel_ids // vp.width, pixel_ids % vp.width)
    sum_img = sum_img.index_put(idx, rgb, accumulate=True)
    weight = weight.index_put(idx, v, accumulate=True)
    if pass_idx % 2 == 0:
        sec_img = sec_img.index_put(idx, rgb, accumulate=True)
        sec_weight = sec_weight.index_put(idx, v, accumulate=True)
    return sum_img, sec_img, weight, sec_weight, counters


class AdaptiveViewport:
    """Viewport variant that focuses samples on unconverged blocks.

    The per-pixel pass count varies, so the film is (sum, weight) with
    ``radiance = sum / weight``: converged pixels keep their last estimate.
    """

    def __init__(self, scene: SceneData, meta: SceneMeta, cam: Camera,
                 vp_params: ViewportParams = ViewportParams(),
                 render_params: RenderParams = RenderParams(),
                 adaptive: AdaptiveSettings = AdaptiveSettings(),
                 post_params: PostprocessParams = PostprocessParams(), *, device):
        self.device = torch.device(device)
        self.scene = scene
        self.meta = meta
        self.cam = cam
        self.vp_params = vp_params
        self.render_params = render_params
        self.adaptive = adaptive
        self.post_params = post_params
        h, w = vp_params.height, vp_params.width
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.sum = z(h, w, 3)
        self.sec = z(h, w, 3)
        self.weight = z(h, w)
        self.sec_weight = z(h, w)
        self.passes = 0
        self.total_rays = 0.0
        self.converged_fraction = 0.0
        self.average_error = float("inf")
        # the initial block grid
        bs = adaptive.max_block_size
        self.blocks: list[Block] = [
            Block(y, x, min(bs, h - y), min(bs, w - x))
            for y in range(0, h, bs)
            for x in range(0, w, bs)
        ]
        self._ids_cache: tuple[torch.Tensor, torch.Tensor] | None = None

    # --- active pixel set ----------------------------------------------------
    def _active_ids(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(padded pixel ids, valid mask) of the active blocks, block after
        block, each block's pixels row-major."""
        if self._ids_cache is not None:
            return self._ids_cache
        w = self.vp_params.width
        ids = [
            (np.arange(b.y0, b.y0 + b.h)[:, None] * w + np.arange(b.x0, b.x0 + b.w)[None, :]).reshape(-1)
            for b in self.blocks
        ]
        flat = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        n = len(flat)
        padded = np.zeros(_pad_to_bucket(max(n, 1)), np.int64)
        padded[:n] = flat
        valid = np.zeros(len(padded), bool)
        valid[:n] = True
        self._ids_cache = (torch.as_tensor(padded, device=self.device), torch.as_tensor(valid, device=self.device))
        return self._ids_cache

    # --- error + block update -------------------------------------------------
    def _error_map(self) -> np.ndarray:
        n = np.maximum(self.weight.cpu().numpy(), 1.0)
        m = np.maximum(self.sec_weight.cpu().numpy(), 1.0)
        a = self.sum.cpu().numpy() / n[..., None]
        b = self.sec.cpu().numpy() / m[..., None]
        return np.abs(a - b).sum(-1) / (a.sum(-1) + 1e-4)

    def _update_blocks(self):
        """Drop converged blocks, split semi-converged ones in half along
        their longer side."""
        err = self._error_map()
        s = self.adaptive
        new_blocks: list[Block] = []
        total_err = 0.0
        for b in self.blocks:
            e = float(err[b.y0:b.y0 + b.h, b.x0:b.x0 + b.w].mean())
            b.error = e
            total_err += e * b.h * b.w
            if e < s.convergence_threshold:
                continue  # converged: dropped from rendering
            if e < s.subdivision_threshold and max(b.h, b.w) >= 2 * s.min_block_size:
                if b.h >= b.w:
                    h0 = b.h // 2
                    new_blocks.append(Block(b.y0, b.x0, h0, b.w, e))
                    new_blocks.append(Block(b.y0 + h0, b.x0, b.h - h0, b.w, e))
                else:
                    w0 = b.w // 2
                    new_blocks.append(Block(b.y0, b.x0, b.h, w0, e))
                    new_blocks.append(Block(b.y0, b.x0 + w0, b.h, b.w - w0, e))
            else:
                new_blocks.append(b)
        area = self.vp_params.width * self.vp_params.height
        active_area = sum(b.h * b.w for b in new_blocks)
        self.converged_fraction = 1.0 - active_area / area
        self.average_error = total_err / area
        self.blocks = new_blocks
        self._ids_cache = None

    # --- main loop ----------------------------------------------------------------
    def render(self, n_passes: int = 1):
        s = self.adaptive
        for _ in range(n_passes):
            if not self.blocks:
                self.passes += 1
                continue  # fully converged
            ids, valid = self._active_ids()
            halton = None
            if self.vp_params.use_low_discrepancy:
                halton = torch.as_tensor(halton_frame_vector(self.passes), device=self.device)
            self.sum, self.sec, self.weight, self.sec_weight, counters = _trace_scatter(
                self.scene, self.meta, self.cam, ids, valid, self.passes, halton, self.vp_params,
                self.render_params, self.sum, self.sec, self.weight, self.sec_weight,
            )
            self.total_rays += float(counters.num_rays)
            self.passes += 1
            if self.passes >= s.num_initial_passes and self.passes % s.adaptation_period == 0:
                self._update_blocks()
        return self

    # --- outputs ----------------------------------------------------------------------
    def radiance(self) -> np.ndarray:
        return (self.sum / torch.clamp_min(self.weight, 1.0)[..., None]).cpu().numpy()

    def image(self) -> np.ndarray:
        srgb = postprocess(torch.as_tensor(self.radiance(), device=self.device), self.post_params,
                           dither_seed=self.passes)
        return to_u8(srgb).cpu().numpy()

    def progress(self) -> dict:
        """Passes, active blocks and pixels, converged share, average error
        (also in dB), rays traced (padded lanes included)."""
        return {
            "passes_finished": self.passes,
            "active_blocks": len(self.blocks),
            "active_pixels": sum(b.h * b.w for b in self.blocks),
            "converged_fraction": self.converged_fraction,
            "average_error": self.average_error,
            "error_db": (10.0 * np.log10(self.average_error)
                         if np.isfinite(self.average_error) and self.average_error > 0
                         else float("-inf")),
            "total_rays": self.total_rays,
        }
