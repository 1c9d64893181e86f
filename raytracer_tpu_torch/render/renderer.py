"""Frame-loop driver (port of ``raytracer_tpu/render/renderer.py``).

One render pass runs over the full pixel wavefront:

    pixel grid -> per-pass AA jitter -> camera rays -> integrator -> film

Every sample is a pure function of (pixel id, pass, dim, seed), so renders
are reproducible and match the JAX package's sample streams bit for bit.
``Viewport.image()`` runs the postprocess pipeline on the device and
returns the uint8 sRGB image on the host.  ``Viewport.save_checkpoint`` /
``load_checkpoint`` persist and resume the render state
(``render/checkpoint.py``); ``trace_pixels`` traces any set of pixel ids,
the work unit of ``render/adaptive.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..integrators.path_tracer import Counters, RenderParams, trace_radiance
from ..math.sampling import sample_gaussian2
from ..sampler.sampler import (
    blue_noise_for_pixels,
    halton_frame_vector,
    hash_u32,
    make_stream,
    next_1d,
    u32_to_unit_float,
)
from ..scene.camera import generate_rays
from ..scene.types import Camera, SceneData, SceneMeta
from ..utils.profiler import host_sync, span
from .checkpoint import load_checkpoint, save_checkpoint
from .film import Film, accumulate_frame, average_radiance, make_film
from .postprocess import PostprocessParams, postprocess, to_u8


@dataclass(frozen=True)
class ViewportParams:
    """Frame-level knobs."""

    width: int = 256
    height: int = 256
    anti_aliasing_spread: float = 0.5
    use_low_discrepancy: bool = True
    use_blue_noise: bool = True
    seed: int = 0
    # shutter-open fraction: each pixel's ray time is u * strength (motion
    # blur; 0 = a static frame, and no sample dimension is drawn for it)
    motion_blur_strength: float = 0.0


def pixel_grid(width: int, height: int, rows: int | None = None, row0: int = 0, *, device):
    """Flattened pixel centers (film coords x right, y up) and global pixel
    ids for a ``rows``-row band starting at ``row0``."""
    rows = height if rows is None else rows
    ys = torch.arange(rows, dtype=torch.int32, device=device)[:, None].expand(rows, width) + row0
    xs = torch.arange(width, dtype=torch.int32, device=device)[None, :].expand(rows, width)
    pixel_ids = (ys * width + xs).reshape(-1)
    cx = (xs.reshape(-1).to(torch.float32) + 0.5) / width
    cy = 1.0 - (ys.reshape(-1).to(torch.float32) + 0.5) / height
    return cx, cy, pixel_ids


def trace_rows(scene: SceneData, meta: SceneMeta, cam: Camera, pass_idx: int, halton, vp: ViewportParams,
               params: RenderParams, rows: int | None = None, row0: int = 0):
    """Camera rays + integrator for one band of pixel rows: the
    differentiable entry point.  Radiance carries the autograd graph of
    every scene table and camera tensor that requires grad (materials,
    lights, the camera pose); hits do not, since traversal is detached.
    Samples depend only on the global pixel id, pass and seed, so any row
    partitioning gives the same radiance."""
    cx, cy, pixel_ids = pixel_grid(vp.width, vp.height, rows, row0, device=cam.tan_half_fov.device)
    return _trace_at(scene, meta, cam, cx, cy, pixel_ids, pass_idx, halton, vp, params)


def trace_pixels(scene: SceneData, meta: SceneMeta, cam: Camera, pixel_ids: torch.Tensor, pass_idx: int, halton,
                 vp: ViewportParams, params: RenderParams):
    """Camera rays + integrator for any (padded) set of global pixel ids:
    the adaptive renderer's work unit.  Samples are keyed by the global
    pixel id, so each pixel's radiance is the one a full-frame pass gives
    it."""
    xs = pixel_ids % vp.width
    ys = pixel_ids // vp.width
    cx = (xs.to(torch.float32) + 0.5) / vp.width
    cy = 1.0 - (ys.to(torch.float32) + 0.5) / vp.height
    return _trace_at(scene, meta, cam, cx, cy, pixel_ids, pass_idx, halton, vp, params)


def _seed_u32(x, dev):
    with host_sync("frame.jitter_seed"):  # a copy from host memory: the device drains first
        return torch.tensor(x & 0xFFFFFFFF, dtype=torch.int64, device=dev)


def _trace_at(scene, meta, cam, cx, cy, pixel_ids, pass_idx, halton, vp, params):
    dev = cam.tan_half_fov.device
    with span("frame.camera"):
        # per-pass Gaussian AA jitter shared by all pixels
        u1 = u32_to_unit_float(hash_u32(_seed_u32(pass_idx * 2654435761 + vp.seed, dev)))
        u2 = u32_to_unit_float(hash_u32(_seed_u32(pass_idx * 0x9E3779B9 + vp.seed + 7, dev)))
        jx, jy = sample_gaussian2(torch.clamp_min(u1, 1e-6), u2)
        spread = vp.anti_aliasing_spread
        cx = cx + jx * (spread / vp.width)
        cy = cy + jy * (spread / vp.height)

        blue = None
        if halton is not None and vp.use_blue_noise:
            blue = blue_noise_for_pixels(pixel_ids.to(torch.int64), vp.width)
        stream = make_stream(pixel_ids.to(torch.int64), pass_idx, seed=vp.seed, halton=halton, blue=blue)
        time = None
        if vp.motion_blur_strength > 0.0:
            u_t, stream = next_1d(stream)
            time = u_t * vp.motion_blur_strength
        rays, stream = generate_rays(cam, cx, cy, stream, time=time)
    return trace_radiance(scene, meta, rays, stream, params, time=time, pass_idx=pass_idx)


@torch.no_grad()
def render_pass(scene: SceneData, meta: SceneMeta, cam: Camera, film: Film, pass_idx: int, halton,
                vp: ViewportParams, params: RenderParams):
    """One full-frame accumulation pass.  Records no autograd graph, even
    for tables that require grad: the film accumulates across passes, and a
    graph would grow with it (differentiate ``trace_rows``)."""
    with span("frame.pass", index=pass_idx):
        radiance, counters = trace_rows(scene, meta, cam, pass_idx, halton, vp, params)
        return accumulate_frame(film, radiance, use_secondary=(pass_idx % 2 == 0)), counters


@torch.no_grad()
def render_passes(scene: SceneData, meta: SceneMeta, cam: Camera, film: Film, pass0: int, haltons,
                  vp: ViewportParams, params: RenderParams, n_passes: int):
    """``n_passes`` accumulation passes; ``haltons`` is (n_passes, dims)
    stacked per-pass Halton vectors or None.  Counters are summed."""
    total = None
    for i in range(n_passes):
        film, counters = render_pass(scene, meta, cam, film, pass0 + i,
                                     haltons[i] if haltons is not None else None, vp, params)
        total = counters if total is None else Counters(*(a + b for a, b in zip(total, counters)))
    return film, total


class Viewport:
    """Stateful orchestration: film + pass counter.

        vp = Viewport(scene, meta, cam, ViewportParams(512, 512), device="cuda")
        vp.render(n_passes=16)
        img = vp.image()            # (H, W, 3) uint8 postprocessed sRGB
        hdr = vp.radiance()         # (H, W, 3) float32 mean radiance
    """

    def __init__(self, scene: SceneData, meta: SceneMeta, cam: Camera,
                 vp_params: ViewportParams = ViewportParams(),
                 render_params: RenderParams = RenderParams(),
                 post_params: PostprocessParams = PostprocessParams(), *, device):
        self.device = torch.device(device)
        on = lambda t: t.device.type == self.device.type
        if not (on(scene.prims.kind) and on(cam.tan_half_fov)):
            raise ValueError(f"scene and camera must live on {self.device}")
        self.scene = scene
        self.meta = meta
        self.cam = cam
        self.vp_params = vp_params
        self.render_params = render_params
        self.post_params = post_params
        self.reset()

    def reset(self):
        """Restart accumulation."""
        self.film = make_film(self.vp_params.width, self.vp_params.height, self.device)
        self.total_rays = 0.0
        self.total_shadow_rays = 0.0
        self.total_overflow = 0.0
        self.total_box_tests = 0.0
        self.total_tri_tests = 0.0

    def render(self, n_passes: int = 1):
        """Run ``n_passes`` accumulation passes (no autograd graph:
        ``render_passes`` runs under ``torch.no_grad()``)."""
        with span("frame.render", passes=n_passes):
            pass_idx = self.film.num_passes
            halton = None
            if self.vp_params.use_low_discrepancy:
                table = np.stack([halton_frame_vector(pass_idx + i) for i in range(n_passes)])
                with host_sync("viewport.halton"):
                    halton = torch.as_tensor(table, device=self.device)
            self.film, counters = render_passes(
                self.scene, self.meta, self.cam, self.film, pass_idx, halton,
                self.vp_params, self.render_params, n_passes,
            )
            for name in ("rays", "shadow_rays", "overflow", "box_tests", "tri_tests"):
                with host_sync("viewport.counters"):
                    value = float(getattr(counters, "num_" + name))
                setattr(self, "total_" + name, getattr(self, "total_" + name) + value)
        return self

    def radiance(self) -> np.ndarray:
        with host_sync("viewport.radiance"):
            return average_radiance(self.film).cpu().numpy()

    def image(self) -> np.ndarray:
        with span("display"):
            with span("display.post"):
                srgb = postprocess(average_radiance(self.film), self.post_params, dither_seed=self.film.num_passes)
                u8 = to_u8(srgb)
            with span("display.copy"), host_sync("viewport.image"):
                return u8.cpu().numpy()

    def progress(self) -> dict:
        return {
            "passes_finished": self.film.num_passes,
            "total_rays": self.total_rays,
            "total_shadow_rays": self.total_shadow_rays,
            # nonzero means the traversal truncated some rays
            "total_traversal_overflow": self.total_overflow,
            # box and triangle tests of the live rays (RenderParams.count_traversal); 0 when off
            "total_box_tests": self.total_box_tests,
            "total_tri_tests": self.total_tri_tests,
        }

    def save_checkpoint(self, path: str):
        """Persist render state; resumable via :meth:`load_checkpoint`.

        State = film + pass counter + seed: sample streams are keyed by
        (pixel, pass, dim), so resuming continues bit for bit."""
        save_checkpoint(path, self.film, self.vp_params.seed,
                        extra={"total_rays": self.total_rays, "total_shadow_rays": self.total_shadow_rays})
        return self

    def load_checkpoint(self, path: str):
        """Restore render state saved by :meth:`save_checkpoint` (by either
        package) onto this viewport's device.  Raises ValueError on a film
        of another shape or another seed."""
        film, seed, meta = load_checkpoint(path, self.device)
        if tuple(film.sum.shape) != (self.vp_params.height, self.vp_params.width, 3):
            raise ValueError(
                f"checkpoint film {tuple(film.sum.shape[:2])} does not match viewport "
                f"{(self.vp_params.height, self.vp_params.width)}"
            )
        if seed != self.vp_params.seed:
            raise ValueError(
                f"checkpoint seed {seed} != viewport seed {self.vp_params.seed}; "
                "resuming would change the sample streams"
            )
        self.film = film
        self.total_rays = float(meta.get("total_rays", 0.0))
        self.total_shadow_rays = float(meta.get("total_shadow_rays", 0.0))
        return self
