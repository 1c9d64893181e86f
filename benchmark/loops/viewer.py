"""``viewer``: interactive frames, ``Viewport.render(1)`` then
``Viewport.image()`` to the host; every ``segment_frames`` frames the
camera steps along a path made from the seed and the film restarts.
Compared: ``check_frames`` frames drawn from the seed, ``check_pixels``
pixels of each displayed u8 image."""

from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from harness import check
from harness.cells import image_size
from harness.loops import Loop as Base
from harness.stats import percentile
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.camera import make_camera


def camera_path(seed: int, start: dict, segments: int, step: float, yaw_deg: float, box: list) -> list:
    """Camera poses (translation, euler degrees) of ``segments`` segments:
    the scene's camera, then one WASD move of ``step`` (and a yaw of up to
    ``yaw_deg``) a segment, drawn from the seed and reflected into ``box``
    ([min xyz, max xyz] around the start)."""
    rng = np.random.default_rng([seed % 2**63, 0x5EED])
    pos = np.asarray(start.get("translation", (0.0, 0.0, 0.0)), np.float64)
    euler = np.asarray(start.get("orientation", (0.0, 0.0, 0.0)), np.float64)
    lo, hi = pos + np.asarray(box[0]), pos + np.asarray(box[1])
    poses = [(pos.copy(), euler.copy())]
    for _ in range(segments - 1):
        yaw = math.radians(euler[1])
        fwd, right = np.array([math.sin(yaw), 0.0, math.cos(yaw)]), np.array([math.cos(yaw), 0.0, -math.sin(yaw)])
        move = (fwd, -fwd, right, -right)[rng.integers(4)] * step
        pos = pos + move
        pos = np.where(pos > hi, 2 * hi - pos, np.where(pos < lo, 2 * lo - pos, pos))
        euler = euler + np.array([0.0, rng.uniform(-yaw_deg, yaw_deg), 0.0])
        poses.append((pos.copy(), euler.copy()))
    return poses


def viewer_path(cell, scene_file: str, seed: int):
    """(poses, field of view) of the viewer traffic's camera path."""
    with open(scene_file) as f:
        cam_doc = json.load(f).get("camera", {})
    t = cell.traffic
    poses = camera_path(seed, cam_doc.get("transform", {}), int(t["path_segments"]), float(t["camera_step"]),
                        float(t["yaw_deg"]), t["camera_box"])
    return poses, float(cam_doc.get("fieldOfView", 60.0))


class Loop(Base):
    unit = "frame"

    def setup(self):
        self.scene, self.meta, self.cam = load_scene(self.scene_file, device=self.device)
        self.poses, self.fov = viewer_path(self.cell, self.scene_file, self.seed)
        self.cams = [self._camera(p) for p in self.poses]
        self.vp = Viewport(self.scene, self.meta, self.cams[0],
                           ViewportParams(self.width, self.height, seed=self.seed), self.params,
                           device=self.device)
        self.frame = 0
        self.step()
        self.vp.cam = self.cams[0]
        self.vp.reset()

    def _camera(self, pose):
        return make_camera(RigidTransform(translation=pose[0], euler_deg=pose[1]), fov_deg=self.fov,
                           device=self.device)

    def step(self):
        seg = int(self.cell.traffic["segment_frames"])
        if self.frame and self.frame % seg == 0:
            self.vp.cam = self.cams[(self.frame // seg) % len(self.cams)]
            self.vp.reset()
        self.vp.render(1)
        img = self.vp.image()
        self.frame += 1
        return img

    def window(self, seconds: float) -> dict:
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        c0 = self.counters()
        self.frame, self.images, times = 0, [], []
        t0 = time.perf_counter()
        while True:
            f0 = time.perf_counter()
            self.images.append(self.step())
            times.append(time.perf_counter() - f0)
            bad += (~torch.isfinite(self.vp.film.sum).all()).to(torch.int64)
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        n = len(times)
        return {"units": n, "wall_s": wall, "attempted": n, "failed": int(bad),
                "metrics": {"frame_ms_p90": percentile(times, 90) * 1e3}, "frame_s": times,
                "counters": {k: v - c0[k] for k, v in self.counters().items()}}

    def outputs(self) -> dict:
        return {"images": self.images, "poses": self.poses, "fov": self.fov}

    def free(self):
        del self.vp, self.scene, self.cams


def u8_gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """``mismatch_share``: share of pixels with a u8 channel unlike the
    reference's; ``mean_gap``: gap of the u8 sums over the reference's."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return {"mismatch_share": float((prog != ref).any(-1).mean()),
            "mean_gap": float(abs(prog.sum() - ref.sum()) / max(ref.sum(), 1.0))}


def items(cell, seed: int, units: int):
    """(pixels, frames) compared, drawn from the seed."""
    w, h = image_size(cell)
    return (check.sample(seed, 3, w * h, int(cell.traffic["check_pixels"])),
            check.sample(seed, 2, units, int(cell.traffic["check_frames"])))


def reference(cell, scene_file, seed, device, frames, pix, poses, fov, low_precision=False) -> np.ndarray:
    """(F * S, 3) u8 of the pixels of the displayed frames: frame f shows
    ``f % segment_frames + 1`` passes from the camera of its segment."""
    rt = check.reference()
    from rt.math.transform import RigidTransform as RefTransform
    from rt.render.postprocess import PostprocessParams
    from rt.scene.camera import make_camera as ref_camera

    params, w, h = check.ref_params(cell)
    scene, meta, _ = rt.trace.load(scene_file, device, low_precision)
    seg = int(cell.traffic["segment_frames"])
    ys = torch.as_tensor(pix // w, device=device)
    xs = torch.as_tensor(pix % w, device=device)
    out = []
    for f in frames.tolist():
        pose = poses[(f // seg) % len(poses)]
        cam = ref_camera(RefTransform(translation=pose[0], euler_deg=pose[1]), fov_deg=fov, device=device)
        if low_precision:
            cam = rt.trace.lower(cam)
        n = f % seg + 1
        mean = check.ref_mean(scene, meta, cam, pix, n, w, h, seed, params, device)
        out.append(rt.trace.display_pixels(mean, ys, xs, PostprocessParams(), n).cpu().numpy())
    return np.concatenate(out)


def compare(cell, scene_file, out, seed, device) -> dict:
    pix, frames = items(cell, seed, len(out["images"]))
    ref = reference(cell, scene_file, seed, device, frames, pix, out["poses"], out["fov"])
    prog = np.concatenate([out["images"][f].reshape(-1, 3)[pix] for f in frames.tolist()])
    return u8_gaps(prog, ref)


def control(cell, scene_file, seed, device, units: int) -> dict:
    pix, frames = items(cell, seed, units)
    poses, fov = viewer_path(cell, scene_file, seed)
    run = lambda low: reference(cell, scene_file, seed, device, frames, pix, poses, fov, low)
    return u8_gaps(run(True), run(False))
