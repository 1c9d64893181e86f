"""``grad``: inverse-rendering steps back to back through
``parallel/mesh.py::train_step`` against a target made from the seed; step
k takes the sample streams of pass k and ends on a host copy of a gradient
entry.  Compared: one step of the window drawn from the seed, its loss and
all three gradient tables."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import check
from harness.cells import image_size
from harness.loops import Loop as Base
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.parallel.mesh import train_step
from raytracer_tpu_torch.render.renderer import ViewportParams


def target_image(cell, seed: int, device) -> torch.Tensor:
    """The target: uniform in [0, target_scale), drawn on the device by a
    generator seeded with ``seed``."""
    w, h = image_size(cell)
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    return torch.rand((h, w, 3), generator=g, device=device) * float(cell.traffic["target_scale"])


def saved_bytes(step) -> int:
    """Bytes of the distinct storages autograd saves in one ``step()``."""
    storages = {}

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step()
    return sum(storages.values())


class Loop(Base):
    unit = "step"

    def setup(self):
        self.scene, self.meta, self.cam = load_scene(self.scene_file, device=self.device)
        self.vpp = ViewportParams(self.width, self.height, seed=self.seed)
        self.target = target_image(self.cell, self.seed, self.device)
        self.pass_idx = 0
        self.step()
        self.results = []

    def step(self):
        loss, (gb, ge, gr) = train_step(self.scene, self.meta, self.cam, self.target, self.pass_idx, self.vpp,
                                        self.params)
        gb.x[:1].cpu()  # a step ends on a host copy of a gradient entry
        self.pass_idx += 1
        return loss, (*gb, *ge, gr)

    def window(self, seconds: float) -> dict:
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        c0 = self.counters()
        self.pass_idx, self.results, n = 0, [], 0
        t0 = time.perf_counter()
        while True:
            loss, grads = self.step()
            ok = torch.isfinite(loss) & torch.stack([torch.isfinite(g).all() for g in grads]).all()
            bad += (~ok).to(torch.int64)
            self.results.append((loss, grads))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return {"units": n, "wall_s": wall, "attempted": n, "failed": int(bad),
                "metrics": {"step_ms": wall / n * 1e3},
                "counters": {k: v - c0[k] for k, v in self.counters().items()}}

    def traced(self) -> dict:
        return {"saved_bytes": saved_bytes(self.step)}

    def outputs(self) -> dict:
        return {"steps": [(float(loss), [g.detach().cpu() for g in grads]) for loss, grads in self.results],
                "target": self.target.cpu()}

    def free(self):
        del self.scene, self.cam, self.target, self.results


def step_compared(seed: int, units: int) -> int:
    """The step compared, drawn from the seed: never step 0 where there are
    others, since a step that returns the first step's answer again would
    pass there."""
    return int(check.sample(seed, 4, units - 1, 1)[0]) + 1 if units > 1 else 0


def grad_gaps(prog, ref) -> dict:
    """``loss_gap``: the losses' gap over the reference's; ``grad_gap``:
    by the worst leaf, the gap between the two gradients' norms over the
    reference's norm of that leaf or of the median leaf, the larger."""
    (loss_p, grads_p), (loss_r, grads_r) = prog, ref
    norm = lambda gs: np.array([float(torch.linalg.vector_norm(g.double())) for g in gs])
    norms_p, norms_r = norm(grads_p), norm(grads_r)
    floor = max(float(np.median(norms_r)), 1e-30)
    return {"loss_gap": abs(loss_p - loss_r) / max(abs(loss_r), 1e-30),
            "grad_gap": float(np.max(np.abs(norms_p - norms_r) / np.maximum(norms_r, floor)))}


def reference(cell, scene_file, seed, device, k: int, target, low_precision=False):
    """(loss, 7 gradient leaves) of step k: the loss sum((img - target)^2)
    / (W H 3) of pass k's image, by the hashed streams ``train_step``
    draws, and its gradients with respect to base_color, emission and
    roughness."""
    rt = check.reference()
    from rt.math.vec import Vec3

    params, w, h = check.ref_params(cell)
    scene, meta, cam = rt.trace.load(scene_file, device, low_precision)
    m = scene.materials
    leaves = [c.detach().clone().requires_grad_() for c in (*m.base_color, *m.emission, m.roughness)]
    scene = scene._replace(materials=m._replace(base_color=Vec3(*leaves[0:3]), emission=Vec3(*leaves[3:6]),
                                                roughness=leaves[6]))
    pix = torch.arange(w * h, dtype=torch.int64, device=device)
    r = rt.trace.trace_samples(scene, meta, cam, pix, torch.full_like(pix, k), w, h, seed, params,
                               low_discrepancy=False)
    img = torch.stack([c.reshape(h, w) for c in r], -1)
    loss = torch.sum((img - target.to(device)) ** 2) / (w * h * 3)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return float(loss.detach()), [g.detach().cpu() for g in grads]


def compare(cell, scene_file, out, seed, device) -> dict:
    k = step_compared(seed, len(out["steps"]))
    return dict(grad_gaps(out["steps"][k], reference(cell, scene_file, seed, device, k, out["target"])), step=k)


def control(cell, scene_file, seed, device, units: int) -> dict:
    k = step_compared(seed, units)
    target = target_image(cell, seed, device)
    run = lambda low: reference(cell, scene_file, seed, device, k, target, low)
    return grad_gaps(run(True), run(False))
