"""Differentiable-rendering step (port of the body of
``raytracer_tpu/parallel/mesh.py::train_step_sharded``).

``train_step`` is what one device of the reference's sharded step computes
when the mesh holds one device: the loss of a rendered image against a
target and its gradients with respect to the three material tables.  The
sharded wrapper (pixel-row bands over a ``torch.distributed`` process group,
an all-reduce of loss and gradients) is ROADMAP queue 1, item 8.
"""

from __future__ import annotations

import torch

from ..integrators.path_tracer import RenderParams
from ..math.vec import Vec3
from ..render.renderer import ViewportParams, trace_rows
from ..scene.types import Camera, SceneData, SceneMeta


def material_leaves(scene: SceneData):
    """(scene, leaves): the scene with its three differentiated material
    tables (``base_color``, ``emission``, ``roughness``) replaced by leaves
    that require grad, and the 7 leaves in that order.  A leaf shares the
    caller's storage, so the caller's tensors gain no ``.grad`` and no
    ``requires_grad``."""
    m = scene.materials
    flat = [c.detach().requires_grad_() for c in (*m.base_color, *m.emission, m.roughness)]
    mats = m._replace(base_color=Vec3(*flat[0:3]), emission=Vec3(*flat[3:6]), roughness=flat[6])
    return scene._replace(materials=mats), flat


def train_step(scene: SceneData, meta: SceneMeta, cam: Camera, target: torch.Tensor, pass_idx: int,
               vp: ViewportParams, params: RenderParams):
    """One forward + backward pass.  ``target`` is the (H, W, 3) reference
    image.  Returns (loss, (g_base_color, g_emission, g_roughness)): the loss
    ``sum((img - target)**2) / (W*H*3)`` as a 0-d tensor, the gradients as
    the tables' own structure (``Vec3`` / tensor), all detached."""
    s, flat = material_leaves(scene)
    radiance, _ = trace_rows(s, meta, cam, pass_idx, None, vp, params)
    img = torch.stack([c.reshape(vp.height, vp.width) for c in radiance], dim=-1)
    loss = torch.sum((img - target) ** 2) / (vp.width * vp.height * 3)
    # a table the image does not reach gets zeros, as jax.grad gives
    g = torch.autograd.grad(loss, flat, materialize_grads=True)
    return loss.detach(), (Vec3(*g[0:3]), Vec3(*g[3:6]), g[6])
