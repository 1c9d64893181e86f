"""``render_inst``: the ``render`` loop on a scene with instances.  The
window, the outputs and the numbers compared are ``render``'s; the
reference traces with its two-level traversal
(``reference/rt/ops/instances.py``) in the path tracer's place, in the
comparison and in the control alike.

The loop measures the program's instance top level
(``raytracer_tpu_torch/ops/traverse.py::top_level``) and refuses a program
without one at once, before any scene is loaded.  Such a program runs one
wave2 query an instance over every ray of a wavefront, and a traced pass,
which keeps every ``mt_chunks`` call's inputs for the ``wave2_mt``
roofline until it ends, holds more of them than the card has memory."""

from __future__ import annotations

from harness import check
from harness.cells import load_module
from raytracer_tpu_torch.ops import traverse

render = load_module("loops", "render")


class Loop(render.Loop):
    def __init__(self, *a, **k):
        if not hasattr(traverse, "top_level"):
            raise RuntimeError("render_inst measures the instance top level (ops/traverse.py::top_level), "
                               "which this program lacks")
        super().__init__(*a, **k)

    def traced(self) -> dict:
        """A render's traced run: the readers of the render metrics read it
        as they read the ``render`` loop's."""
        return dict(super().traced(), loop="render")


def _instanced():
    check.reference()
    from rt.ops.instances import instanced

    return instanced()


def compare(cell, scene_file, out, seed, device) -> dict:
    with _instanced():
        return render.compare(cell, scene_file, out, seed, device)


def control(cell, scene_file, seed, device, units: int) -> dict:
    with _instanced():
        return render.control(cell, scene_file, seed, device, units)
