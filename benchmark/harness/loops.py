"""The traffic loops' common part.  A traffic file's ``loop`` names the
general generator that drives it, ``benchmark/loops/<loop>.py``, which
holds three things:

- ``Loop``: set-up that warms up on the cell's own shapes, then
  ``window(seconds)``, which runs units back to back until the one that
  crosses ``seconds`` has ended, and the outputs the comparison judges;
- ``compare(cell, scene_file, out, seed, device)``: those outputs against
  the plain reference, as numbers for the cell's limits;
- ``control(cell, scene_file, seed, device, units)``: the same numbers
  with the reference in bfloat16 put in the program's place.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.ops import traverse, wave2_traverse

from .cells import image_size, load_module, render_params


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kind(cell):
    """The module of the cell's loop, ``benchmark/loops/<loop>.py``."""
    return load_module("loops", cell.traffic["loop"])


class Loop:
    unit = "pass"

    def __init__(self, cell, scene_file: str, seed: int, device):
        self.cell, self.scene_file, self.seed, self.device = cell, scene_file, seed, torch.device(device)
        self.width, self.height = image_size(cell)
        self.params = render_params(cell, RenderParams)
        if traverse.get_traversal_mode() != "auto":
            raise RuntimeError("a cell runs the program's default traversal mode")

    def counters(self) -> dict:
        return dict(wave2_traverse.STATS)

    def traced(self) -> dict:
        """What the traced run reads of this loop beyond the profile."""
        return {}


def make(cell, scene_file: str, seed: int, device) -> Loop:
    return kind(cell).Loop(cell, scene_file, seed, device)
