"""Entry points of the port (counterpart of ``__graft_entry__.py``):
the flagship render step and a multi-device dry run.

    python -m raytracer_tpu_torch.entry [--cpu]

runs ``entry()`` once (on the card unless ``--cpu``) and prints
``entry() run ok``.

- ``entry(device)`` returns ``(fn, example_args)``: ``fn(scene, cam, film,
  pass_idx)`` is one MIS pass (depth 6) of the Cornell box at 64^2 through
  ``render/renderer.py::render_pass``, returning (film, counters).
- ``dryrun_multichip(n_devices, device)`` runs, over a group of
  ``n_devices`` ranks (``parallel/launch.py``: NCCL when each rank has a
  card of its own, gloo otherwise; one process a rank), one sharded forward
  pass (``render_pass_sharded``), one ``train_step_sharded`` and one
  ``render_pass_vcm_sharded`` (``VcmParams(max_path_length=3)``) on the
  Cornell box at 16 pixels wide, 8 rows a rank, depth 3, MIS, and checks
  that the loss and the films are finite.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from .integrators.path_tracer import RenderParams
from .math.transform import RigidTransform
from .render.film import make_film
from .render.renderer import ViewportParams, render_pass
from .scene.camera import make_camera
from .scene.presets import cornell_box, cornell_camera_kw

WIDTH, ROWS_A_RANK, DEPTH = 16, 8, 3
RANK_TIMEOUT_S = 600


def flagship_scene(device):
    """(scene, meta, cam) of both entry points: the Cornell box and its camera."""
    scene, meta = cornell_box(device=device)
    t_kw, c_kw = cornell_camera_kw()
    return scene, meta, make_camera(RigidTransform(**t_kw), **c_kw, device=device)


def entry(device="cuda"):
    """Returns (fn, example_args): the flagship forward render step."""
    scene, meta, cam = flagship_scene(device)
    vp = ViewportParams(width=64, height=64, seed=0)
    params = RenderParams(max_depth=6, mis=True)

    def step(scene, cam, film, pass_idx):
        return render_pass(scene, meta, cam, film, pass_idx, None, vp, params)

    return step, (scene, cam, make_film(vp.width, vp.height, device), 0)


def dryrun_params(world: int):
    """(ViewportParams, RenderParams) of ``dryrun_multichip`` over ``world``
    ranks: 16 pixels wide, 8 rows a rank, depth 3, MIS."""
    return ViewportParams(width=WIDTH, height=ROWS_A_RANK * world, seed=0), RenderParams(max_depth=DEPTH, mis=True)


def _rank(rank: int, world: int, init_file: str, out_dir: str, device: str, backend: str):
    """One rank of ``dryrun_multichip``: writes its band of the forward
    pass, the loss and its VCM band to ``out_dir/rank<rank>.npz``."""
    from .integrators.vcm import VcmParams
    from .parallel import mesh as pm

    pm.init_distributed(f"file://{init_file}", world, rank, backend)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    scene, meta, cam = flagship_scene(device)
    vp, params = dryrun_params(world)
    mesh = pm.make_mesh()
    film, _ = pm.render_pass_sharded(scene, meta, cam, pm.film_sharding(make_film(vp.width, vp.height, device), mesh),
                                     0, None, vp, params, mesh)
    target = torch.zeros((vp.height, vp.width, 3), device=device)
    loss, _ = pm.train_step_sharded(scene, meta, cam, target, 1, vp, params, mesh)
    vfilm = pm.render_pass_vcm_sharded(scene, meta, cam, pm.film_sharding(make_film(vp.width, vp.height, device), mesh),
                                       0, vp, params, mesh, vcm=VcmParams(max_path_length=3))
    row0, rows = pm._band(mesh, vp.height)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), row0=row0, rows=rows, band=film.sum.cpu().numpy(),
             loss=float(loss), vcm_band=vfilm.sum.cpu().numpy(), host_bytes=pm.STATS.host_bytes)
    torch.distributed.destroy_process_group()
    print("RANK_OK", rank, flush=True)


def dryrun_multichip(n_devices: int, device="cuda", work_dir=None) -> dict:
    """One sharded forward pass, train step and VCM pass over ``n_devices``
    ranks (module docstring).  ``work_dir`` holds the rendezvous file and
    the ranks' logs and outputs (default: a new directory under
    ``raytracer_tpu_torch/_build/``).  Raises where a rank fails, or where the
    loss or a film is not finite.  Returns {"backend", "loss", "film" (the
    forward pass's (H, W, 3) sum, assembled from the bands), "vcm" (the
    same of the VCM pass), "host_bytes" (a list, one a rank)}."""
    from .native import BUILD_DIR
    from .parallel.launch import backend_for, rank_device, run_ranks

    backend = backend_for(n_devices, device)
    if work_dir is None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        work_dir = tempfile.mkdtemp(prefix="dryrun-", dir=BUILD_DIR)
    os.makedirs(work_dir, exist_ok=True)
    init_file = os.path.join(work_dir, "rendezvous")
    if os.path.exists(init_file):
        os.remove(init_file)
    ranks = run_ranks(lambda r: ["-m", "raytracer_tpu_torch.entry", "rank", str(r), str(n_devices), init_file,
                                 work_dir, rank_device(r, device), backend], n_devices, work_dir, RANK_TIMEOUT_S)
    for r, (code, text) in enumerate(ranks):
        if code != 0 or "RANK_OK" not in text:
            raise RuntimeError(f"dryrun_multichip({n_devices}) [{backend}]: rank {r} exited {code}:\n{text[-3000:]}")
    outs = [dict(np.load(os.path.join(work_dir, f"rank{r}.npz"))) for r in range(n_devices)]
    film = np.concatenate([o["band"] for o in sorted(outs, key=lambda o: int(o["row0"]))])
    vcm = np.concatenate([o["vcm_band"] for o in sorted(outs, key=lambda o: int(o["row0"]))])
    loss = float(outs[0]["loss"])
    if not all(float(o["loss"]) == loss for o in outs):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' losses differ")
    if not (np.isfinite(loss) and np.isfinite(film).all() and np.isfinite(vcm).all()):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite loss or film")
    print(f"dryrun_multichip({n_devices}) [{backend}]: loss={loss:.6f} vcm ok", flush=True)
    return {"backend": backend, "loss": loss, "film": film, "vcm": vcm,
            "host_bytes": [int(o["host_bytes"]) for o in outs]}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["rank"]:
        rank, world, init_file, out_dir, device, backend = argv[1:7]
        return _rank(int(rank), int(world), init_file, out_dir, device, backend)
    device = "cpu" if "--cpu" in argv else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give --cpu to run on the CPU")
    fn, args = entry(device)
    film, _ = fn(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    if not bool(torch.isfinite(film.sum).all()):
        raise SystemExit("entry(): non-finite film")
    print("entry() run ok")


if __name__ == "__main__":
    main()
