"""Command-line renderer (port of ``raytracer_tpu/cli.py``): renders N
passes of a scene and writes a tonemapped PNG or BMP, an optional EXR and a
stats line.

    python -m raytracer_tpu_torch --scene path/to/scene.json --passes 64 \\
        --width 512 --height 512 --output out.png --hdr-output out.exr

It renders on the CUDA device, and refuses to run without one unless
``--cpu`` is given.  PNG and BMP are written without PIL (``io/png.py``,
``io/bmp.py``).  ``--trace DIR`` records the program's spans
(``utils/profiler.py``) from the scene load on, renders under a
``torch.profiler`` capture written to DIR as a Chrome trace with the spans
on a track of their own, and prints the report: self time by span, host
syncs by site, device ms by span and device idle by span.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

RENDERERS = "'Path Tracer', 'Path Tracer MIS', 'Light Tracer', 'VCM'"
_WRITERS = (".png", ".bmp")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_tpu_torch",
        description="Differentiable Monte Carlo path tracer (PyTorch / CUDA)",
    )
    p.add_argument("--scene", "-s", help="JSON scene file (reference schema); omit for built-in Cornell box")
    p.add_argument("--data", "-d", default=None, help="asset root for textures/meshes (default: scene dir)")
    p.add_argument("--width", "-w", type=int, default=512)
    p.add_argument("--height", "-e", type=int, default=512)
    p.add_argument("--passes", "-p", type=int, default=16)
    p.add_argument("--renderer", "-r", default="Path Tracer MIS",
                   help="Path Tracer | Path Tracer MIS | Light Tracer | Debug")
    p.add_argument("--max-depth", type=int, default=20)
    p.add_argument("--output", "-o", default="output.png", help="tonemapped PNG/BMP output")
    p.add_argument("--hdr-output", default=None, help="optional EXR (linear radiance) output")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="render on the CPU (default: the CUDA device)")
    p.add_argument("--no-low-discrepancy", action="store_true")
    p.add_argument("--stats-json", action="store_true", help="print stats as one JSON line")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write a Chrome trace of the render with the program's spans to DIR and print their report")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    # the renderer names of the reference; "Debug" is listed in --help but,
    # as there, no branch takes it
    name = args.renderer.lower()
    if name in ("path tracer", "pathtracer", "pt"):
        kind, mis = "pt", False
    elif name in ("path tracer mis", "pt-mis", "mis"):
        kind, mis = "pt", True
    elif name in ("light tracer", "lighttracer", "lt"):
        kind, mis = "lt", True
    elif name == "vcm":
        kind, mis = "vcm", True
    else:
        print(f"error: unknown renderer '{args.renderer}' (available: {RENDERERS})", file=sys.stderr)
        return 2
    ext = os.path.splitext(args.output)[1].lower()
    if ext not in _WRITERS:
        print(f"error: --output must end in {' or '.join(_WRITERS)} (got '{args.output}')", file=sys.stderr)
        return 2

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device; pass --cpu to render on the CPU", file=sys.stderr)
        return 1
    dev = torch.device("cpu") if args.cpu else torch.device("cuda")
    if args.trace:
        from .utils import profiler

        with profiler.enable():
            return _run(args, kind, mis, ext, dev, profiler)
    return _run(args, kind, mis, ext, dev)


def _run(args, kind, mis, ext, dev, profiler=None) -> int:
    import torch

    from .integrators.path_tracer import RenderParams
    from .io.bmp import write_bmp
    from .io.exr import write_exr
    from .io.png import write_png
    from .math.transform import RigidTransform
    from .render.renderer import Viewport, ViewportParams
    from .scene.camera import make_camera

    if args.scene:
        from .io.scene_loader import load_scene

        scene, meta, cam = load_scene(args.scene, data_path=args.data, aspect=args.width / args.height, device=dev)
    else:
        from .scene.presets import cornell_box, cornell_camera_kw

        scene, meta = cornell_box(device=dev)
        t_kw, c_kw = cornell_camera_kw()
        cam = make_camera(RigidTransform(**t_kw), aspect=args.width / args.height, **c_kw, device=dev)

    params = RenderParams(max_depth=args.max_depth, mis=mis)
    vp = Viewport(scene, meta, cam,
                  ViewportParams(width=args.width, height=args.height, seed=args.seed,
                                 use_low_discrepancy=not args.no_low_discrepancy),
                  params, device=dev)

    if profiler is not None:
        profiler.start_device_profile(args.trace)
    t0 = time.perf_counter()
    if kind == "vcm":
        from .integrators.vcm import VcmParams, render_pass_vcm

        vcm = VcmParams(max_path_length=min(args.max_depth, 10))
        for i in range(args.passes):
            vp.film = render_pass_vcm(scene, meta, cam, vp.film, i, None, vp.vp_params, params, vcm)
    elif kind == "lt":
        from .integrators.light_tracer import render_pass_light_tracer

        total = 0.0
        for i in range(args.passes):
            vp.film, counters = render_pass_light_tracer(scene, meta, cam, vp.film, i, None, vp.vp_params, params)
            total += float(counters.num_rays)
        vp.total_rays = total
    else:
        vp.render(args.passes)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    img = vp.image()
    if profiler is not None:
        path, ops = profiler.stop_device_profile()
        print(profiler.report(ops))
        print(f"trace -> {path}")
    (write_png if ext == ".png" else write_bmp)(args.output, img)
    if args.hdr_output:
        write_exr(args.hdr_output, vp.radiance())

    stats = vp.progress()
    stats.update(
        seconds=round(dt, 3),
        mrays_per_sec=round((stats["total_rays"] + stats["total_shadow_rays"]) / dt / 1e6, 3),
        output=args.output,
    )
    if args.stats_json:
        print(json.dumps(stats))
    else:
        print(f"{stats['passes_finished']} passes in {stats['seconds']}s "
              f"({stats['mrays_per_sec']} Mray/s) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
