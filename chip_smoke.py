"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. device: needs CUDA; prints the card, its power limit, torch and CUDA.
2. build: compiles csrc/wave2_mt.cu, wave2_extract.cu, wave2_join.cu,
   phase2_grid.cu, phase2_stream.cu, add_one.cu, empty_launch.cu and
   bvh_walk.cu with nvcc,
   all at once, into
   raytracer_tpu_torch/_build/, and prints what ptxas says of each.
3. wave2 kernel vs twin (tools/torch_check_traverse.py::check_wave2_kernel):
   on the 200k-triangle bench mesh, one real traversal window (65,536
   incoherent rays, kc=16) is joined into pair chunks; the CUDA
   Möller-Trumbore kernel and its plain PyTorch twin run on the same chunks
   (closest-hit and any-hit) and must agree bit for bit; both are timed (CUDA
   events) and the gates that pass give the kernel's bound.  Then, bit-equal
   or FAIL: the hand-built tie cases (equal t under different tri ids within
   a slot, across slots and across subs; closest, any-hit and filler lanes
   mixed) and windows against K = 8 and K = 128 cluster sets.
4. wave2 engine: wave2_closest_hit / wave2_any_hit on coherent and
   incoherent rays, kernel path against twin path: tri ids equal, no overflow.
5. the wave2 slice: a 32^2 render of a 2k-triangle mesh on the card agrees
   with the same render on the CPU (twin path); then the 512^2 MIS depth-6
   render of the 200k-triangle scene (1 warm-up + 4 timed passes) with the
   kernel's launches counted, one profiled pass, and the Cornell box at
   512^2 (8 passes).
6. (with 2) the three new libraries' ptxas output.
7. block-candidate kernels vs plain versions
   (tools/torch_check_traverse.py::check_kernels): how many ray blocks
   (thread-block clusters) of each kernel the card holds at once; then, at the
   path's shapes, phase2_grid on dense (kb=48) and BFS (kb=256) candidates and
   phase2_stream closest-hit and any-hit (kb=256), on 256 coherent camera
   blocks and one incoherent 65,536-ray window: bit-equal or FAIL; both
   timed; the visits give the bound.  Then, bit-equal or FAIL and untimed:
   the hand-built tie and edge cases (equal t in two slots and in two
   candidates, pad slots and pad rays, a block that ends at j = 0, a block of
   +inf entries, kb = 1 and kb = 300, B = 1 and odd B, K = 8 to 128) and
   mixed windows against K = 8 and K = 128 cluster sets.  Every case prints
   the spread of steps over its ray blocks (mean, max): the slowest ray block
   sets a kernel's time.
8. block-candidate engines (check_engines): pallas_cluster_closest_hit /
   any_hit, pallas_sorted_closest_hit / any_hit, _pallas_sorted_closest_hit,
   kernel path against plain path: equal.  Their agreement with wave2 and
   their overflow share are printed, not gated.
9. the sorted-pallas slice: a 32^2 render on the card against the CPU, then
   512^2, depth 6, MIS under `sorted-pallas` (1 warm-up + 4 timed passes):
   Mray/s, ray counts, the overflow count (reported, not required to be 0),
   stream-kernel launches > 0, finite radiance; one profiled pass; the mode
   is restored to `auto`.
10. probes (tools/torch_probe_launch.py): add_one against its plain version
    (the probe's shape, odd sizes, an unaligned view), chained x + 1 through
    torch, through add_one in both launch forms and beside an empty kernel,
    mt_chunks at 64 (live, all-sentinel), 512, 1,024 and 4,096 chunks.

11. the texture kernel (csrc/textures.cu) against its plain twin on the
    card (tools/torch_check_textures.py::check_texture_kernel): 2,073,600
    lanes over the mixed table and over the textured hall's (1024^2
    bitmaps), bit-equal or FAIL, one launch a call, the gradient route (u, v:
    the twin's gradients bit-equal; texels and colors within 1e-5), the
    kernel and the twin timed, the kernel's row of the table; then textures,
    env map and postprocess against the CPU
    (tools/torch_check_textures.py): sample_texture_many over 2^20 lanes of
    mixed ids (three bitmaps in the three filters, checkerboard, noise with 1
    and 8 octaves, mix, const, INVALID_ID): texel fetches and checkerboard
    bit-equal, the rest within 1e-6; sample_2d / pdf_2d (same texel in every
    lane) and env_sample_direction; postprocess with each tonemapper and both
    dithers, bloom on, to_u8 within 1.
12. interior800k_mis: the 800k-triangle interior of tools/gen_interior.py,
    written by tools/torch_gen_interior.py (numpy BMP writer, no PIL) and
    loaded by the port's loader: no textures (both loaders ignore map_Kd),
    2 area lights + background; 512^2, depth 6, MIS under wave2 (1 warm-up +
    3 timed passes, whose 4-pass radiance phase 21 reuses): Mray/s, rays, shadow rays, overflow = 0, wave2_mt
    launches > 0, finite radiance, peak memory; one profiled pass.  The
    load's BVH build is logged with its own time and the device memory it
    adds (as every BVH build of the script is).  Before
    the render, on this scene's own cluster set: the wave2_mt kernel against
    its twin (bit-equal, timed) on a window of the scene's camera rays and on
    a window of bounce rays leaving their hit points, and the wave2 engine,
    kernel path against twin path, on both windows.  Every wave2 round of
    each interior render (and of phase 5's) launched the wave2_extract
    kernel and the four wave2_join kernels.  After the render, the wave2_extract kernel against its twin
    (tools/torch_check_traverse.py::check_extract_kernel; bit-equal or FAIL):
    the hall's 65,536-ray camera window and the continuation window its
    first round leaves (both timed), then the edge rays of
    extract_edge_rays (origins in boxes, axis-parallel directions on the
    1e-12 floor, tl = 0 and tl < 0, cursors -1 / middle / Cs - 1) at kc 1,
    4, 16 and 33 on the hall and on cluster sets with Cs = 313, 8 and 5,000
    (two of the kernel's tiles).  Then the wave2_join kernels (key, runs,
    place, select) against their twins
    (tools/torch_check_traverse.py::check_join_kernels; bit-equal or FAIL):
    every output of the join and of the select (closest-hit and any-hit
    results) on the hall's camera window and the continuation window its
    first round leaves (both timed: each launch's device time beside its
    byte bound, the round's join + select device and host ms with the
    kernels and with the twins), front to back on the camera window, and on
    mixed windows of a 20k-triangle mesh at K = 8.
13. interior800k_tex_mis: the same meshes with the textured additions of
    torch_gen_interior.ensure_interior_tex (textures block, normal-mapped
    textured floor slab, textured props, a lat-long sky on the background
    light): the same kernel, engine and render checks (2 timed passes, not
    4: a textured pass is slow, and phase 20 renders the textures again),
    plus scene.textures and scene.env_dist present, one traced pass whose
    sample_texture_many calls each launched the textures kernel once, and
    Viewport.image() a (512, 512, 3) uint8 array
    that is neither constant nor saturated; before it, a 32^2 render of the
    small textured scene on the card against the CPU.

14. the skip-link BVH walk (csrc/bvh_walk.cu, one thread a ray) on the
    200k-triangle mesh and on the baked 800k-triangle hall: on a window of
    65,536 camera rays and one of bounce rays, the kernel against its plain
    twin, closest-hit and any-hit, every output and each ray's step count
    bit-equal (tools/torch_check_traverse.py::check_bvh_walk; the kernel
    timed over 20 calls, the twin once; the distinct table rows the twin
    reads and its visits give the bound),
    and the walk against the wave2 engine (bvh_against_wave2: tri ids equal
    but on exact ties, t within 1e-6 relative, occlusion equal).  Then
    mesh200k_mis and interior800k_mis at 512^2, depth 6, MIS under
    set_traversal_mode("bvh") (1 warm-up + 4 timed passes): bvh_walk
    launches > 0, wave2_mt launches 0, mean radiance within 1e-3 of the same
    scene's wave2 render at the same seed and passes.
15. interior800k_inst_mis: the hall with its 28 columns and 3 knots as 31
    instances of 2 meshes (tools/torch_gen_interior.py::ensure_interior_inst):
    geometry and instance counts, triangles stored and the scene's bytes
    beside the baked hall's; the kernel and engine checks of phase 12 on the
    shell's cluster set and on each geometry's, the latter with the camera
    rays moved into the object space of one instance of it, and phase 14's
    bvh_walk checks on the shell's BVH; 512^2, depth 6, MIS under wave2 (1 warm-up + 1
    timed pass), overflow 0; one more pass traced and profiled: the top level's engine
    queries (counter instances.queries) at most 2 a traversal that reached the instances
    (one a shared mesh), and the device operations launched inside traverse.instances; the
    mean radiance within 1% of the baked hall's at the same seed and passes; then one timed
    pass under bvh, where the shell launches bvh_walk and the instances wave2_mt.
16. reverse-mode gradients (tools/torch_check_gradients.py): (a) the
    gradients of the scene of tests/test_gradients.py (32^2, depth 4, MIS)
    with respect to the material tables, the light colours, the camera
    origin and a yaw, on the card against the CPU port, element by element
    (the camera's per pixel), within rtol 2e-4, atol 1e-6: all of them
    against its float64 run, the tables and light colours against its
    float32 run too;
    then interior800k_fwd_bwd, bench.py::bench_backward's step on the hall
    of phase 12: 256^2, depth 4, MIS, pass 0, the loss mean(r + g + b) and
    its gradients with respect to base_color, emission and roughness, under
    wave2 (1 warm-up + 3 timed calls, each ending on a host copy of one
    gradient entry): mrays_per_sec_interior800k_fwd_bwd (the forward's
    rays a second), the forward alone, peak memory, the bytes autograd
    saves, wave2_mt launches a call, one profiled call; the same step under
    bvh, its gradients equal to wave2's (rtol 2e-4, atol 1e-6); (b) central
    differences of one emission and one light-colour entry on the hall at
    64^2; (c) every gradient finite and some base colour's non-zero; (d)
    train_step gradient descent on base_color at 128^2 lowers the loss;
    the wave engine against wave2 on the camera and bounce windows of
    mesh200k and of the hall: tri ids equal but on exact ties, t bit-equal
    where they agree, occlusion equal, both timed.
17. the command-line entry point (tools/torch_check_integrators.py::
    entry_point): cli.main in process on the Cornell box at 512^2, 4
    passes, --max-depth 10, --renderer mis (.bmp), lt and vcm (.png; the CLI
    gives VCM max_path_length 10): seconds, Mray/s as the CLI prints it,
    mean radiance; each output decodes to Viewport.image()'s pixels; LT's
    mean within rtol 0.05 of MIS's on the pixels that see no light (the
    light tracer renders no emitter the camera sees), vertex connection
    alone (VCM without merging) within rtol 0.03 of MIS's there, the full
    VCM's difference logged beside the grid cells it overfills; then LT and
    VCM on the card against the port on the CPU at 64^2 after pass 0 and
    pass 1, film values within the CPU parity tests' rtol 1e-4 / atol 1e-6
    on the box shifted off the photon grid (the unshifted box's walls lie on
    cell boundaries: logged), and one VCM pass run twice on the card, bit
    for bit.
18. LT and VCM on the 800k hall at 512^2 under wave2 (torch_check_integrators
    ::hall_integrators): one pass each (VcmParams(), max path length 8; LT
    max_depth 8): seconds, rays and shadow rays traced, peak memory,
    wave2_mt launches, photons stored and grid cells over max_per_cell,
    finite radiance with a non-zero mean; a VCM pass profiled (its device
    idle share); wave2_mt against its twin on a window of 65,536 of VCM's
    vertex-connection any-hit rays.
19. the debug renderer and the counters on the hall
    (torch_check_integrators::debug_and_counters): render_debug in all 14
    modes on the 512^2 camera rays (finite; constant only where the scene's
    own material column is), TriangleID on the card equal to the CPU port's
    on a 64^2 crop of the same rays, both under bvh (the hall
    loaded on the CPU too; wave2's plain twin took minutes there), and
    the card's wave2 crop equal to wave2 with the kernel's plain twin on
    the card, one
    MIS pass with count_traversal (total_box_tests, total_tri_tests), and
    the instanced hall's TraversalCost beside the baked hall's on the same
    rays (logged: the two hold their triangles in different cluster sets).
20. the scene effects (tools/torch_check_features.py): (a) each alone on
    the card against the port on the CPU at 64^2, depth 4, MIS, the film
    after pass 0 and pass 1 within rtol 1e-4 / atol 1e-6: moving prims,
    a moving mesh instance and a moving camera (motion_blur_strength 1),
    the circle, hexagon, square, 5- and 7-blade apertures, decals with an
    atlas colour and alpha, the spectral Cornell box with a dispersive
    glass sphere; a value outside passes only where the same scene without
    the effect (held still, a pinhole, no decals, no dispersion), on the
    same sample streams, is apart by the same amount (on the Cornell box
    the card's and the CPU's last-bit differences flip a few shadow rays
    at the boxes' edges either way); then the dispersive box at 256^2, 16
    passes, its mean within 2% of the RGB render's.  (b) interior800k_fx_mis: the instanced hall of
    phase 15 with the textured additions of phase 13, depth of field and a
    dispersive glass sphere (torch_gen_interior.ensure_interior_fx), and,
    set in Python on what the loader returns (torch_check_features.
    fx_effects), velocities on the 3 knots and the sphere, a shutter-close
    camera pose, a hexagonal aperture and 3 decals (one with the atlas and
    an alpha texture).  Before the render, wave2_mt and the engine against
    the twin on the shell's and each geometry's cluster set, the camera
    rays at seeded shutter times and moved into the object space of a
    moving knot at each ray's own time (instance_windows with ``time``);
    512^2, depth 6, MIS, wave2, strength 1, spectral (1 warm-up + 1 timed
    pass, no profiled one, for the time limit): overflow 0,
    wave2_mt launches, finite non-zero radiance; then one pass under bvh (bvh_walk for the shell,
    wave2_mt for the instances) with its mean radiance within 1e-3 of the
    wave2 render's first pass, and at 128^2, strength 0, spectral off, the
    radiance bit for bit that of the hall held still.
21. the frame-loop extras (tools/torch_check_frameloop.py): (a) the
    adaptive renderer (AdaptiveSettings() at the reference's defaults) on
    interior800k_mis and on mesh200k_mis at 512^2, depth 6, MIS, wave2, 8
    passes: after pass 4 its radiance bit for bit the uniform Viewport's 4
    passes (the hall's from phase 12); each pass's active blocks and
    pixels, converged share, error in dB, ms, rays, wave2_mt launches; the
    wave2_mt kernel against its twin on an adapted pass's wavefront (the
    active blocks' pixels in block order, padded with pixel 0).  (b)
    checkpoint / resume on mesh200k_mis at 512^2: 2 passes, save, a fresh
    Viewport loads and renders 2 more, its film bit for bit the straight
    4-pass film; seconds to save and load, bytes.  (c) debug_pixel_path of
    a hall pixel and a Cornell pixel on the card against the CPU port
    (vertices, ids and the end equal, floats within rtol 1e-5; one-ray
    wave2 windows on the hall, held against the CPU port's bvh walk, since
    wave2's plain twin takes minutes on the hall on the CPU).  (d) every packed codec over 2^20 lanes, the
    card's codes and decoded values bit-equal to the CPU's.
22. multi-device (tools/torch_check_parallel.py): (a) this process as an
    NCCL group of one (a file:// rendezvous under _build/parallel):
    render_pass_sharded on mesh200k_mis at 512^2, 2 passes, bit-equal to
    the Viewport's film and counters; render_pass_vcm_sharded of the Cornell
    box at 512^2, one pass, bit-equal to render_pass_vcm; train_step_sharded
    at 64^2 bit-equal to train_step; the group destroyed.  (b) two processes
    in a gloo group, each rendering its band on this card (NCCL refuses two
    ranks on one device; gloo's collectives copy the CUDA tensors through
    the host, counted): each band bit-equal to (a)'s rows, the counters
    equal, VCM within rtol 2e-4 / atol 2e-5 and the train step within the
    reference's bounds of (a), wave2_mt launched in each rank; each child's
    exit code read with a timeout.
23. the last public helpers and the materials-test scene
    (tools/torch_check_helpers.py): (a) the new helpers of math/vec.py,
    math/sampling.py, math/distribution.py (searchsorted_rows),
    ops/intersect.py (gather_prim) and render/film.py (error_estimate) over
    2^20 seeded lanes on the card against the CPU port: bit-equal, or within
    the bound that names the op that rounds otherwise (BOUNDS); (b)
    scene/presets.py::sphere_grid (64 spheres, 8 BSDFs, a background light)
    at 32^2 on the card against the CPU; (c) sphere_grid_mis at 512^2, depth
    6, MIS (1 warm-up + 4 timed passes): Mray/s, rays and shadow rays, peak
    memory, finite radiance, no traversal kernel launched (analytic prims
    only), one profiled pass with its device idle share.
24. the tools and the entry points: (a) tools/torch_traversal_bench.py at
    200k triangles and 2^20 rays, every engine (cluster, bvh, pallas, wave,
    wave2, sorted-pallas) closest-hit and any-hit on coherent and incoherent
    rays: ms, Mray/s, agreement with wave2, peak memory, window, each
    engine's kernel launches into its row's by_path; (b) mesh200k at 512^2,
    depth 6, MIS under the cluster mode (one pass; it has no kernel): ms,
    overflow, tri ids against wave2's on its camera and bounce windows; (c)
    a BVH over more than 1,000,000 nodes (a 2M-triangle heightfield),
    bvh_walk against its twin and against wave2; (d) the oracles
    tools/torch_check_wave2.py and tools/torch_check_pallas.py pass; (e)
    tools/torch_microbench.py's eight lines; (f) entry() on the card,
    dryrun_multichip(1) (NCCL) and dryrun_multichip(2) (two gloo ranks on
    this card): finite loss and films, the forward bands bit-equal to one
    process's render_pass; (g) tools/torch_scaling_bench.py at 1 and 2
    ranks, every band bit-equal to the one-process render's rows; (h)
    tools/torch_probe_render.py, one timed pass of mesh200k at 512^2.
25. wave2's settings (tools/torch_check_wave2_config.py), none of which is
    in the environment at the start (the script fails otherwise): (a)
    wave2_mt against its twin, bit for bit and timed, on the chunks of a
    front-to-back (RT_WAVE2_FTB) first round at kc 4 and of the
    continuation round after it, closest-hit and any-hit, on a mesh200k and
    a hall window; (b) the engine under front to back, kernel path against
    twin path (65,536 rays of each scene), then front to back at kc 4 and 6
    against id order at kc 16 on 2^20 coherent and incoherent rays of
    mesh200k and of the hall, closest-hit and any-hit: t bit-equal on every
    ray neither mode flags, tri ids equal but at ties in t (counted),
    occlusion equal; rounds, continuation iterations, pair slots, host
    syncs and overflow of each; (c) 512^2 MIS depth-6 renders of mesh200k
    and the hall under front to back (1 warm-up + 2 timed passes) beside the
    defaults in the same call, and of mesh200k under RT_WAVE2_SPATIAL_KEY=0
    (1 + 1): ms a pass, Mray/s, wave2_mt launches, overflow, finite
    radiance, radiance against the default render at the same seed (equal
    pixels, largest difference; bit-equal, and under front to back equal on
    at least 99% of pixels, since a tie in t may change a hit); (d) a child process with
    RT_WAVE2_CHUNK=256 (2 rows a chunk): wave2_mt against its twin on a
    mesh200k and a hall window, the engine's hits bit-equal to this
    process's at CHUNK 1,024, a 512^2 mesh200k render (1 + 1); (e) one
    mesh200k pass under each diagnostic switch, RT_WAVE2_SKIP_KERNEL (no
    kernel launched: the sort-join's bill alone) and RT_SKIP_TRI_FRAME,
    each set around its pass alone.

Every line goes to raytracer_tpu_torch/_build/chip_smoke.log too (truncated
at the start of a run), since the tail of the output may be cut.  The last
lines are a summary: one line per driven render (Mray/s, ms a pass, rays,
shadow rays, kernel launches, overflow, peak memory), the nvidia-smi line,
the kernel table as one JSON line (the wave2_mt row's top-level numbers are
the 200k mesh's window, the bvh_walk row's the 200k mesh's bounce window;
each ``by_path`` entry gives a driven path's launches and its own windows,
or, with ``windows_of``, the path whose scene and windows it shares),
and last {"ok": true, "device": {...}}.  Scene files are written under
raytracer_tpu_torch/_build/.  No phase imports PIL.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench_mesh  # noqa: E402  (numpy-only scene generator)
import torch_check_gradients as tcg  # noqa: E402
import torch_check_features as tfx  # noqa: E402
import torch_check_frameloop as tfl  # noqa: E402
import torch_check_helpers as tch  # noqa: E402
import torch_check_integrators as tci  # noqa: E402
import torch_check_pallas as tcpal  # noqa: E402
import torch_check_parallel as tpar  # noqa: E402
import torch_check_textures as tctex  # noqa: E402
import torch_check_traverse as tct  # noqa: E402
import torch_check_wave2 as tcw2  # noqa: E402
import torch_check_wave2_config as tcw2c  # noqa: E402
import torch_gen_interior  # noqa: E402
import torch_microbench as tmb  # noqa: E402
import torch_probe_launch as tpl  # noqa: E402
import torch_probe_render as tpr  # noqa: E402
import torch_scaling_bench as tsb  # noqa: E402
import torch_traversal_bench as ttb  # noqa: E402
from torch_check_traverse import bound_ms, coherent_rays, incoherent_rays, twin_engine, vec  # noqa: E402

from raytracer_tpu_torch import entry as port_entry  # noqa: E402
from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.io.scene_loader import load_scene  # noqa: E402
from raytracer_tpu_torch.math.transform import RigidTransform  # noqa: E402
from raytracer_tpu_torch.ops import bvh_traverse as bt  # noqa: E402
from raytracer_tpu_torch.ops.cluster_traverse import cluster_closest_hit  # noqa: E402
from raytracer_tpu_torch.parallel.launch import backend_for  # noqa: E402
from raytracer_tpu_torch.ops import cuda_build  # noqa: E402
from raytracer_tpu_torch.ops.cuda_build import launch_counts  # noqa: E402
from raytracer_tpu_torch.ops import traverse  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.render.film import average_radiance, make_film  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams, pixel_grid, render_pass  # noqa: E402
from raytracer_tpu_torch.sampler.sampler import make_stream  # noqa: E402
from raytracer_tpu_torch.scene import bvh as bvh_module  # noqa: E402
from raytracer_tpu_torch.scene.bvh import build_bvh_over_triangles, bvh_stats  # noqa: E402
from raytracer_tpu_torch.scene.clusters import build_clusters  # noqa: E402
from raytracer_tpu_torch.scene.camera import generate_rays, make_camera  # noqa: E402
from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw  # noqa: E402
from raytracer_tpu_torch.utils import profiler  # noqa: E402

bench_mesh.BENCH_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "bench_scene")
INTERIOR_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "interior")
LOG_PATH = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "chip_smoke.log")
KERNELS = ("wave2_mt", "wave2_extract", "wave2_join", "phase2_grid", "phase2_stream", "add_one", "bvh_walk",
           "textures")
LIBRARIES = KERNELS + ("empty_launch",)  # the empty kernel has no row: it is the dispatch probe's floor
_LOG = []  # the open log file, once main() has opened it
RENDERS = []  # one summary entry per timed render
T_START = time.perf_counter()


def log(msg: str):
    print(msg, flush=True)
    for f in _LOG:
        f.write(msg + "\n")
        f.flush()


def check(cond, msg):
    tct.check(cond, msg, log)


def extract_on_every_round(run, label):
    """``run()``, then a check that each wave2 round it ran launched the
    wave2_extract kernel once and the four wave2_join kernels (key, runs,
    place, select) once each.  Returns ``run()``'s result and the two
    kernels' launches."""
    rounds0, counts0 = w2.STATS["rounds"], launch_counts()
    out = run()
    launched = launch_counts() - counts0
    rounds, launches, joins = w2.STATS["rounds"] - rounds0, launched["wave2_extract"], launched["wave2_join"]
    log(f"{label}: wave2 rounds {rounds}, wave2_extract launches {launches}, wave2_join launches {joins}")
    check(launches == rounds > 0, f"{label}: each of the {rounds} wave2 rounds launched the wave2_extract kernel")
    check(joins == 4 * rounds, f"{label}: each of the {rounds} wave2 rounds launched the four wave2_join kernels")
    return out, (launches, joins)


def timed_render(vp, passes, smi, label, first=None):
    """1 warm-up pass, then ``passes`` timed ones ending with the film on
    the host.  Returns (seconds, rays, shadow rays, overflow in the timed
    passes, radiance), and adds the render's line to the summary.  A list
    ``first`` receives the mean radiance after the warm-up pass."""
    counts0 = launch_counts()
    t0 = time.perf_counter()
    vp.render(1)
    torch.cuda.synchronize()
    log(f"{label} warm-up pass: {time.perf_counter() - t0:.2f} s")
    if first is not None:
        first.append(float(vp.radiance().mean()))
    before = vp.progress()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vp.render(passes)
    radiance = vp.radiance()  # host copy: the timing ends with the film on the host
    dt = time.perf_counter() - t0
    after = vp.progress()
    rays = after["total_rays"] - before["total_rays"]
    shadow = after["total_shadow_rays"] - before["total_shadow_rays"]
    overflow = after["total_traversal_overflow"] - before["total_traversal_overflow"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label} 512^2 depth 6, {passes} passes: {dt:.3f} s, {(rays + shadow) / dt / 1e6:.4f} Mray/s, "
        f"rays {rays:.0f}, shadow rays {shadow:.0f}, overflow {overflow:.0f}, "
        f"peak mem {peak:.2f} GiB ({smi})")
    launched = dict(launch_counts() - counts0)
    RENDERS.append(f"summary {label}: {(rays + shadow) / dt / 1e6:.4f} Mray/s, {dt / passes * 1e3:.1f} ms a pass, "
                   f"rays {rays:.0f} and shadow rays {shadow:.0f} in {passes} passes, kernel launches in "
                   f"{passes + 1} passes {launched}, overflow {overflow:.0f}, peak {peak:.2f} GiB")
    return dt, rays, shadow, overflow, radiance


def profiled(run, label, top=8, named=()):
    """``run()`` (one pass, one step) under torch.profiler: device kernel
    time in total and by kernel name (the ``top`` largest, and those whose
    name holds one of ``named``), beside its wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # kernels and copies only, summed by name straight from the trace: the
    # host-side ops would carry their kernels' time a second time, and
    # key_averages() builds the host's event tree first, which takes minutes
    # on a pass of ~600k device events
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    total = sum(ms for ms, _ in by_name.values())
    log(f"{label} profiled: wall {wall * 1e3:.1f} ms, device kernel time {total:.1f} ms, "
        f"{sum(count for _, count in by_name.values())} device events (trace read in "
        f"{time.perf_counter() - t0 - wall:.1f} s)")
    ranked = sorted(by_name.items(), key=lambda item: item[1][0], reverse=True)
    for key, (ms, count) in ranked[:top] + [item for item in ranked[top:] if any(n in item[0] for n in named)]:
        log(f"  {ms:9.2f} ms  {count:6d} calls  {key[:90]}")
    return total


def small_render_agrees(params, dev, label, small=None, name="mesh2k"):
    """A 32^2 render of a small scene (the 2k-triangle mesh unless ``small``
    names another file) on the card against the CPU."""
    small = small or bench_mesh.ensure_scene(2000)
    views = []
    for where in ("cpu", dev):
        s, m, c = load_scene(small, device=where)
        views.append(Viewport(s, m, c, ViewportParams(32, 32, seed=0), params, device=where).render(1))
    a, b = (v.radiance() for v in views)
    close = float(np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1).mean())
    log(f"slice 32^2 {name} [{label}] cuda vs cpu: {close:.4f} of pixels within atol 1e-4 rtol 1e-3; "
        f"means {a.mean():.6f} / {b.mean():.6f}; overflow {views[0].progress()['total_traversal_overflow']:.0f} / "
        f"{views[1].progress()['total_traversal_overflow']:.0f}")
    check(close >= 0.98 and abs(a.mean() - b.mean()) <= 0.01 * abs(a.mean()),
          f"32^2 render of {name} on the card agrees with the CPU render ({label})")
    return views[1]


def engine_agrees(cs, o, d, any_tl, dev, label):
    """wave2_closest_hit and wave2_any_hit (rays of length ``any_tl``) on the
    (n, 3) rays ``o``, ``d``, kernel path against twin path: t, tri ids and
    occlusion bit-equal, no overflow.  Returns the kernel path's closest hit."""
    ro, rd = vec(o, dev), vec(d, dev)
    t0 = time.perf_counter()
    k_hit = w2.wave2_closest_hit(cs, ro, rd, 3.0e38)
    k_occ = w2.wave2_any_hit(cs, ro, rd, any_tl)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with twin_engine():
        t_hit = w2.wave2_closest_hit(cs, ro, rd, 3.0e38)
        t_occ = w2.wave2_any_hit(cs, ro, rd, any_tl)
    log(f"engine [{label}] {ro.x.shape[0]} rays: closest+any {dt * 1e3:.1f} ms, "
        f"hit rate {float((k_hit[1] >= 0).float().mean()):.4f}, "
        f"occluded {float(k_occ[0].float().mean()):.4f}")
    check(torch.equal(k_hit[1], t_hit[1]) and torch.equal(k_hit[0], t_hit[0]),
          f"engine closest-hit tri ids and t equal, kernel vs twin ({label})")
    check(torch.equal(k_occ[0], t_occ[0]), f"engine any-hit equal, kernel vs twin ({label})")
    check(not bool(k_hit[4].any()) and not bool(k_occ[1].any()), f"engine overflow all false ({label})")
    return k_hit


def camera_window(cam, dev, time=None):
    """w2.SUBWAVE camera rays of the driven frame at half its resolution, as
    (n, 3) origins and directions; ``time``: each ray's shutter time."""
    side = int(w2.SUBWAVE ** 0.5)
    cx, cy, pixel_ids = pixel_grid(side, side, device=dev)
    rays, _ = generate_rays(cam, cx, cy, make_stream(pixel_ids.to(torch.int64), 0, seed=0), time=time)
    return torch.stack(tuple(rays.origin), 1), torch.stack(tuple(rays.dir), 1)


def bounce_window(o, d, t, hit, dev):
    """Bounce rays that leave the hit points of the rays ``o``, ``d`` (hit
    at ``t`` where ``hit``; the others keep their origin) in seeded random
    directions."""
    bo = torch.where(hit[:, None], o + d * (t * (1.0 - 1e-4))[:, None], o)
    bd = np.random.default_rng(12).normal(size=(o.shape[0], 3)).astype(np.float32)
    return bo, torch.as_tensor(bd / np.linalg.norm(bd, axis=1, keepdims=True), device=dev)


def cluster_windows(cs, o, d, reach, dev, label):
    """The wave2_mt kernel and the wave2 engine held against the twin on the
    cluster set ``cs``, with two windows of the driven path: the camera rays
    ``o``, ``d``, and bounce rays that leave those rays' hit points in
    seeded random directions (rays that hit nothing keep their origin).
    Any-hit rays are ``reach`` long.  Returns {window: check_wave2_window's
    numbers}."""
    t, tri = engine_agrees(cs, o, d, reach, dev, f"{label} camera")[:2]
    windows = {"camera": tct.check_wave2_window(cs, o, d, reach, dev, log, label=f"{label} camera window")}
    bo, bd = bounce_window(o, d, t, tri >= 0, dev)
    engine_agrees(cs, bo, bd, reach, dev, f"{label} bounce")
    windows["bounce"] = tct.check_wave2_window(cs, bo, bd, reach, dev, log, label=f"{label} bounce window")
    return windows


def interior_render(path, dev, smi, label, textured, passes=4):
    """Phases 12 and 13: load an interior scene, check what it holds, render
    512^2 depth 6 MIS under wave2 (1 warm-up + ``passes`` timed, one profiled)
    with the wave2_mt launches counted; before the render, the kernel and the
    engine against the twin on this scene's cluster set (cluster_windows).
    Returns (viewport, {"launches": ..., "windows": ...}, the radiance after
    the 1 + ``passes`` passes, before the profiled one)."""
    t0 = time.perf_counter()
    scene, meta, cam = load_scene(path, strict=True, device=dev)
    torch.cuda.synchronize()
    cs = scene.clusters
    log(f"scene: {label} loaded in {time.perf_counter() - t0:.1f} s; {scene.tris.count} tris, {cs.num_clusters} "
        f"clusters, {cs.num_supers} supers x 8 x {cs.tris_per_cluster}; {scene.prims.count} prims, "
        f"{scene.materials.bsdf.shape[0]} materials, light kinds {meta.light_kinds}, scene radius "
        f"{meta.scene_radius:.2f}; textures "
        f"{None if scene.textures is None else tuple(scene.textures.data.shape)}, env_dist "
        f"{None if scene.env_dist is None else tuple(scene.env_dist.density.shape)}; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check(750_000 <= scene.tris.count <= 850_000, "the interior holds about 800k triangles")
    check(meta.light_kinds == (0, 0, 1), "2 area lights and the background light")
    if textured:
        check(scene.textures is not None and scene.env_dist is not None,
              "the textured interior has its atlas and its env distribution")
        check(scene.textures.kinds_present == (0, 1, 2, 3) and scene.textures.max_octaves == 4,
              "the atlas holds bitmaps, a checkerboard, a 4-octave noise and a mix")
    else:
        check(scene.textures is None and scene.env_dist is None,
              "the interior has no textures (the OBJ maps are ignored, as in the reference loader)")
    check(traverse.get_traversal_mode() == "auto" and not os.environ.get("RT_TRAVERSAL_MODE"),
          "the traversal mode is the default (auto -> wave2)")
    windows = cluster_windows(cs, *camera_window(cam, dev), float(meta.scene_radius), dev, label)
    vp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True), device=dev)
    counts0 = launch_counts()
    (_, _, _, overflow, radiance), (extract, joins) = extract_on_every_round(
        lambda: timed_render(vp, passes, smi, f"{label} [wave2]"), f"{label} [wave2]")
    launches = (launch_counts() - counts0)["wave2_mt"]
    log(f"{label} [wave2]: wave2_mt launches {launches} in {passes + 1} passes; mean radiance {radiance.mean():.6f}")
    check(launches > 0, f"the {label} render launched the wave2_mt kernel")
    check(overflow == 0, f"{label}: traversal overflow is 0")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, f"{label}: radiance finite with non-zero mean")
    texture_launches = texture_launches_per_call(vp, label) if textured else 0
    profiled(lambda: vp.render(1), f"{label} [wave2] pass", named=("wave2_mt", "textures_kernel"))
    return vp, {"launches": launches, "extract_launches": extract, "join_launches": joins, "windows": windows,
                "mean": float(radiance.mean()), "texture_launches": texture_launches}, radiance


def texture_launches_per_call(vp, label):
    """One pass under tracing: the ``textures`` kernel's launches against
    the ``sample_texture_many`` calls (its ``textures`` spans) and the
    counter ``launches.textures``: one a call.  Returns the launches."""
    profiler.reset()
    counts0 = launch_counts()
    with profiler.enable():
        vp.render(1)
        torch.cuda.synchronize()
        counted = profiler.counters().get("launches.textures", 0)
    calls = sum(1 for r in profiler.records() if r.name == "textures")
    launched = (launch_counts() - counts0)["textures"]
    profiler.reset()
    log(f"{label}: one traced pass made {calls} sample_texture_many calls and {launched} textures kernel launches "
        f"(counter launches.textures {counted})")
    check(calls > 0 and launched == calls == counted, f"{label}: the textures kernel launched once a call")
    return launched


def bvh_windows(scene, meta, cam, dev, label):
    """Phases 14 and 15 on one scene's BVH: the bvh_walk kernel against its twin
    (check_bvh_walk) and the walk against the wave2 engine
    (bvh_against_wave2) on two windows of w2.SUBWAVE rays: the camera rays
    of the frame at half its resolution, and bounce rays that leave those
    rays' hit points in seeded random directions.  Any-hit rays are as long
    as the scene's radius.  Returns {window: {"closest": ..., "any-hit":
    ..., "wave2": counts}}."""
    o, d = camera_window(cam, dev)
    reach = float(meta.scene_radius)
    first = bt.bvh_walk(scene.bvh, vec(o, dev), vec(d, dev), torch.full((o.shape[0],), 3.0e38, device=dev), False)
    bo, bd = bounce_window(o, d, first.t, first.tri >= 0, dev)
    out = {}
    for window, (wo, wd) in (("camera", (o, d)), ("bounce", (bo, bd))):
        out[window] = tct.check_bvh_walk(scene.bvh, wo, wd, reach, dev, log, label=f"{label} {window} window")
        out[window]["wave2"] = tct.bvh_against_wave2(scene.bvh, scene.clusters, wo, wd, reach, dev, log,
                                                     label=f"{label} {window} window")
    return out


def bvh_render(scene, meta, cam, dev, smi, label, wave2_mean, windows):
    """A 512^2, depth 6, MIS render under the ``bvh`` mode (1 warm-up + 4
    timed passes): bvh_walk launches, no wave2_mt launch, mean radiance
    within 1e-3 of the wave2 render's at the same seed and passes.  Returns
    the bvh_walk launches."""
    traverse.set_traversal_mode("bvh")
    vp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True), device=dev)
    counts0 = launch_counts()
    _, _, _, overflow, radiance = timed_render(vp, 4, smi, f"{label} [bvh]")
    launched = launch_counts() - counts0
    launches, w2_launches = launched["bvh_walk"], launched["wave2_mt"]
    traverse.set_traversal_mode("auto")
    rel = abs(float(radiance.mean()) - wave2_mean) / wave2_mean
    most = max(w[kind]["max_steps"] for w in windows.values() for kind in ("closest", "any-hit"))
    log(f"{label} [bvh]: bvh_walk launches {launches}, wave2_mt launches {w2_launches} in 5 passes; largest steps "
        f"a ray in the windows {most}; mean radiance {radiance.mean():.6f} against wave2's {wave2_mean:.6f}: "
        f"relative difference {rel:.3e}")
    check(launches > 0 and w2_launches == 0, f"the {label} bvh render launched bvh_walk and not wave2_mt")
    check(overflow == 0 and bool(np.isfinite(radiance).all()), f"{label} [bvh]: no overflow, finite radiance")
    check(rel <= 1e-3, f"{label}: the bvh render's mean radiance within 1e-3 of the wave2 render's")
    check(traverse.get_traversal_mode() == "auto", "the traversal mode is back to auto")
    return launches


def scene_bytes(scene) -> int:
    """Bytes of every tensor a scene holds (each storage counted once)."""
    seen = {}

    def walk(x):
        if torch.is_tensor(x):
            seen[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))
        elif hasattr(x, "_fields"):
            walk(tuple(x))

    walk(scene)
    return sum(seen.values())


def instance_windows(scene, meta, cam, dev, label, time=None):
    """cluster_windows on the instanced scene's cluster sets: the shell's,
    and each geometry's with the camera rays moved into the object space of
    the instance of that geometry that the camera sees most (the rays each
    instance query gives the kernel).  ``time`` (one a ray): the rays'
    shutter times, for the camera's pose and each instance's.  Returns
    {"<set> <window>": numbers}."""
    o, d = camera_window(cam, dev, time)
    reach = float(meta.scene_radius)
    windows = {f"shell {w}": v for w, v in cluster_windows(scene.clusters, o, d, reach, dev, f"{label} shell").items()}
    seen = traverse.scene_traverse(scene, vec(o, dev), vec(d, dev), time=time).inst_id
    per_inst = torch.bincount(seen[seen >= 0].long(), minlength=scene.instances.count).tolist()
    for m, geom in enumerate(scene.mesh_geoms):
        i = max((i for i, mid in enumerate(scene.instances.mesh_ids) if mid == m), key=lambda i: per_inst[i])
        lo, ld = traverse._instance_local_ray(scene, i, vec(o, dev), vec(d, dev), time)
        name = f"geometry {m} ({geom.tris.count} tris) in instance {i}"
        if time is not None and any(float(c[i]) != 0.0 for c in scene.instances.vel):
            name += " moving, each ray at its shutter time"
        log(f"{label}: {name} is what {per_inst[i]} of {o.shape[0]} camera rays see first")
        got = cluster_windows(geom.clusters, torch.stack(tuple(lo), 1), torch.stack(tuple(ld), 1), reach, dev,
                              f"{label} {name}")
        windows.update({f"{name} {w}": v for w, v in got.items()})
    return windows


def instance_path(vp, label, meshes):
    """One pass traced and profiled: the top level's engine queries (counter
    ``instances.queries``) against the traversals that reached the
    instances (their ``traverse.instances`` spans), at most one a shared
    mesh each, and the device operations launched inside those spans.
    Returns (queries, traversals, launches)."""
    from torch.profiler import ProfilerActivity, profile

    profiler.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vp.render(1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c, recs = profiler.counters(), profiler.records()
    traversals = sum(1 for r in recs if r.name == "traverse.instances")
    ops = profiler.device_ops(prof)
    launches = profiler.device_ops_by_span(ops, recs).get("traverse.instances", 0)
    ms = profiler.device_ms_by_span(ops, recs).get("traverse.instances", 0.0)
    queries = c.get("instances.queries", 0)
    fill = 100.0 * c.get("instances.pairs_sent", 0) / max(c.get("instances.pairs_tested", 0), 1)
    profiler.reset()
    log(f"{label} traced pass: {wall * 1e3:.1f} ms; {queries} instance engine queries in {traversals} traversals "
        f"({queries / max(traversals, 1):.2f} a traversal), {launches} of {len(ops)} device operations "
        f"({ms:.1f} ms) launched inside traverse.instances, pairs sent {fill:.3f}% of those tested")
    check(traversals > 0 and queries <= meshes * traversals,
          f"{label}: at most one engine query a shared mesh a traversal ({meshes} a traversal)")
    return queries, traversals, launches


def instanced_hall(baked, dev, smi):
    """Phase 15: the instanced hall against the baked one (``baked`` is the
    phase-12 viewport); before the renders, wave2_mt and the wave2 engine
    against the twin on each of its cluster sets (instance_windows) and
    bvh_walk against its twin on the shell's BVH (bvh_windows).  Returns
    (the wave2 render's wave2_mt launches and windows, the bvh pass's
    (bvh_walk, wave2_mt) launches and the bvh_walk windows)."""
    t0 = time.perf_counter()
    path = torch_gen_interior.ensure_interior_inst(INTERIOR_DIR)
    scene, meta, cam = load_scene(path, strict=True, device=dev)
    torch.cuda.synchronize()
    geoms, inst = scene.mesh_geoms, scene.instances
    world = scene.tris.count + sum(geoms[m].tris.count for m in inst.mesh_ids)
    stored = scene.tris.count + sum(g.tris.count for g in geoms)
    own, theirs = scene_bytes(scene), scene_bytes(baked.scene)
    log(f"scene: interior800k_inst_mis loaded in {time.perf_counter() - t0:.1f} s; {len(geoms)} geometries "
        f"({[g.tris.count for g in geoms]} tris), {inst.count} instances, {scene.tris.count} baked tris; "
        f"{stored} tris stored for {world} in the world (baked hall: {baked.scene.tris.count}); scene tensors "
        f"{own / 2**20:.1f} MiB against the baked hall's {theirs / 2**20:.1f} MiB; BVH nodes {scene.bvh.num_nodes}")
    check(len(geoms) == 2 and inst.count == 31, "the instanced hall holds 2 geometries and 31 instances")
    check(world == baked.scene.tris.count, "its world holds the baked hall's triangle count")
    check(traverse.get_traversal_mode() == "auto", "the traversal mode is the default (auto -> wave2)")
    windows = instance_windows(scene, meta, cam, dev, "interior800k_inst_mis")
    log(f"scene: interior800k_inst_mis shell BVH {bvh_stats(scene.bvh)}, step budget "
        f"{bt.walk_budget(scene.bvh.num_nodes)}")
    walk_windows = bvh_windows(scene, meta, cam, dev, "interior800k_inst_mis shell")
    vp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True), device=dev)
    counts0 = launch_counts()
    dt, _, _, overflow, radiance = timed_render(vp, 1, smi, "interior800k_inst_mis [wave2]")
    launches = (launch_counts() - counts0)["wave2_mt"]
    check(launches > 0 and overflow == 0, "interior800k_inst_mis: wave2_mt launched, overflow 0")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, "interior800k_inst_mis: radiance finite, non-zero")
    log(f"interior800k_inst_mis [wave2]: wave2_mt launches {launches} in 2 passes, {dt * 1e3:.1f} ms a pass")
    instance_path(vp, "interior800k_inst_mis [wave2]", len(geoms))
    ref = Viewport(baked.scene, baked.meta, baked.cam, ViewportParams(512, 512, seed=0),
                   RenderParams(max_depth=6, mis=True), device=dev).render(2).radiance()
    rel = abs(float(radiance.mean()) - float(ref.mean())) / float(ref.mean())
    log(f"interior800k_inst_mis: mean radiance {radiance.mean():.6f} against the baked hall's {ref.mean():.6f} "
        f"after 2 passes each: relative difference {rel:.3e}")
    check(rel <= 0.01, "the instanced hall's mean radiance within 1% of the baked hall's")
    traverse.set_traversal_mode("bvh")
    counts0 = launch_counts()
    bvp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True), device=dev)
    t0 = time.perf_counter()
    bvp.render(1)
    torch.cuda.synchronize()
    launched = launch_counts() - counts0
    both = (launched["bvh_walk"], launched["wave2_mt"])
    traverse.set_traversal_mode("auto")
    log(f"interior800k_inst_mis [bvh] one pass: {(time.perf_counter() - t0) * 1e3:.1f} ms; bvh_walk launches "
        f"{both[0]} (the shell), wave2_mt launches {both[1]} (the instances)")
    check(both[0] > 0 and both[1] > 0, "under bvh the shell launched bvh_walk and the instances wave2_mt")
    return (launches, windows), (both, walk_windows), scene


def fwd_bwd_phase(hall, mesh, dev, smi):
    """Phase 16: reverse-mode gradients (tools/torch_check_gradients.py).
    The test scene's gradients on the card against the CPU; the hall's
    forward+backward step at 256^2, depth 4 under wave2 (the driven path:
    timed, its wave2_mt launches counted, one call profiled) and under bvh
    (its gradients equal to wave2's); central differences and train_step
    descent on the hall; the wave engine against wave2 on camera and bounce
    windows of mesh200k and the hall.  ``hall`` is phase 12's viewport,
    ``mesh`` the (scene, meta, cam) of mesh200k.  Returns the wave2_mt and
    the bvh_walk launches of the two steps."""
    t16 = time.perf_counter()
    scene, meta, cam = hall.scene, hall.meta, hall.cam
    tcg.check_against_cpu(dev, log)

    label = "interior800k_fwd_bwd"
    check(traverse.get_traversal_mode() == "auto" and not os.environ.get("RT_TRAVERSAL_MODE"),
          "the traversal mode is the default (auto -> wave2)")
    counts0 = launch_counts()
    step, grads = tcg.time_fwd_bwd(scene, meta, cam, dev, log, f"{label} [wave2]")
    launches = (launch_counts() - counts0)["wave2_mt"]
    check(launches > 0, f"the {label} step launched the wave2_mt kernel")
    vp, params = ViewportParams(256, 256, seed=0), RenderParams(max_depth=4, mis=True)
    device_ms = profiled(lambda: tcg.fwd_bwd(scene, meta, cam, vp, params)[1][0][:1].cpu(), f"{label} [wave2] call",
                         named=("wave2_mt",))
    idle = 1 - device_ms / (step["s_per_call"] * 1e3)
    log(f"mrays_per_sec_interior800k_fwd_bwd {step['mrays_per_sec']:.4f} Mray/s (forward rays; the cost includes the "
        f"reverse pass), {step['s_per_call'] * 1e3:.1f} ms a call, forward alone {step['forward_s'] * 1e3:.1f} ms; "
        f"device time of a profiled call {device_ms:.1f} ms: idle {idle:.3f} ({smi})")
    RENDERS.append(f"summary {label} [wave2]: mrays_per_sec_interior800k_fwd_bwd {step['mrays_per_sec']:.4f}, "
                   f"{step['s_per_call'] * 1e3:.1f} ms a call (forward alone {step['forward_s'] * 1e3:.1f} ms, with "
                   f"the graph {step['forward_with_graph_s'] * 1e3:.1f} ms), {step['rays']:.0f} rays a forward, "
                   f"wave2_mt launches {launches} in {step['forwards']} forwards, peak {step['peak_gib']:.2f} GiB, saved "
                   f"{step['saved_gib']:.3f} GiB, idle {idle:.3f}")

    traverse.set_traversal_mode("bvh")
    counts0 = launch_counts()
    bstep, bgrads = tcg.time_fwd_bwd(scene, meta, cam, dev, log, f"{label} [bvh]")
    launched = launch_counts() - counts0
    walk_launches, w2_launches = launched["bvh_walk"], launched["wave2_mt"]
    traverse.set_traversal_mode("auto")
    check(walk_launches > 0 and w2_launches == 0, f"the {label} step under bvh launched bvh_walk and not wave2_mt")
    tcg.gradients_agree(bgrads, grads, f"{label}: bvh against wave2", log, tcg.SCENE_PARAMS[:7])
    RENDERS.append(f"summary {label} [bvh]: {bstep['mrays_per_sec']:.4f} Mray/s, {bstep['s_per_call'] * 1e3:.1f} ms "
                   f"a call (forward alone {bstep['forward_s'] * 1e3:.1f} ms), bvh_walk launches {walk_launches} in "
                   f"{bstep['forwards']} forwards, peak {bstep['peak_gib']:.2f} GiB")

    tcg.check_finite_differences(scene, meta, cam, log)
    tcg.descend(scene, meta, cam, log)

    for name, (sc, me, ca) in (("mesh200k", mesh), ("interior800k", (scene, meta, cam))):
        o, d = camera_window(ca, dev)
        reach = float(me.scene_radius)
        t, tri = w2.wave2_closest_hit(sc.clusters, vec(o, dev), vec(d, dev), 3.0e38)[:2]
        for window, (wo, wd) in (("camera", (o, d)), ("bounce", bounce_window(o, d, t, tri >= 0, dev))):
            tcg.wave_against_wave2(sc.clusters, wo, wd, reach, dev, log, f"{name} {window} window")
    log(f"phase 16 (gradients) wall time {time.perf_counter() - t16:.1f} s")
    return launches, walk_launches


def integrator_phases(hall, inst_scene, mt, dev, smi):
    """Phases 17 to 19 (tools/torch_check_integrators.py): the entry point
    on the Cornell box; LT and VCM on the hall (``hall``: phase 12's
    viewport), with wave2_mt against its twin on VCM's vertex-connection
    rays; the debug renderer and the counters on the hall, TriangleID
    against a CPU copy of the hall, the traversal cost beside the instanced
    hall's (``inst_scene``).  Adds the driven
    paths to wave2_mt's row ``mt``."""
    # --- 17. the command-line entry point on the Cornell box ------------------
    t17 = time.perf_counter()
    cli_stats = tci.entry_point(dev, log, os.path.join(ROOT, "raytracer_tpu_torch", "_build", "cli_out"))
    for name in ("mis", "lt", "vcm"):
        st = cli_stats[name]
        RENDERS.append(f"summary cornell_{name} (cli, 512^2, --max-depth 10): {st['seconds']} s for 4 passes, "
                       f"{st['mrays_per_sec']} Mray/s as the CLI prints it, mean radiance {st['mean']:.6f} (off the "
                       f"lights {st['mean_off_lights']:.6f})")
    RENDERS.append(f"summary cornell VCM without merging 512^2, 4 passes: mean off the lights "
                   f"{cli_stats['bdpt']['mean_off_lights']:.6f}; the CLI's VCM: {cli_stats['vcm']['photons']} photons, "
                   f"{cli_stats['vcm']['cells_over']} cells over max_per_cell")
    log(f"phase 17 (entry point) wall time {time.perf_counter() - t17:.1f} s")

    # --- 18. LT and VCM on the hall ------------------------------------------------
    t18 = time.perf_counter()
    check(traverse.get_traversal_mode() == "auto", "the traversal mode is the default (auto -> wave2)")
    hall_out = tci.hall_integrators(hall.scene, hall.meta, hall.cam, dev, log, smi, profiled)
    o, d, tl = hall_out["window"]
    window = tct.check_wave2_window(hall.scene.clusters, o, d, tl, dev, log, label="interior800k vcm connection window")
    mt["by_path"]["interior800k_lt"] = {"launches": hall_out["lt"]["wave2_mt_launches"], "windows_of": "interior800k_mis",
                                        "windows": mt["by_path"]["interior800k_mis"]["windows"]}
    mt["by_path"]["interior800k_vcm"] = {"launches": hall_out["vcm"]["wave2_mt_launches"],
                                         "windows": {"vertex connection": window}}
    for name in ("lt", "vcm"):
        h = hall_out[name]
        RENDERS.append(f"summary interior800k_{name} [wave2] 512^2: {h['s_per_pass'] * 1e3:.1f} ms a pass, rays "
                       f"{h['rays']} and shadow rays {h['shadow_rays']}, {(h['rays'] + h['shadow_rays']) / h['s_per_pass'] / 1e6:.4f}"
                       f" Mray/s, wave2_mt launches {h['wave2_mt_launches']}, peak {h['peak_gib']:.2f} GiB"
                       + (f", {h['photons']} photons, {h['cells_over']} cells over max_per_cell, device idle "
                          f"{h['idle']:.3f}" if name == "vcm" else ""))
    log(f"phase 18 (LT and VCM on the hall) wall time {time.perf_counter() - t18:.1f} s")

    # --- 19. the debug renderer and the traversal counters on the hall -----------
    t19 = time.perf_counter()
    counts0 = launch_counts()
    counted = tci.debug_and_counters(hall.scene, hall.meta, hall.cam, dev, log, inst_scene=inst_scene)
    mt["by_path"]["interior800k_mis count_traversal + debug"] = {"launches": (launch_counts() - counts0)["wave2_mt"],
                                                                 "windows_of": "interior800k_mis",
                                                                 "windows": mt["by_path"]["interior800k_mis"]["windows"]}
    RENDERS.append(f"summary interior800k_mis count_traversal 512^2: {counted['s_per_pass'] * 1e3:.1f} ms a pass, "
                   f"total_box_tests {counted['box_tests']:.0f}, total_tri_tests {counted['tri_tests']:.0f}")
    log(f"phase 19 (debug renderer and counters) wall time {time.perf_counter() - t19:.1f} s")


def fx_phase(dev, smi):
    """Phase 20 (tools/torch_check_features.py): (a) each scene effect alone
    on the card against the CPU port, and the spectral box's brightness
    against RGB; (b) interior800k_fx_mis, the instanced hall with every
    effect at 512^2, depth 6, MIS, wave2, strength 1, spectral (1 warm-up +
    1 timed pass); before it, wave2_mt and the engine
    against the twin on the shell's and each geometry's cluster set, the
    rays at their shutter times (a moving knot's object space); after it,
    one pass under bvh against the warm-up pass, and strength 0 against the
    hall held still at 128^2.  Returns (wave2_mt launches and windows of the
    render, the bvh pass's bvh_walk launches)."""
    t20 = time.perf_counter()
    features, apart = tfx.device_against_cpu(dev, log)
    s_mean, rgb_mean, s_pass = tfx.spectral_brightness(dev, log, smi=smi)
    RENDERS.append(f"summary phase 20 a (64^2, card against the CPU port): ms a card pass "
                   + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in features.items())
                   + f"; values apart as without the feature {apart}"
                   + f"; spectral Cornell 256^2, 16 passes: mean {s_mean:.6f} against RGB {rgb_mean:.6f}, "
                     f"{s_pass * 1e3:.1f} ms a pass")
    log(f"phase 20 a (features against the CPU) wall time {time.perf_counter() - t20:.1f} s")

    label = "interior800k_fx_mis"
    t0 = time.perf_counter()
    path = torch_gen_interior.ensure_interior_fx(INTERIOR_DIR)
    loaded, meta, loaded_cam = load_scene(path, strict=True, device=dev)
    scene, cam = tfx.fx_effects(loaded, meta, loaded_cam, path, dev)
    torch.cuda.synchronize()
    inst = scene.instances
    log(f"scene: {label} loaded in {time.perf_counter() - t0:.1f} s; {len(scene.mesh_geoms)} geometries, "
        f"{inst.count} instances ({int((inst.vel.y != 0).sum())} moving), {scene.prims.count} prims, "
        f"{scene.decals.count} decals, dispersive materials {scene.materials.dispersive.nonzero().flatten().tolist()}, "
        f"atlas {tuple(scene.textures.data.shape)}, env_dist {tuple(scene.env_dist.density.shape)}; camera DoF "
        f"{cam.enable_dof}, bokeh {cam.bokeh_shape}, shutter pose {cam.enable_motion_blur}")
    check(len(scene.mesh_geoms) == 2 and inst.count == 31 and scene.decals.count == 3,
          "the fx hall holds 2 geometries, 31 instances and 3 decals")
    check(traverse.get_traversal_mode() == "auto", "the traversal mode is the default (auto -> wave2)")
    times = tfx.shutter_times(w2.SUBWAVE, dev)
    windows = instance_windows(scene, meta, cam, dev, label, time=times)
    check(any("moving" in k for k in windows), "a window of rays in a moving instance's object space")
    vp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0, motion_blur_strength=1.0),
                  RenderParams(max_depth=6, mis=True, spectral=True), device=dev)
    counts0 = launch_counts()
    first = []
    dt, rays, shadow, overflow, radiance = timed_render(vp, 1, smi, f"{label} [wave2]", first=first)
    launches = (launch_counts() - counts0)["wave2_mt"]
    check(launches > 0 and overflow == 0, f"{label}: wave2_mt launched, overflow 0")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, f"{label}: radiance finite, non-zero")
    # one timed pass and no profiled one: on an H100 host a pass takes ~16 s, a profiled one ~76 s of the
    # script's time limit (its last reading is in PERF.md)
    log(f"{label} [wave2]: wave2_mt launches {launches} in 2 passes, {dt * 1e3:.1f} ms a pass")

    traverse.set_traversal_mode("bvh")
    counts0 = launch_counts()
    bvp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0, motion_blur_strength=1.0),
                   RenderParams(max_depth=6, mis=True, spectral=True), device=dev)
    t0 = time.perf_counter()
    bmean = float(bvp.render(1).radiance().mean())
    launched = launch_counts() - counts0
    both = (launched["bvh_walk"], launched["wave2_mt"])
    traverse.set_traversal_mode("auto")
    rel = abs(bmean - first[0]) / first[0]
    log(f"{label} [bvh] one pass: {(time.perf_counter() - t0) * 1e3:.1f} ms; bvh_walk launches {both[0]} (the "
        f"shell), wave2_mt launches {both[1]} (the instances); mean radiance {bmean:.6f} against the wave2 "
        f"render's first pass {first[0]:.6f}: relative difference {rel:.3e}")
    check(both[0] > 0 and both[1] > 0, "under bvh the shell launched bvh_walk and the instances wave2_mt")
    check(rel <= 1e-3, f"{label}: the bvh pass's mean radiance within 1e-3 of the wave2 render's")
    tfx.zero_strength_is_still(scene, meta, cam, dev, log)
    check(traverse.get_traversal_mode() == "auto", "the traversal mode is back to auto")
    log(f"phase 20 (scene effects) wall time {time.perf_counter() - t20:.1f} s")
    return (launches, windows), both[0]


def frameloop_phase(hall, hall_radiance4, mesh, mt, dev):
    """Phase 21 (tools/torch_check_frameloop.py).  (a) AdaptiveViewport at
    512^2, depth 6, MIS, wave2, reference defaults, 8 passes, on the hall
    (``hall``: phase 12's viewport; ``hall_radiance4``: its radiance after
    4 passes) and on mesh200k (``mesh``; against a 4-pass Viewport): after
    pass 4 bit-equal to the uniform render; wave2_mt against its twin on
    each adapted pass's wavefront.  (b) checkpoint / resume on mesh200k at
    512^2, bit-equal to the straight 4-pass film.  (c) debug_pixel_path of a
    hall pixel and a Cornell pixel on the card against the CPU port.  (d)
    every packed codec over 2^20 lanes, the card's codes the CPU's.  Adds the
    driven paths to wave2_mt's row ``mt``."""
    t21 = time.perf_counter()
    check(traverse.get_traversal_mode() == "auto", "the traversal mode is the default (auto -> wave2)")
    mscene, mmeta, mcam = mesh
    straight = Viewport(mscene, mmeta, mcam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True),
                        device=dev).render(4)
    for label, (sc, me, ca), uniform4 in (
            ("interior800k_adaptive", (hall.scene, hall.meta, hall.cam), hall_radiance4),
            ("mesh200k_adaptive", mesh, average_radiance(straight.film).cpu().numpy())):
        av, st = tfl.adaptive_run(sc, me, ca, dev, log, label, uniform4=uniform4)
        window = tct.check_wave2_window(sc.clusters, *tfl.wavefront_window(av, dev), float(me.scene_radius), dev, log,
                                        label=f"{label} adapted wavefront window")
        mt["by_path"][label] = {"launches": st["launches"], "windows": {"adapted wavefront": window}}
        last = st["per_pass"][-1]
        RENDERS.append(f"summary {label} 512^2 depth 6, AdaptiveSettings(), 8 passes: ms a pass "
                       f"{[round(q['ms'], 1) for q in st['per_pass']]}, wavefront lanes "
                       f"{[q['lanes'] for q in st['per_pass']]}; after the last: active blocks {last['active_blocks']}, "
                       f"active pixels {last['active_pixels']}, converged {last['converged_fraction']:.4f}, error "
                       f"{last['error_db']:.2f} dB; rays {sum(q['rays'] for q in st['per_pass']):.0f}, wave2_mt "
                       f"launches {st['launches']}; first 4 passes bit-equal to the uniform render")
    log(f"phase 21 a (adaptive) wall time {time.perf_counter() - t21:.1f} s")

    counts0 = launch_counts()
    ck = tfl.checkpoint_resume(mscene, mmeta, mcam, dev, log, os.path.join(ROOT, "raytracer_tpu_torch", "_build",
                                                                           "checkpoints"), "mesh200k_mis", straight)
    mt["by_path"]["mesh200k_mis checkpoint resume"] = {"launches": (launch_counts() - counts0)["wave2_mt"],
                                                       "windows_of": "mesh200k_mis",
                                                       "windows": mt["by_path"]["mesh200k_mis"]["windows"]}
    RENDERS.append(f"summary mesh200k_mis checkpoint 512^2: save {ck['save_s']:.3f} s, load {ck['load_s']:.3f} s, "
                   f"{ck['bytes']} bytes; resumed film bit-equal to the straight 4 passes")

    counts0 = launch_counts()
    t0 = time.perf_counter()
    cpu_hall = tci.scene_on(hall.scene, "cpu"), tci.scene_on(hall.cam, "cpu")
    log(f"interior800k: a CPU copy of the hall in {time.perf_counter() - t0:.1f} s")
    hall_ms, path = tfl.path_replay(hall.scene, hall.meta, hall.cam, *cpu_hall, (256, 256), 512, 6, dev, log,
                                    "interior800k", cpu_mode="bvh")
    check(any(v.tri_id >= 0 for v in path.vertices), "the hall pixel's replayed path hits a triangle")
    mt["by_path"]["interior800k path replay (one-ray windows)"] = {
        "launches": (launch_counts() - counts0)["wave2_mt"], "windows_of": "interior800k_mis",
        "windows": mt["by_path"]["interior800k_mis"]["windows"]}
    cs, cm, cc = tci.port_cornell(dev)
    ps, _, pc = tci.port_cornell("cpu")
    cornell_ms, _ = tfl.path_replay(cs, cm, cc, ps, pc, (256, 400), 512, 6, dev, log, "cornell")
    codec_ms = tfl.packed_codecs(dev, log)
    RENDERS.append(f"summary phase 21 c-d: path replay {hall_ms:.1f} ms (hall pixel, {len(path.vertices)} vertices), "
                   f"{cornell_ms:.1f} ms (Cornell pixel), equal to the CPU port's; packed codecs over 2^20 lanes, "
                   f"encode + decode ms {', '.join(f'{k} {v:.3f}' for k, v in codec_ms.items())}, codes bit-equal to "
                   f"the CPU's")
    log(f"phase 21 (frame-loop extras) wall time {time.perf_counter() - t21:.1f} s")


def parallel_phase(mesh, mesh_json, mt, dev):
    """Phase 22 (tools/torch_check_parallel.py): (a) this process as an
    NCCL world of one: render_pass_sharded on mesh200k (``mesh``, written at
    ``mesh_json``) at 512^2, render_pass_vcm_sharded of the Cornell box at
    512^2, train_step_sharded at 64^2, each bit-equal to the unsharded
    function; (b) two gloo ranks on the card, each band held against (a).
    Adds the driven paths to wave2_mt's row ``mt``."""
    t22 = time.perf_counter()
    work = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "parallel")
    got, one = tpar.world_of_one(mesh, tci.port_cornell(dev), dev, log, work)
    mt["by_path"]["mesh200k_sharded (NCCL, world of one)"] = {
        "launches": got["launches"], "windows_of": "mesh200k_mis", "windows": mt["by_path"]["mesh200k_mis"]["windows"]}
    log(f"phase 22 a (world of one) wall time {time.perf_counter() - t22:.1f} s")
    ranks = tpar.two_ranks(mesh_json, one, dev, log, work)
    mt["by_path"]["mesh200k_sharded (gloo, 2 ranks on one card)"] = {
        "launches": sum(int(r["launches"]) for r in ranks), "windows_of": "mesh200k_mis",
        "windows": mt["by_path"]["mesh200k_mis"]["windows"]}
    RENDERS.append(f"summary phase 22: NCCL world of one, mesh200k 512^2 ms a pass {got['ms'].round(1).tolist()}, "
                   f"Cornell VCM {got['vcm_ms']:.1f} ms, all bit-equal to the unsharded functions; 2 gloo ranks on one "
                   f"card, ms a pass " + "; ".join(
                       f"rank {i} {r['ms'].round(1).tolist()}, VCM {float(r['vcm_ms']):.1f} ms, wave2_mt launches "
                       f"{int(r['launches'])}, host bytes {int(r['host_bytes'])}" for i, r in enumerate(ranks))
                   + "; bands bit-equal, VCM and train step within the reference's bounds")
    log(f"phase 22 (multi-device) wall time {time.perf_counter() - t22:.1f} s")


def helpers_phase(dev, smi):
    """Phase 23 (tools/torch_check_helpers.py): (a) every new helper of
    math/vec.py, math/sampling.py, math/distribution.py, ops/intersect.py and
    render/film.py over 2^20 lanes on the card against the CPU port: bit-equal,
    or within the bound of tch.BOUNDS with the op that rounds otherwise; (b)
    sphere_grid at 32^2 on the card against the CPU; (c) sphere_grid at 512^2,
    depth 6, MIS (1 warm-up + 4 timed passes, one profiled): its analytic path
    launches no kernel."""
    t23 = time.perf_counter()
    tch.helpers_against_cpu(dev, log)
    tch.sphere_grid_against_cpu(dev, log)
    scene, meta, cam = tch.sphere_grid_scene(dev)
    check(scene.prims.count == 64 and scene.tris is None, "sphere_grid holds 64 spheres and no triangle")
    vp = Viewport(scene, meta, cam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True), device=dev)
    counts0 = launch_counts()
    dt, rays, shadow, overflow, radiance = timed_render(vp, 4, smi, "sphere_grid_mis")
    check(launch_counts() == counts0, "the sphere_grid render (analytic prims only) launched no traversal kernel")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0 and overflow == 0,
          "sphere_grid_mis: radiance finite with non-zero mean, no overflow")
    device_ms = profiled(lambda: vp.render(1), "sphere_grid_mis pass")
    log(f"sphere_grid_mis: device time {device_ms:.1f} ms of an unprofiled pass's {dt / 4 * 1e3:.1f} ms: idle "
        f"{1 - device_ms / (dt / 4 * 1e3):.3f}; mean radiance {radiance.mean():.6f} ({smi})")
    RENDERS.append(f"summary sphere_grid_mis device: {device_ms:.1f} ms of device time in a profiled pass, idle "
                   f"{1 - device_ms / (dt / 4 * 1e3):.3f}")
    log(f"phase 23 (helpers and sphere_grid) wall time {time.perf_counter() - t23:.1f} s")


def big_bvh_against_wave2(bvh, cs, o, d, dev, label, reach=4.0):
    """tct.walk_against_wave2 on the 2M-triangle grid: the same rays hit, t
    within 1e-6 relative where both hit, occlusion equal.  Tri ids are
    logged, not held: on a grid of 2M small triangles a ray through a
    shared edge can fall inside both triangles for one Möller-Trumbore
    spelling and inside one for the other, at t an ulp or two apart
    (tct.bvh_against_wave2 holds the driven scenes' ids but on exact ties)."""
    counts, walk, (w_t, w_tri), _ = tct.walk_against_wave2(bvh, cs, o, d, reach, dev)
    differ = torch.nonzero(walk.tri != w_tri).flatten().tolist()
    log(f"bvh vs wave2 [2M-triangle heightfield {label} window]: {counts}; differing rays (bvh tri, t; wave2 tri, "
        f"t): " + ", ".join(f"{i}: ({int(walk.tri[i])}, {float(walk.t[i]):.9g}; {int(w_tri[i])}, {float(w_t[i]):.9g})"
                            for i in differ[:8]))
    check(torch.equal(walk.tri >= 0, w_tri >= 0), f"bvh and wave2 hit the same rays (2M-triangle grid, {label})")
    check(counts["max_rel_t"] <= 1e-6, f"bvh and wave2 t within 1e-6 relative (2M-triangle grid, {label})")
    check(counts["occluded_differ"] == 0, f"bvh and wave2 occlusion equal (2M-triangle grid, {label})")
    return counts


def _add_path(rows, kernel, path, launches, windows=None, windows_of=None):
    entry = {"launches": launches}
    if windows is not None:
        entry["windows"] = windows
    if windows_of is not None:
        entry["windows_of"] = windows_of
    rows[kernel].setdefault("by_path", {})[path] = entry


def tools_phase(mesh, rows, dev, smi):
    """Phase 24: the tools and the entry points on the card.  (a)
    tools/torch_traversal_bench.py at 200k triangles and 2^20 rays, every
    engine's launches counted into its kernel's by_path; (b) one 512^2 MIS
    depth-6 pass of mesh200k (``mesh``) under the ``cluster`` mode, its tri
    ids against wave2's on the camera and bounce windows; (c) a BVH over
    more than a million nodes (2M triangles), bvh_walk against its twin and
    against wave2; (d) the oracles tools/torch_check_wave2.py and
    tools/torch_check_pallas.py; (e) tools/torch_microbench.py; (f)
    entry() and dryrun_multichip(1) (NCCL) and (2) (gloo on this card), the
    bands bit-equal to one process's render_pass; (g)
    tools/torch_scaling_bench.py at 1 and 2 ranks; (h)
    tools/torch_probe_render.py, one pass."""
    t24 = time.perf_counter()
    mscene, mmeta, mcam = mesh

    # --- a. every engine at 200k triangles, 2^20 rays ----------------------------
    bench, results = ttb.run(200_000, 1 << 20, dev=dev, log=log)
    kernel_of = {"wave2": "wave2_mt", "pallas": "phase2_grid", "sorted": "phase2_stream", "bvh": "bvh_walk"}
    for engine, kernel in kernel_of.items():
        n = sum(results[label][engine][q]["launches"].get(kernel, 0) for label in results for q in ("closest", "any"))
        _add_path(rows, kernel, f"traversal_bench {engine} (200k tris, 2^20 coherent + incoherent rays)", n)
        check(n > 0, f"traversal_bench: the {engine} engine launched {kernel}")
    for label in results:
        for engine, fig in results[label].items():
            RENDERS.append(f"summary traversal_bench [{label}] {engine}: closest {fig['closest']['ms']:.2f} ms "
                           f"({fig['closest']['mrays_per_sec']:.2f} Mray/s, agree {fig['closest'].get('agree_vs_wave2', 1.0):.5f}, "
                           f"ovf {fig['closest']['overflow_share']:.4f}), any-hit {fig['any']['ms']:.2f} ms "
                           f"({fig['any']['mrays_per_sec']:.2f} Mray/s, agree {fig['any'].get('agree_vs_wave2', 1.0):.5f}), "
                           f"peak {max(fig['closest']['peak_gib'], fig['any']['peak_gib']):.2f} GiB")
    del bench, results
    log(f"phase 24 a (traversal bench) wall time {time.perf_counter() - t24:.1f} s")

    # --- b. mesh200k at 512^2 under the cluster mode ------------------------------
    t0 = time.perf_counter()
    traverse.set_traversal_mode("cluster")
    vp = Viewport(mscene, mmeta, mcam, ViewportParams(512, 512, seed=0), RenderParams(max_depth=6, mis=True), device=dev)
    counts0 = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    vp.render(1)
    radiance = vp.radiance()
    ms = (time.perf_counter() - t1) * 1e3
    traverse.set_traversal_mode("auto")
    prog = vp.progress()
    log(f"mesh200k_mis [cluster] one 512^2 pass: {ms:.1f} ms, rays {prog['total_rays']:.0f}, shadow rays "
        f"{prog['total_shadow_rays']:.0f}, overflow {prog['total_traversal_overflow']:.0f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, mean radiance {radiance.mean():.6f} ({smi})")
    check(launch_counts() == counts0, "the cluster mode launched no kernel (plain PyTorch)")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, "mesh200k_mis [cluster]: radiance finite")
    o, d = camera_window(mcam, dev)
    w = w2.wave2_closest_hit(mscene.clusters, vec(o, dev), vec(d, dev), 3.0e38)
    agree = {}
    for window, (wo, wd) in (("camera", (o, d)), ("bounce", bounce_window(o, d, w[0], w[1] >= 0, dev))):
        c_hit = cluster_closest_hit(mscene.clusters, vec(wo, dev), vec(wd, dev), 3.0e38)
        w_hit = w2.wave2_closest_hit(mscene.clusters, vec(wo, dev), vec(wd, dev), 3.0e38)
        both = ~c_hit[4] & ~w_hit[4]
        agree[window] = float((c_hit[1] == w_hit[1])[both].float().mean())
        log(f"mesh200k [{window} window] cluster against wave2: tri ids agree on {agree[window]:.5f} of the "
            f"{int(both.sum())} rays neither flags ({int(c_hit[4].sum())} flagged by cluster)")
    RENDERS.append(f"summary mesh200k_mis [cluster] 512^2: {ms:.1f} ms for one pass, overflow "
                   f"{prog['total_traversal_overflow']:.0f}, tri agreement with wave2 {agree}")
    log(f"phase 24 b (cluster mode) wall time {time.perf_counter() - t0:.1f} s")

    # --- c. a BVH over more than a million nodes ----------------------------------
    t0 = time.perf_counter()
    v0, e1, e2 = ttb.make_mesh(2_000_000, np.random.default_rng(3))
    tri_v = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float32)
    zero = np.zeros_like(tri_v)
    (lv0, le1, le2, *_), big = build_bvh_over_triangles(tri_v, zero, zero[..., :2], np.zeros(len(tri_v), np.int32),
                                                        device=dev)
    check(big.num_nodes > 1_000_000, f"a BVH of {big.num_nodes} nodes over {len(tri_v)} triangles, built")
    leaf_cs = build_clusters(lv0, le1, le2, device=dev)
    before, windows = launch_counts(), {}
    for window, (bo, bd) in (("coherent", coherent_rays(w2.SUBWAVE)),
                             ("incoherent", incoherent_rays(w2.SUBWAVE, np.random.default_rng(5)))):
        walk = tct.check_bvh_walk(big, bo, bd, 4.0, dev, log, label=f"2M-triangle heightfield {window} window")
        walk["wave2"] = big_bvh_against_wave2(big, leaf_cs, bo, bd, dev, window)
        windows[window] = walk
    _add_path(rows, "bvh_walk", f"bvh over {big.num_nodes} nodes (2M-triangle heightfield)",
              (launch_counts() - before)["bvh_walk"], windows=windows)
    row = rows["bvh_walk"]
    row["max_abs_err"] = max([row["max_abs_err"]] + [w[k]["max_abs_err"] for w in windows.values()
                                                     for k in ("closest", "any-hit")])
    del big, leaf_cs
    log(f"phase 24 c (BVH over a million nodes) wall time {time.perf_counter() - t0:.1f} s")

    # --- d. the oracles -------------------------------------------------------------
    t0 = time.perf_counter()
    counts0 = launch_counts()
    check(tcw2.check(dev, log=log), "tools/torch_check_wave2.py: wave2 agrees with the cluster oracle")
    counts1 = launch_counts()
    check(tcpal.check(dev, log=log), "tools/torch_check_pallas.py: the block-candidate engine within the bars")
    counts2 = launch_counts()
    _add_path(rows, "wave2_mt", "check_wave2 oracle (20k tris, 8,192 rays)", counts1["wave2_mt"] - counts0["wave2_mt"])
    _add_path(rows, "phase2_grid", "check_pallas oracle (500 / 20k tris)",
              counts2["phase2_grid"] - counts1["phase2_grid"])
    check(counts1["wave2_mt"] > counts0["wave2_mt"] and counts2["phase2_grid"] > counts1["phase2_grid"],
          "the oracles launched wave2_mt and phase2_grid")
    log(f"phase 24 d (oracles) wall time {time.perf_counter() - t0:.1f} s")

    # --- e. the micro-benchmarks --------------------------------------------------------
    t0 = time.perf_counter()
    before = launch_counts()
    bench_lines = tmb.main([], out=log)
    check([r["bench"] for r in bench_lines] == list(tmb.BENCHES), "the eight micro-benchmarks ran")
    _add_path(rows, "wave2_mt", "microbench scene_traverse_mesh_bvh (2^20 rays, random_mesh_scene)",
              (launch_counts() - before)["wave2_mt"])
    RENDERS.append("summary microbench: " + ", ".join(f"{r['bench']} {r['rate']} {r['unit']}" for r in bench_lines))
    log(f"phase 24 e (microbench) wall time {time.perf_counter() - t0:.1f} s")

    # --- f. entry() and dryrun_multichip -----------------------------------------------------
    t0 = time.perf_counter()
    fn, args = port_entry.entry(dev)
    film, _ = fn(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(film.sum).all()) and float(film.sum.mean()) > 0, "entry(): a finite 64^2 film")
    scene, meta, cam = port_entry.flagship_scene(dev)
    dry = {}
    for n in (1, 2):
        backend = backend_for(n, dev)  # NCCL for one rank on this card, gloo for two sharing it
        t1 = time.perf_counter()
        got = port_entry.dryrun_multichip(n, dev, work_dir=os.path.join(ROOT, "raytracer_tpu_torch", "_build",
                                                                        f"dryrun{n}"))
        vp, params = port_entry.dryrun_params(n)
        one = render_pass(scene, meta, cam, make_film(vp.width, vp.height, dev), 0, None, vp, params)[0].sum.cpu().numpy()
        same = np.array_equal(got["film"], one)
        dry[n] = (got["loss"], time.perf_counter() - t1, got["backend"])
        log(f"dryrun_multichip({n}) [{got['backend']}]: loss {got['loss']:.6f}, forward bands "
            f"{'bit-equal' if same else 'DIFFERENT'} to one process's render_pass, VCM finite, host bytes "
            f"{got['host_bytes']}; {time.perf_counter() - t1:.1f} s from spawn to the last exit")
        check(got["backend"] == backend, f"dryrun_multichip({n}) ran over {backend}")
        check(same and np.isfinite(got["loss"]), f"dryrun_multichip({n}): finite loss, bands bit-equal to one process")
    RENDERS.append("summary entry points: entry() 64^2 film finite; " + ", ".join(
        f"dryrun_multichip({n}) [{b}] loss {loss:.6f} in {sec:.1f} s" for n, (loss, sec, b) in dry.items()))
    log(f"phase 24 f (entry points) wall time {time.perf_counter() - t0:.1f} s")

    # --- g. scaling over 1 and 2 ranks ---------------------------------------------------
    t0 = time.perf_counter()
    per, summary = tsb.run(dev, (1, 2), 256, 4, log=log, out=log)
    RENDERS.append(f"summary scaling_bench 256^2 Cornell: " + "; ".join(
        f"{n} ranks [{v['backend']}] {v['value']} Mray/s, {v['seconds_per_pass']} s a pass" for n, v in per.items())
        + f"; {summary['metric']} {summary['value']}")
    log(f"phase 24 g (scaling) wall time {time.perf_counter() - t0:.1f} s")

    # --- h. the render probe, one pass -------------------------------------------------------
    before = launch_counts()
    probe = tpr.probe(mscene, mmeta, mcam, dev, n_passes=1, log=log)
    _add_path(rows, "wave2_mt", "probe_render (mesh200k 512^2, 2 passes)", (launch_counts() - before)["wave2_mt"])
    RENDERS.append(f"summary probe_render mesh200k 512^2: first pass {probe['first_s']:.2f} s, "
                   f"{probe['ms_a_pass']:.1f} ms a pass, {probe['mrays_per_sec']:.4f} Mray/s")
    for kernel in ("wave2_mt", "phase2_grid", "phase2_stream", "bvh_walk"):
        for path, entry in rows[kernel]["by_path"].items():
            check(entry["launches"] > 0, f"{kernel}: launched {entry['launches']} times on {path}")
    log(f"phase 24 (tools and entry points) wall time {time.perf_counter() - t24:.1f} s")


def wave2_config_phase(mesh, mesh_json, hall, mt, dev):
    """Phase 25 (tools/torch_check_wave2_config.py) on mesh200k (``mesh``,
    its file ``mesh_json``) and the hall (phase 12's viewport ``hall``):
    adds the front-to-back, CHUNK 256 and SPATIAL_KEY 0 renders and their
    windows to wave2_mt's row ``mt``."""
    t25 = time.perf_counter()
    out = tcw2c.run(mesh, mesh_json, (hall.scene, hall.meta, hall.cam), dev, log,
                    work_dir=os.path.join(ROOT, "raytracer_tpu_torch", "_build", "phase25"))
    w, n = out["windows"], out["launches"]
    mt["by_path"]["mesh200k_mis ftb kc 4 (phase 25)"] = {"launches": n["mesh200k ftb4"], "windows": w["mesh200k"]}
    mt["by_path"]["interior800k_mis ftb kc 4 (phase 25)"] = {"launches": n["interior800k ftb4"],
                                                            "windows": w["interior800k"]}
    mt["by_path"]["mesh200k_mis CHUNK 256, 2 rows a chunk (phase 25, child process)"] = {
        "launches": n["mesh200k chunk 256"], "windows": w["mesh200k CHUNK 256"]}
    mt["by_path"]["mesh200k_mis SPATIAL_KEY 0 (phase 25)"] = {
        "launches": n["mesh200k spatial_key 0"], "windows_of": "mesh200k_mis",
        "windows": mt["by_path"]["mesh200k_mis"]["windows"]}
    RENDERS.extend(out["summary"])
    log(f"phase 25 (wave2 settings) wall time {time.perf_counter() - t25:.1f} s")


def log_bvh_builds():
    """From here on, every BVH a scene build makes (scene/bvh.py's
    build_bvh_over_triangles, which scene/build.py looks up at each call) is
    logged with its own wall time and the device memory it adds, and must
    come from the native builder (not the pure-Python fallback)."""
    build = bvh_module.build_bvh_over_triangles

    def timed(tri_v, *args, **kw):
        torch.cuda.synchronize()
        before, t0 = torch.cuda.memory_allocated(), time.perf_counter()
        python_trees = bvh_module.BUILDER_COUNTS["python"]
        out = build(tri_v, *args, **kw)
        torch.cuda.synchronize()
        check(bvh_module.BUILDER_COUNTS["python"] == python_trees, "the BVH came from the native builder")
        log(f"bvh build: {tri_v.shape[0]} tris -> {out[1].num_nodes} nodes on {kw.get('device')} in "
            f"{time.perf_counter() - t0:.3f} s; device memory {before / 2**20:.1f} -> "
            f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB (+{(torch.cuda.memory_allocated() - before) / 2**20:.1f}"
            f" MiB; the BVHFlat tables {scene_bytes(out[1]) / 2**20:.1f} MiB)")
        return out

    bvh_module.build_bvh_over_triangles = timed


def main():
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    _LOG.append(open(LOG_PATH, "w"))
    try:
        run()
    except BaseException as e:  # the failure goes into the log too, then on
        log(f"FAIL: {type(e).__name__}: {e}")
        raise
    finally:
        _LOG.pop().close()


def run():
    # --- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false; this script needs one NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    tcw2c.check_clean_environment(log)

    # --- 2 + 6. build every library, one nvcc each, together ---------------
    t0 = time.perf_counter()
    cuda_build.build_kernel_libraries(LIBRARIES)
    log(f"build: {len(LIBRARIES)} libraries in {time.perf_counter() - t0:.2f} s")
    for kernel in LIBRARIES:
        cuda_build.load_kernel_library(kernel)
        log(f"build [{kernel}] {cuda_build.BUILD_INFO[kernel]['seconds']:.2f} s\n{cuda_build.BUILD_INFO[kernel]['log']}")

    # --- 3. wave2 kernel vs twin: one real window, the tie cases, K = 8 and 128 ---
    log_bvh_builds()
    t0 = time.perf_counter()
    mscene, mmeta, mcam = load_scene(bench_mesh.ensure_scene(200_000), device=dev)
    cs_set = mscene.clusters
    log(f"scene: mesh200k loaded in {time.perf_counter() - t0:.1f} s; {mscene.tris.count} tris, "
        f"{cs_set.num_clusters} clusters, {cs_set.num_supers} supers x 8 x {cs_set.tris_per_cluster}")
    rows = {"wave2_mt": tct.check_wave2_kernel(cs_set, dev, log)}
    rng = np.random.default_rng(7)

    # --- 4. the wave2 engine, kernel path against twin path ----------------
    for label, (o, d) in (("coherent", coherent_rays(w2.SUBWAVE)),
                          ("incoherent", incoherent_rays(w2.SUBWAVE, rng))):
        engine_agrees(cs_set, o, d, 4.0, dev, label)

    # --- 5. the wave2 slice --------------------------------------------------
    params = RenderParams(max_depth=6, mis=True)
    check(traverse.get_traversal_mode() == "auto" and not os.environ.get("RT_TRAVERSAL_MODE"),
          "the traversal mode is the default (auto -> wave2)")
    small_render_agrees(params, dev, "wave2")
    vp = Viewport(mscene, mmeta, mcam, ViewportParams(512, 512, seed=0), params, device=dev)
    counts0 = launch_counts()
    (_, _, _, overflow, radiance), _ = extract_on_every_round(
        lambda: timed_render(vp, 4, smi, "mesh200k_mis [wave2]"), "mesh200k_mis [wave2]")
    mesh_mean = float(radiance.mean())
    launches = (launch_counts() - counts0)["wave2_mt"]
    rows["wave2_mt"]["launches"] = launches  # warm-up + timed passes of this drive
    log(f"mesh200k_mis [wave2]: wave2_mt launches {launches}")
    check(launches > 0, "the mesh render launched the wave2_mt kernel")
    check(overflow == 0, "traversal overflow is 0")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, "radiance finite with non-zero mean")
    profiled(lambda: vp.render(1), "mesh200k_mis [wave2] pass", named=("wave2_mt",))

    cscene, cmeta = cornell_box(device=dev)
    t_kw, c_kw = cornell_camera_kw()
    ccam = make_camera(RigidTransform(**t_kw), **c_kw, device=dev)
    cvp = Viewport(cscene, cmeta, ccam, ViewportParams(512, 512, seed=0), params, device=dev)
    _, _, _, _, crad = timed_render(cvp, 8, smi, "cornell_mis")
    check(bool(np.isfinite(crad).all()) and crad.mean() > 0, "cornell radiance finite with non-zero mean")

    # --- 7. block-candidate kernels against their plain versions -----------
    rows.update(tct.check_kernels(cs_set, dev, log, reps=20, plain_reps=5))

    # --- 8. block-candidate engines, kernel path against plain path --------
    counts0 = launch_counts()
    tct.check_engines(cs_set, dev, log)
    launched = launch_counts() - counts0
    rows["phase2_grid"]["launches"] = launched["phase2_grid"]
    log(f"engines: phase2_grid launches {launched['phase2_grid']}, phase2_stream launches "
        f"{launched['phase2_stream']} (kernel-path calls only; the plain path launches nothing)")
    check(launched["phase2_grid"] > 0, "the pallas_cluster_* and _pallas_sorted_closest_hit engines launched "
                                       "the phase2_grid kernel")

    # --- 9. the sorted-pallas slice ----------------------------------------
    traverse.set_traversal_mode("sorted-pallas")
    small_render_agrees(params, dev, "sorted-pallas")
    vp = Viewport(mscene, mmeta, mcam, ViewportParams(512, 512, seed=0), params, device=dev)
    counts0 = launch_counts()
    _, rays, shadow, overflow, radiance = timed_render(vp, 4, smi, "mesh200k_mis [sorted-pallas]")
    launched = launch_counts() - counts0
    rows["phase2_stream"]["launches"] = launched["phase2_stream"]
    log(f"mesh200k_mis [sorted-pallas]: phase2_stream launches {launched['phase2_stream']}, wave2_mt launches "
        f"{launched['wave2_mt']}, overflow share {overflow / max(rays + shadow, 1):.4f} of rays + shadow rays")
    check(launched["phase2_stream"] > 0 and launched["wave2_mt"] == 0,
          "the sorted-pallas render launched the phase2_stream kernel and not wave2_mt")
    check(bool(np.isfinite(radiance).all()) and radiance.mean() > 0, "radiance finite with non-zero mean")
    profiled(lambda: vp.render(1), "mesh200k_mis [sorted-pallas] pass")
    # the same mode through the environment, which overrides set_traversal_mode
    traverse.set_traversal_mode("auto")
    os.environ["RT_TRAVERSAL_MODE"] = "sorted-pallas"
    before = launch_counts()
    env_vp = Viewport(mscene, mmeta, mcam, ViewportParams(128, 128, seed=0), params, device=dev).render(1)
    del os.environ["RT_TRAVERSAL_MODE"]
    check((launch_counts() - before)["phase2_stream"] > 0 and bool(np.isfinite(env_vp.radiance()).all()),
          "RT_TRAVERSAL_MODE=sorted-pallas reaches the stream kernel")
    check(traverse.get_traversal_mode() == "auto", "the traversal mode is back to auto")

    # --- 10. probes -----------------------------------------------------------
    err = tpl.check_add_one(dev, log)
    counts0 = launch_counts()
    probe = tpl.probe_dispatch(dev, log)
    launches = (launch_counts() - counts0)["add_one"]  # the empty kernel counts under empty_launch
    b_ms, b_by = bound_ms(2 * tpl.PROBE_SHAPE[0] * tpl.PROBE_SHAPE[1] * 4, tpl.PROBE_SHAPE[0] * tpl.PROBE_SHAPE[1])
    rows["add_one"] = {"name": "add_one", "route": "cuda", "source": "raytracer_tpu_torch/csrc/add_one.cu",
                       "replaces": "tools/probe_r4.py:29", "launches": launches, "max_abs_err": err,
                       "ms": probe["add_one_grid_graph_us"] / 1e3, "plain_ms": probe["torch_add_graph_us"] / 1e3,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": probe["torch_add_graph_us"] / 1e3}
    check(launches > 0, "the dispatch probe launched the add_one kernel")
    tpl.probe_mt_chunks(cs_set, dev, log)

    # --- 11. textures (the kernel against its twin), env map and postprocess against the CPU ---
    rows["textures"] = tctex.check_all(dev, log)

    # --- 12. the 800k-triangle interior, as the reference renders it ----------
    t0 = time.perf_counter()
    plain_json = torch_gen_interior.ensure_interior(INTERIOR_DIR)
    log(f"scene: interior files under _build/interior in {time.perf_counter() - t0:.1f} s")
    mt = rows["wave2_mt"]
    window = {key: mt[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    mt["by_path"] = {"mesh200k_mis": {"launches": mt["launches"], "windows": {"incoherent": window}}}
    # 3 timed passes (1 + 3 = the 4 passes that phase 21 holds the adaptive render against)
    hall, mt["by_path"]["interior800k_mis"], hall_radiance4 = interior_render(plain_json, dev, smi, "interior800k_mis",
                                                                              False, passes=3)
    rows["wave2_extract"] = tct.check_extract_kernel(hall.scene.clusters, *camera_window(hall.cam, dev), dev, log)
    rows["wave2_extract"]["launches"] = mt["by_path"]["interior800k_mis"]["extract_launches"]
    rows["wave2_join"] = tct.check_join_kernels(hall.scene.clusters, *camera_window(hall.cam, dev), dev, log)
    rows["wave2_join"]["launches"] = mt["by_path"]["interior800k_mis"]["join_launches"]

    # --- 13. the textured interior ---------------------------------------------
    small = small_render_agrees(params, dev, "wave2", name="small textured scene",
                                small=torch_gen_interior.ensure_small_textured(INTERIOR_DIR + "_small"))
    check(small.scene.textures is not None and small.scene.env_dist is not None,
          "the small textured scene has its atlas and its env distribution")
    vp, mt["by_path"]["interior800k_tex_mis"], _ = interior_render(
        torch_gen_interior.ensure_interior_tex(INTERIOR_DIR), dev, smi, "interior800k_tex_mis", True, passes=2)
    rows["textures"]["launches"] = mt["by_path"]["interior800k_tex_mis"]["texture_launches"]
    t0 = time.perf_counter()
    image = vp.image()
    log(f"interior800k_tex_mis: Viewport.image() in {(time.perf_counter() - t0) * 1e3:.1f} ms: {image.shape} "
        f"{image.dtype}, min {image.min()}, max {image.max()}, mean {image.mean():.2f}, "
        f"{float((image == 255).mean()):.4f} of values saturated")
    check(image.shape == (512, 512, 3) and image.dtype == np.uint8, "image() is a (512, 512, 3) uint8 array")
    check(image.min() < image.max() and float((image == 255).mean()) < 0.5 and float((image == 0).mean()) < 0.5,
          "the image is neither constant nor saturated")

    # --- 14. the skip-link BVH walk: kernel, engine, renders -------------------
    t14 = time.perf_counter()
    by_path = {}
    for label, (sc, me, ca, mean) in (("mesh200k_mis", (mscene, mmeta, mcam, mesh_mean)),
                                      ("interior800k_mis", (hall.scene, hall.meta, hall.cam,
                                                            mt["by_path"]["interior800k_mis"]["mean"]))):
        log(f"scene: {label} BVH {bvh_stats(sc.bvh)}, step budget {bt.walk_budget(sc.bvh.num_nodes)}")
        windows = bvh_windows(sc, me, ca, dev, label)
        by_path[label] = {"windows": windows, "launches": bvh_render(sc, me, ca, dev, smi, label, mean, windows)}
    log(f"phase 14 (bvh walk) wall time {time.perf_counter() - t14:.1f} s")

    # --- 15. the instanced hall --------------------------------------------------
    t15 = time.perf_counter()
    (inst_launches, inst_windows), (inst_bvh, walk_windows), inst_scene = instanced_hall(hall, dev, smi)
    mt["by_path"]["interior800k_inst_mis"] = {"launches": inst_launches, "windows": inst_windows}
    by_path["interior800k_inst_mis (shell under bvh, one pass)"] = {"launches": inst_bvh[0], "windows": walk_windows}
    mt["max_abs_err"] = max(w["max_abs_err"] for path in mt["by_path"].values() for w in path["windows"].values())
    log(f"phase 15 (instanced hall) wall time {time.perf_counter() - t15:.1f} s")

    # --- 16. reverse-mode gradients: the hall's forward+backward step ----------
    fb_launches, fb_walk = fwd_bwd_phase(hall, (mscene, mmeta, mcam), dev, smi)
    mt["by_path"]["interior800k_fwd_bwd"] = {"launches": fb_launches, "windows_of": "interior800k_mis",
                                             "windows": mt["by_path"]["interior800k_mis"]["windows"]}
    by_path["interior800k_fwd_bwd (bvh)"] = {"launches": fb_walk, "windows_of": "interior800k_mis",
                                             "windows": by_path["interior800k_mis"]["windows"]}

    integrator_phases(hall, inst_scene, mt, dev, smi)

    # --- 20. the scene effects, alone and on the hall ----------------------------
    (fx_launches, fx_windows), fx_walk = fx_phase(dev, smi)
    mt["by_path"]["interior800k_fx_mis"] = {"launches": fx_launches, "windows": fx_windows}
    by_path["interior800k_fx_mis (shell under bvh, one pass)"] = {
        "launches": fx_walk, "windows_of": "interior800k_inst_mis (shell under bvh, one pass)",
        "windows": walk_windows}

    # --- 21. the frame-loop extras: adaptive, checkpoint, path replay, codecs -----
    frameloop_phase(hall, hall_radiance4, (mscene, mmeta, mcam), mt, dev)

    # --- 22. multi-device: a world of one (NCCL), two gloo ranks on the card -----
    parallel_phase((mscene, mmeta, mcam), bench_mesh.ensure_scene(200_000), mt, dev)
    mt["max_abs_err"] = max(w["max_abs_err"] for path in mt["by_path"].values() for w in path["windows"].values())

    top = by_path["mesh200k_mis"]["windows"]["bounce"]["closest"]
    rows["bvh_walk"] = {
        "name": "bvh_walk", "route": "cuda", "source": "raytracer_tpu_torch/csrc/bvh_walk.cu",
        "replaces": "raytracer_tpu/ops/bvh_traverse.py:131", "launches": sum(
            by_path[p]["launches"] for p in ("mesh200k_mis", "interior800k_mis", "interior800k_fwd_bwd (bvh)")),
        "max_abs_err": max(w[k]["max_abs_err"] for p in by_path.values() for w in p["windows"].values()
                           for k in ("closest", "any-hit")),
        **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "by_path": by_path}

    # --- 23. the new helpers and the materials-test scene ----------------------------
    helpers_phase(dev, smi)

    # --- 24. the tools and the entry points ---------------------------------------------
    tools_phase((mscene, mmeta, mcam), rows, dev, smi)

    # --- 25. wave2's settings: front to back, CHUNK 256, SPATIAL_KEY 0, the ablations ---
    wave2_config_phase((mscene, mmeta, mcam), bench_mesh.ensure_scene(200_000), hall, mt, dev)
    mt["max_abs_err"] = max(w["max_abs_err"] for path in mt["by_path"].values()
                            for w in path.get("windows", {}).values())
    check(bvh_module.BUILDER_COUNTS["python"] == 0 and bvh_module.BUILDER_COUNTS["native"] > 0,
          f"every BVH of the run came from the native builder ({bvh_module.BUILDER_COUNTS})")

    check("PIL" not in sys.modules, "no phase imported PIL")
    for mod in ("jax", "raytracer_tpu"):
        check(not any(m == mod or m.startswith(mod + ".") for m in sys.modules), f"no {mod} module was imported")
    for row in rows.values():
        check(row["launches"] > 0, f"{row['name']}: launched {row['launches']} times on its driven path")
    for path, entry in mt["by_path"].items():
        check(entry["launches"] > 0, f"wave2_mt: launched {entry['launches']} times on {path}")

    for line in RENDERS:
        log(line)
    log(f"chip_smoke.py wall time {time.perf_counter() - T_START:.1f} s")
    log(f"{smi}")
    log(json.dumps({"kernels": [rows[kernel] for kernel in KERNELS]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
