"""wave2's candidate extraction: the algorithm of ``csrc/wave2_extract.cu``
against its plain twin ``p1_extract_reference``, on the CPU.

The kernel runs only on the card (``tools/torch_check_traverse.py::
check_extract_kernel`` holds it against the twin there).  ``ballot_walk``
below writes its walk out as a plain function: for each ray, the supers in
words of 32 from the word that holds cursor + 1, boxes staged in tiles with
NaN boxes past Cs, a word's hit bits as ``__ballot_sync`` gives them, each
hit id written at ``found + popc(bits below it)`` while that slot is below
kc, the count carried from word to word, Cs written into the slots left
after the walk and ``rem = max(found - kc, 0)``.  It must equal the twin
element for element, in ``cand`` and in ``rem``, on the meshes of
``test_torch_wave2.py`` and on the edge rays of ``extract_edge_rays``
(origins inside boxes, axis-parallel directions on and below the 1e-12
floor, padded rays with tl = 0, any-hit rays with tl < 0, cursors at -1, in
the middle and at Cs - 1), with a Cs that is not a multiple of 32, a Cs
below the default kc (then kc = Cs, as ``wave2_closest_hit`` clamps it), kc
1, 4, 16 and 33, and with tiles smaller than Cs.

Also: the wrapper ``_p1_extract`` takes the twin for CPU tensors and raises
on a device without the kernel, and under tracing it counts the box tests
(rays x Cs a round) and, on the CPU, no kernel launch.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.ops import wave2_traverse as w2
from raytracer_tpu_torch.ops.cuda_build import launch_counts
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.clusters import build_clusters
from raytracer_tpu_torch.scene.presets import random_mesh_scene
from raytracer_tpu_torch.utils import profiler

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from torch_check_traverse import extract_edge_rays  # noqa: E402
from traversal_bench import coherent_rays, incoherent_rays, make_mesh  # noqa: E402

KERNEL_TILE = 4096  # kMaxTile of csrc/wave2_extract.cu
N_RAYS = 2048


def ballot_walk(cs_set, ox, oy, oz, dx, dy, dz, tl, cursor, kc, tile=KERNEL_TILE):
    """The kernel's walk, all rays at once: one step a word of 32 supers."""
    n, cs = ox.shape[0], cs_set.num_supers
    tile = min(-(-cs // 32) * 32, tile)
    tiny = 1e-12
    inv = lambda v: 1.0 / torch.where(torch.abs(v) > tiny, v, torch.where(v >= 0.0, tiny, -tiny))
    ix, iy, iz = inv(dx), inv(dy), inv(dz)
    lim = torch.abs(tl)
    lo = torch.clamp(cursor.to(torch.int64) + 1, 0, cs)
    work = (lim > 0.0) & (lo < cs)
    found = torch.zeros(n, dtype=torch.int64)
    cand = torch.full((n, kc), -7, dtype=torch.int32)  # a slot the walk never writes stays -7
    lane = torch.arange(32)
    rows = torch.arange(n)[:, None].expand(n, 32)
    for t0 in range(0, cs, tile):
        staged = torch.full((tile, 6), float("nan"))
        staged[: min(tile, cs - t0)] = cs_set.super_box[t0:t0 + tile]
        start = torch.maximum(lo, torch.tensor(t0)) & ~31  # each ray's first word in this tile
        for w in range(t0, min(t0 + tile, cs), 32):
            b = staged[w - t0:w - t0 + 32]
            slab = lambda q, o, i: (b[None, :, q] - o[:, None]) * i[:, None]
            t1x, t2x = slab(0, ox, ix), slab(3, ox, ix)
            t1y, t2y = slab(1, oy, iy), slab(4, oy, iy)
            t1z, t2z = slab(2, oz, iz), slab(5, oz, iz)
            tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                                 torch.minimum(t1z, t2z))
            tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                                 torch.maximum(t1z, t2z))
            ent = torch.maximum(tmin, torch.zeros(()))
            walked = (work & (w >= start))[:, None]
            hit = walked & (tmax >= ent) & (ent < lim[:, None]) & ((w + lane)[None] >= lo[:, None])
            below = torch.cumsum(hit, 1) - hit.to(torch.int64)  # popc(word & lanes below)
            slot = found[:, None] + below
            write = hit & (slot < kc)
            cand[rows[write], slot[write]] = (w + lane).expand(n, 32)[write].to(torch.int32)
            found += hit.sum(1)
    pad = torch.arange(kc)[None] >= found[:, None]
    cand = torch.where(pad, cs, cand)
    return cand, torch.clamp_min(found - kc, 0).to(torch.int32)


def _mesh(n_tris, seed, k=8):
    return build_clusters(*make_mesh(n_tris, np.random.default_rng(seed)), k=k, device="cpu")


@pytest.fixture(scope="module")
def meshes():
    """The 2k-triangle mesh of test_torch_wave2.py, a 20k-triangle one
    (Cs not a multiple of 32) and a 300-triangle one (Cs below 16)."""
    got = {"mesh2k": _mesh(2000, 7), "mesh20k": _mesh(20_000, 5), "mesh300": _mesh(300, 3)}
    assert got["mesh20k"].num_supers % 32 and got["mesh2k"].num_supers % 32
    assert got["mesh300"].num_supers < w2.KC
    return got


def _wave2_rays(n, rng):
    """test_torch_wave2.py's rays: coherent and incoherent halves, limits
    mixed closest / any-hit / zero."""
    oc, dc = coherent_rays(n // 2, rng)
    oi, di = incoherent_rays(n // 2, rng)
    o = np.stack([np.concatenate([np.asarray(oc[i]), np.asarray(oi[i])]) for i in range(3)], 1)
    d = np.stack([np.concatenate([np.asarray(dc[i]), np.asarray(di[i])]) for i in range(3)], 1)
    u = rng.random(n)
    tl = np.where(u < 0.3, -rng.uniform(1.0, 20.0, n), 3.0e38).astype(np.float32)
    tl[u > 0.95] = 0.0
    return o.astype(np.float32), d.astype(np.float32), tl


def _inputs(cs_set, rays, cursor, seed):
    rng = np.random.default_rng(seed)
    cs = cs_set.num_supers
    if rays == "wave2":
        o, d, tl = _wave2_rays(N_RAYS, rng)
        cur = np.full(N_RAYS, -1, np.int32)
    else:
        o, d, tl, cur = extract_edge_rays(cs_set, N_RAYS, rng)
    cur = {"minus1": np.full_like(cur, -1), "middle": np.full_like(cur, cs // 2), "last": np.full_like(cur, cs - 1),
           "mixed": cur if rays == "edge" else rng.integers(-1, cs, N_RAYS).astype(np.int32)}[cursor]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    return [t(o[:, i]) for i in range(3)] + [t(d[:, i]) for i in range(3)] + [t(tl), t(cur)]


@pytest.mark.parametrize("cursor", ["minus1", "middle", "last", "mixed"])
@pytest.mark.parametrize("kc", [1, 4, 16, 33])
@pytest.mark.parametrize("mesh,rays", [("mesh2k", "wave2"), ("mesh2k", "edge"), ("mesh20k", "edge"),
                                       ("mesh300", "edge")])
def test_ballot_walk_equals_the_twin(meshes, mesh, rays, kc, cursor):
    cs_set = meshes[mesh]
    kc = min(kc, cs_set.num_supers)
    args = _inputs(cs_set, rays, cursor, seed=kc)
    want = w2.p1_extract_reference(cs_set, *args, kc)
    got = ballot_walk(cs_set, *args, kc)
    assert got[0].dtype == want[0].dtype == torch.int32 and got[1].dtype == want[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if cursor != "last":
        assert (want[0] < cs_set.num_supers).any()  # the rays enter boxes
    else:
        assert not (want[0] < cs_set.num_supers).any() and not want[1].any()


@pytest.mark.parametrize("tile", [32, 64, 96])
def test_ballot_walk_in_tiles_smaller_than_cs(meshes, tile):
    """A Cs above the kernel's tile is walked tile by tile: the same answer."""
    cs_set = meshes["mesh20k"]
    assert cs_set.num_supers > tile
    args = _inputs(cs_set, "edge", "mixed", seed=tile)
    want = w2.p1_extract_reference(cs_set, *args, 16)
    got = ballot_walk(cs_set, *args, 16, tile=tile)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] > 0).any()  # some rays overflow kc, so the count crosses tiles


def test_edge_rays_reach_the_edges(meshes):
    cs_set = meshes["mesh20k"]
    o, d, tl, cur = extract_edge_rays(cs_set, N_RAYS, np.random.default_rng(0))
    box = cs_set.super_box.numpy()
    inside = ((o[:, None] >= box[None, :, :3]) & (o[:, None] <= box[None, :, 3:])).all(-1).any(1)
    assert inside.mean() > 0.2
    assert (np.abs(d) == 1e-12).any() and (np.abs(d) == np.float32(1e-13)).any() and (np.signbit(d) & (d == 0)).any()
    assert (tl == 0).any() and (tl < 0).any() and (tl == 3.0e38).any()
    assert {-1, cs_set.num_supers // 2, cs_set.num_supers - 1} <= set(cur.tolist())


def test_wrapper_takes_the_twin_on_the_cpu_and_raises_elsewhere(meshes):
    cs_set = meshes["mesh2k"]
    args = _inputs(cs_set, "edge", "mixed", seed=2)
    launches = launch_counts()
    got = w2._p1_extract(cs_set, *args, 16)
    want = w2.p1_extract_reference(cs_set, *args, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts() == launches
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    fake = SimpleNamespace(num_supers=40, super_box=meta(40, 6))
    with pytest.raises(ValueError, match="unsupported device"):
        w2._p1_extract(fake, *(meta(8) for _ in range(7)), meta(8, dt=torch.int32), 16)


def test_counters_of_a_small_wave2_render(monkeypatch):
    """Under tracing, ``wave2.box_tests`` is the sum of rows x Cs over the
    rounds of a render, and on the CPU no extraction kernel is launched."""
    scene, meta = random_mesh_scene(2000, seed=1, device="cpu")
    cam = make_camera(RigidTransform(), device="cpu")
    vp = Viewport(scene, meta, cam, ViewportParams(8, 8, seed=3), RenderParams(max_depth=2, mis=True), device="cpu")
    calls = []
    twin = w2.p1_extract_reference
    monkeypatch.setattr(w2, "p1_extract_reference",
                        lambda cs_set, ox, *a: calls.append(ox.shape[0] * cs_set.num_supers) or twin(cs_set, ox, *a))
    launches = launch_counts()
    profiler.reset()
    try:
        with profiler.enable():
            vp.render(1)
        counters = profiler.counters()
        rounds = sum(1 for r in profiler.records() if r.name == "wave2.round")
    finally:
        profiler.reset()
    assert rounds == len(calls) > 0
    assert counters["wave2.box_tests"] == sum(calls)
    assert counters.get("launches.wave2_extract", 0) == 0 and launch_counts() == launches
