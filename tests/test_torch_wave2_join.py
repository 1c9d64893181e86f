"""wave2's pair placement: the algorithm of ``csrc/wave2_join.cu`` against
its plain twins ``pair_join_reference`` and ``select_reference``, on the CPU.

The kernels run only on the card (``tools/torch_check_traverse.py::
check_join_kernels`` holds them against the twins there).  The functions
below write their arithmetic out as plain functions, one step a launch:

- ``join_keys``: each pair's key from its candidate and its ray (the super
  boxes' bounds reduced with NaN-propagating min and max, the origin
  quantized and Morton-interleaved, the octant), sentinels and pads up to
  p_pad;
- ``run_starts``: the first sorted position at or above each super's key, by
  binary search, for the Cs + 1 supers;
- ``padded_starts``: the exclusive scan of the padded run widths over the
  Cs + 1 supers, as the one-block launch cuts it: a segment a thread, an
  inclusive scan within each warp, the warps' totals scanned by the first;
- ``place``: each chunk's super by binary search in the padded starts, each
  slot a sorted pair (its ``fidx`` and its ray's 7 floats) or a filler, and
  the ``slot_of_pair`` scatter;
- ``select_through``: each ray's kc results read at ``slot_of_pair``, the
  least t, ties to the lowest tri, u and v the largest at that (t, tri); the
  cursor and the resolution in id order and front to back.

They must equal the twins element for element: ``sidx``, ``fidx``, all 7
pair planes (by their bits), ``block_cluster``, and all six outputs of the
select, on the meshes of ``test_torch_wave2.py`` and on hand-built
candidate sets: every slot real with no sentinel, every slot a sentinel, one
super, n * kc a multiple of CHUNK and not, a key shift below 3,
``RT_WAVE2_SPATIAL_KEY=0``, CHUNK 128, 256 and 1024, kc 1, 4 and 16, ftb on
and off, ``any_hit`` and any-hit lanes (tl < 0), and ties in t with equal
and unequal tri.

Also: the wrappers ``_pair_join`` and ``_select`` take the twins for CPU
tensors and raise on a device without the kernels, and on the CPU
``launches.wave2_join`` stays 0 under tracing.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.ops import wave2_traverse as w2
from raytracer_tpu_torch.ops.cuda_build import launch_counts
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.clusters import build_clusters
from raytracer_tpu_torch.scene.presets import random_mesh_scene
from raytracer_tpu_torch.utils import profiler

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from traversal_bench import coherent_rays, incoherent_rays, make_mesh  # noqa: E402

RUN_THREADS = 1024  # kRunThreads of csrc/wave2_join.cu
INF = float("inf")


# --------------------------------------------------------------------------
# The kernels' algorithm, written out
# --------------------------------------------------------------------------


def _binary_search(values, targets, hi, first_at_or_above=True):
    """All searches at once, one halving a step as each thread does it:
    the first index of ``values[:hi]`` >= each target, or (``False``) the
    last index in [0, hi] whose value is <= each target."""
    m = targets.shape[0]
    lo = torch.zeros(m, dtype=torch.int64)
    up = torch.full((m,), hi, dtype=torch.int64)
    while bool((lo < up).any()):
        live = lo < up
        if first_at_or_above:
            mid = (lo + up) >> 1
            below = values[torch.clamp(mid, 0, values.shape[0] - 1)] < targets
            lo = torch.where(live & below, mid + 1, lo)
            up = torch.where(live & ~below, mid, up)
        else:
            mid = (lo + up + 1) >> 1
            at_or_below = values[mid] <= targets
            lo = torch.where(live & at_or_below, mid, lo)
            up = torch.where(live & ~at_or_below, mid - 1, up)
    return lo


def join_keys(box, cand, ox, oy, oz, dx, dy, dz, key_shift, p_pad):
    """The key launch: (p_pad,) int32 keys."""
    n, kc = cand.shape
    cs = box.shape[0]
    p = n * kc
    mbits = max(0, key_shift - 3)
    bpa = mbits // 3
    key = torch.full((p_pad,), cs << key_shift, dtype=torch.int32)
    c = cand.reshape(-1).to(torch.int64)
    real = c < cs
    okey = torch.zeros(p, dtype=torch.int64)
    if key_shift >= 3:
        r = torch.arange(p) // kc
        morton = torch.zeros(p, dtype=torch.int64)
        if bpa > 0:
            valid = box[:, 0] <= box[:, 3]
            # NaN-propagating min / max in any order: one value
            lo = [torch.where(valid, box[:, q], INF).amin() for q in range(3)]
            hi = [torch.where(valid, box[:, 3 + q], -INF).amax() for q in range(3)]
            top = torch.tensor(float(2 ** bpa - 1), dtype=torch.float32)
            tiny = torch.tensor(1e-9, dtype=torch.float32)
            rng = [torch.maximum(hi[q] - lo[q], tiny) for q in range(3)]

            def quantize(x, q):  # fminf(fmaxf(v, 0), top), then truncation
                v = (x[r] - lo[q]) / rng[q] * top
                return torch.fmin(torch.fmax(v, torch.zeros(())), top).to(torch.int64)

            qx, qy, qz = quantize(ox, 0), quantize(oy, 1), quantize(oz, 2)
            for b in range(bpa):
                morton |= (((qx >> b) & 1) << (3 * b)) | (((qy >> b) & 1) << (3 * b + 1)) \
                    | (((qz >> b) & 1) << (3 * b + 2))
        octant = (dx[r] < 0.0).long() | ((dy[r] < 0.0).long() << 1) | ((dz[r] < 0.0).long() << 2)
        okey = (octant << mbits) | morton
    key[:p] = torch.where(real, (c << key_shift) | okey, cs << key_shift).to(torch.int32)
    return key


def run_starts(sk, cs, key_shift):
    """The runs launch, first half: start (Cs + 1,)."""
    targets = torch.arange(cs + 1, dtype=torch.int64) << key_shift
    return _binary_search(sk.to(torch.int64), targets, sk.shape[0]).to(torch.int32)


def padded_starts(start, cs, chunk):
    """The runs launch, second half: dstart (Cs + 1,), cut as the block cuts it."""
    m = cs + 1
    st = start.to(torch.int64)
    length = st[1:] - st[:-1]
    width = length + (chunk - length % chunk) % chunk  # len + (-len mod CHUNK), (Cs,)
    per = -(-m // RUN_THREADS)
    tid = torch.arange(RUN_THREADS)
    a = torch.clamp(tid * per, max=m)
    e = torch.clamp(a + per, max=m)
    csum = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(width, 0)])  # the serial sums of a segment
    seg = csum[torch.clamp(e, max=cs)] - csum[torch.clamp(a, max=cs)]
    lane, warp = tid & 31, tid >> 5
    incl = seg.clone()
    for o in (1, 2, 4, 8, 16):  # __shfl_up_sync within each warp
        up = torch.roll(incl, o)
        incl = torch.where(lane >= o, incl + up, incl)
    totals = incl[lane == 31]  # one a warp
    wsum = torch.cumsum(totals, 0) - totals  # the first warp's exclusive scan
    base = wsum[warp] + incl - seg
    dstart = torch.empty(m, dtype=torch.int64)
    for t in range(RUN_THREADS):
        run = int(base[t])
        for s in range(int(a[t]), int(e[t])):
            dstart[s] = run
            if s < cs:
                run += int(width[s])
    return dstart.to(torch.int32)


def place(perm, start, dstart, rays, kc, p, p_pad, cs, chunk, b2):
    """The place launch: (sidx, fidx, 7 pair planes (b2, chunk // 128, 128),
    block_cluster, slot_of_pair)."""
    d_len = b2 * chunk
    bc = _binary_search(dstart.to(torch.int64), torch.arange(b2, dtype=torch.int64) * chunk, cs,
                        first_at_or_above=False)
    st = start.to(torch.int64)
    e = dstart.to(torch.int64)[bc]
    first = st[bc]
    length = torch.where(bc < cs, st[torch.clamp(bc + 1, max=cs)], p_pad) - first
    d = torch.arange(d_len)
    b = d // chunk
    off = d - e[b]
    sorted_pair = off < length[b]
    j = torch.where(sorted_pair, first[b] + off, 0)
    i = torch.where(sorted_pair, perm[j], p_pad)  # perm is int64, as the sort gives it
    fi = torch.where(sorted_pair, torch.where(i < p, i, p), p_pad)
    sidx = torch.full((p_pad,), -7, dtype=torch.int64)  # a position never written stays -7
    sidx[j[sorted_pair]] = fi[sorted_pair]
    real = sorted_pair & (i < p)
    slot_of_pair = torch.full((p,), -7, dtype=torch.int64)
    slot_of_pair[i[real]] = d[real]
    r = torch.where(real, fi // kc, 0)
    fill = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)
    planes = tuple(torch.where(real, a[r], f).reshape(b2, chunk // 128, 128) for a, f in zip(rays, fill))
    i32 = lambda x: x.to(torch.int32)
    return i32(sidx), i32(fi), planes, i32(bc), i32(slot_of_pair)


def kernel_join(cs_set, cand, *rays, chunk=None, key_shift=None):
    """The four steps in order around the one stable sort."""
    chunk = chunk or w2.CHUNK
    n, kc = cand.shape
    cs = cs_set.num_supers
    p = n * kc
    p_pad = -(-p // chunk) * chunk
    b2 = (p_pad + -(-(cs * (chunk - 1)) // chunk) * chunk) // chunk
    key_shift = w2._spatial_key_shift(cs) if key_shift is None else key_shift
    key = join_keys(cs_set.super_box, cand, *rays[:6], key_shift, p_pad)
    sk, perm = torch.sort(key, stable=True)
    start = run_starts(sk, cs, key_shift)
    dstart = padded_starts(start, cs, chunk)
    return key, start, place(perm, start, dstart, rays, kc, p, p_pad, cs, chunk, b2)


def select_through(cs, cand, slot_of_pair, outs, tl, cursor, any_hit, ftb, remaining=None, next_t=None,
                   new_key=None):
    """The select launch: one ray a row, its kc slots in order."""
    n, kc = cand.shape
    t, tri, u, v, done = (o.reshape(-1) for o in outs)
    bt = torch.full((n,), INF)
    bu = torch.full((n,), -INF)
    bv = torch.full((n,), -INF)
    btri = torch.full((n,), 2 ** 31 - 1, dtype=torch.int32)
    any_unproc = torch.zeros(n, dtype=torch.bool)
    min_unproc = torch.full((n,), cs + 1, dtype=torch.int32)
    max_extracted = torch.full((n,), -1, dtype=torch.int32)
    for j in range(kc):
        c = cand[:, j]
        valid = c < cs
        max_extracted = torch.where(valid, torch.maximum(max_extracted, c), max_extracted)
        d = torch.where(valid, slot_of_pair.reshape(n, kc)[:, j], 0).long()
        unproc = valid & (done[d] == 0)
        any_unproc |= unproc
        min_unproc = torch.where(unproc, torch.minimum(min_unproc, c), min_unproc)
        hit = valid & ~unproc & (tri[d] >= 0)
        th, h = t[d], tri[d]
        better = hit & ((th < bt) | ((th == bt) & (h < btri)))
        same = hit & ~better & (th == bt) & (h == btri)
        bt, btri = torch.where(better, th, bt), torch.where(better, h, btri)
        bu = torch.where(better, u[d], torch.where(same, torch.maximum(bu, u[d]), bu))
        bv = torch.where(better, v[d], torch.where(same, torch.maximum(bv, v[d]), bv))
    got = torch.isfinite(bt)
    best_tri = torch.where(got, btri, -1)
    t_round = torch.where(got, bt, torch.abs(tl))
    if ftb:
        cur = torch.where(any_unproc, cursor, new_key)
        unres = any_unproc | (next_t < t_round)
    else:
        cur = torch.where(any_unproc, min_unproc - 1, torch.maximum(max_extracted, cursor))
        unres = any_unproc | (remaining > 0)
    if any_hit:
        unres &= best_tri < 0
    unres &= ~((tl < 0.0) & (best_tri >= 0))
    return (t_round, best_tri, torch.where(got, bu, 0.0), torch.where(got, bv, 0.0), cur, unres)


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------


def _mesh(n_tris, seed, k=8):
    return build_clusters(*make_mesh(n_tris, np.random.default_rng(seed)), k=k, device="cpu")


@pytest.fixture(scope="module")
def meshes():
    """The 2k-triangle mesh of test_torch_wave2.py (seed 7), a 20k-triangle
    one and one of a single super."""
    got = {"mesh2k": _mesh(2000, 7), "mesh20k": _mesh(20_000, 5), "one_super": _mesh(60, 3)}
    assert got["one_super"].num_supers == 1 and got["mesh2k"].num_supers > 16
    return got


def _rays(n, seed):
    """test_torch_wave2.py's rays: coherent and incoherent halves, limits
    mixed closest / any-hit (tl < 0) / zero."""
    rng = np.random.default_rng(seed)
    oc, dc = coherent_rays(n // 2, rng)
    oi, di = incoherent_rays(n - n // 2, rng)
    t = lambda a, b: torch.as_tensor(np.concatenate([np.asarray(a), np.asarray(b)]).astype(np.float32))
    u = rng.random(n)
    tl = np.where(u < 0.3, -rng.uniform(1.0, 20.0, n), 3.0e38).astype(np.float32)
    tl[u > 0.95] = 0.0
    return [t(oc[i], oi[i]) for i in range(3)] + [t(dc[i], di[i]) for i in range(3)] + [torch.as_tensor(tl)]


def _cand(cs_set, rays, kc, kind, seed):
    """(n, kc) candidates: the extraction's on these rays, or hand-built."""
    n, cs = rays[0].shape[0], cs_set.num_supers
    g = torch.Generator().manual_seed(seed)
    if kind == "extracted":
        return w2.p1_extract_reference(cs_set, *rays, torch.full((n,), -1, dtype=torch.int32), kc)[0]
    if kind == "all_real":
        return torch.randint(0, cs, (n, kc), generator=g, dtype=torch.int32)
    if kind == "all_sentinel":
        return torch.full((n, kc), cs, dtype=torch.int32)
    if kind == "mixed":  # a third sentinels, the rest random supers, sorted as the extraction gives them
        c = torch.randint(0, cs, (n, kc), generator=g, dtype=torch.int32)
        c = torch.where(torch.rand((n, kc), generator=g) < 0.33, cs, c)
        return torch.sort(c, 1).values
    raise ValueError(kind)


def _same_join(got, want):
    sidx, fidx, planes, bc, slot_of_pair = got
    assert torch.equal(sidx, want.sidx)
    assert torch.equal(fidx, want.fidx)
    assert torch.equal(bc, want.block_cluster)
    for a, b in zip(planes, want.pairs):
        assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
    p = slot_of_pair.shape[0]
    assert torch.equal(want.fidx[slot_of_pair.long()], torch.arange(p, dtype=torch.int32))  # the twin's inverse


def _check_join(cs_set, cand, rays, chunk):
    want = w2.pair_join_reference(cs_set, cand, *rays)
    key, start, got = kernel_join(cs_set, cand, *rays, chunk=chunk)
    _same_join(got, want)
    assert int(start[-1]) == int((cand < cs_set.num_supers).sum())  # wave2.pair_slots_real
    return want, got


# --------------------------------------------------------------------------
# The join
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [128, 256, 1024])
@pytest.mark.parametrize("kc", [1, 4, 16])
@pytest.mark.parametrize("mesh,n_rays,kind", [
    ("mesh2k", 2048, "extracted"),  # n * kc a multiple of CHUNK, sentinels among the pairs
    ("mesh2k", 1000, "extracted"),  # n * kc not a multiple of CHUNK: pads
    ("mesh20k", 1000, "mixed"),
    ("mesh2k", 1024, "all_real"),  # every slot real, no sentinel, no pad
    ("mesh2k", 1000, "all_sentinel"),
    ("one_super", 700, "extracted"),
])
def test_placement_equals_the_twin(meshes, monkeypatch, mesh, n_rays, kind, kc, chunk):
    monkeypatch.setattr(w2, "CHUNK", chunk)
    monkeypatch.setattr(w2, "ROWS", chunk // 128)
    cs_set = meshes[mesh]
    kc = min(kc, cs_set.num_supers)
    rays = _rays(n_rays, seed=kc)
    cand = _cand(cs_set, rays, kc, kind, seed=chunk + kc)
    want, _ = _check_join(cs_set, cand, rays, chunk)
    p = n_rays * kc
    if kind == "all_real":  # no sentinel run, no pad: the last run is a real super's
        assert int((want.fidx < p).sum()) == p and (want.block_cluster < cs_set.num_supers).any()
    if kind == "all_sentinel":
        assert (want.block_cluster == cs_set.num_supers).all()


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_placement_with_a_key_shift_below_3(meshes, monkeypatch, shift):
    """A shift below 3 leaves no room for the octant and Morton bits: the key
    is the super id, shifted."""
    monkeypatch.setattr(w2, "_key_shift", lambda cs: shift)
    cs_set = meshes["mesh2k"]
    rays = _rays(1500, seed=shift)
    cand = _cand(cs_set, rays, 16, "extracted", seed=0)
    key, _, _ = kernel_join(cs_set, cand, *rays)
    c = cand.reshape(-1)
    assert torch.equal(key[:c.shape[0]], torch.where(c < cs_set.num_supers, c << shift, cs_set.num_supers << shift))
    _check_join(cs_set, cand, rays, w2.CHUNK)


def test_placement_under_spatial_key_0(meshes, monkeypatch):
    monkeypatch.setenv("RT_WAVE2_SPATIAL_KEY", "0")
    cs_set = meshes["mesh20k"]
    rays = _rays(1500, seed=3)
    cand = _cand(cs_set, rays, 16, "extracted", seed=0)
    key, _, _ = kernel_join(cs_set, cand, *rays)
    assert torch.equal(key[:cand.numel()], cand.reshape(-1))  # the super id alone
    _check_join(cs_set, cand, rays, w2.CHUNK)


def test_keys_quantize_the_origin_as_the_twin(meshes):
    """Origins on the bounds, outside them, at -0.0 and at the far corner:
    the Morton part of the key is the twin's, whose sort order it sets."""
    cs_set = meshes["mesh2k"]
    box = cs_set.super_box
    lo, hi = box[:, :3].amin(0), box[:, 3:].amax(0)
    corners = torch.stack([lo, hi, lo - 1.0, hi + 1.0, (lo + hi) / 2, torch.full((3,), -0.0), lo + 1e-7])
    o = corners.repeat(64, 1)
    o = o + torch.randn(o.shape, generator=torch.Generator().manual_seed(1)) * (torch.arange(o.shape[0]) % 2)[:, None]
    d = torch.randn(o.shape, generator=torch.Generator().manual_seed(2))
    d[::3, 0] = -0.0
    n = o.shape[0]
    rays = [o[:, 0].contiguous(), o[:, 1].contiguous(), o[:, 2].contiguous(),
            d[:, 0].contiguous(), d[:, 1].contiguous(), d[:, 2].contiguous(), torch.full((n,), 3.0e38)]
    cand = _cand(cs_set, rays, 4, "all_real", seed=5)
    _check_join(cs_set, cand, rays, w2.CHUNK)


def test_padded_starts_across_segments():
    """A Cs above the block's 1,024 threads: each thread scans a segment of
    several supers, empty runs among them."""
    cs = 5000
    g = torch.Generator().manual_seed(4)
    lengths = torch.where(torch.rand(cs + 1, generator=g) < 0.4, 0, torch.randint(1, 3000, (cs + 1,), generator=g))
    start = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(lengths, 0)[:-1]]).to(torch.int32)
    for chunk in (128, 1024):
        width = lengths[:cs] + (-lengths[:cs]) % chunk
        want = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(width, 0)]).to(torch.int32)
        assert torch.equal(padded_starts(start, cs, chunk), want)


# --------------------------------------------------------------------------
# The select
# --------------------------------------------------------------------------


def _ftb_inputs(cs_set, rays, kc):
    n = rays[0].shape[0]
    return w2._p1_extract_ftb(cs_set, *rays, torch.full((n,), -1, dtype=torch.int32), kc)


def _tied_outs(join, seed):
    """Chunk results with many ties: t in {0.5, 1, 2}, tri in {3, 4, 5, -1},
    u and v distinct, done 0 on some slots."""
    g = torch.Generator().manual_seed(seed)
    shape = join.pairs[0].shape
    t = torch.tensor([0.5, 1.0, 2.0])[torch.randint(0, 3, shape, generator=g)]
    tri = torch.tensor([3, 4, 5, -1], dtype=torch.int32)[torch.randint(0, 4, shape, generator=g)]
    u, v = torch.rand(shape, generator=g), torch.rand(shape, generator=g)
    done = (torch.rand(shape, generator=g) < 0.9).to(torch.int32)
    return t, tri, u, v, done


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("ftb", [False, True])
@pytest.mark.parametrize("kc", [1, 4, 16])
@pytest.mark.parametrize("outs_kind", ["mt", "tied"])
def test_select_through_the_slot_map_equals_the_twin(meshes, kc, ftb, any_hit, outs_kind):
    cs_set = meshes["mesh2k"]
    n = 1000
    rays = _rays(n, seed=kc + 10 * ftb)
    tl = rays[6]
    if ftb:
        cand, next_t, new_key = _ftb_inputs(cs_set, rays, kc)
        cursor, more = torch.full((n,), -1, dtype=torch.int32), dict(next_t=next_t, new_key=new_key)
    else:
        g = torch.Generator().manual_seed(kc)
        cursor = torch.randint(-1, 4, (n,), generator=g, dtype=torch.int32)
        cand, remaining = w2.p1_extract_reference(cs_set, *rays, cursor, kc)
        more = dict(remaining=remaining)
    join = w2.pair_join_reference(cs_set, cand, *rays)
    _, _, (_, _, _, _, slot_of_pair) = kernel_join(cs_set, cand, *rays)
    if outs_kind == "mt":
        outs = w2.mt_chunks_reference(join.block_cluster, cs_set.super_geom, cs_set.super_sbox, *join.pairs, any_hit)
    else:
        outs = _tied_outs(join, seed=kc)
    want = w2.select_reference(cs_set.num_supers, cand, join, outs, tl, cursor, any_hit, ftb, **more)
    got = select_through(cs_set.num_supers, cand, slot_of_pair, outs, tl, cursor, any_hit, ftb, **more)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    best_tri, unres = want[1], want[5]
    assert (best_tri >= 0).any() and (best_tri < 0).any()
    if not any_hit:
        assert ((tl < 0) & (best_tri >= 0)).any()  # any-hit lanes that hit
        assert unres.any()


def test_select_ties_in_t(meshes):
    """Two slots of a ray at the same t: the lower tri wins; at the same t
    and tri, u and v are the larger ones."""
    cs_set = meshes["mesh2k"]
    n, kc = 4, 3
    rays = _rays(n, seed=1)
    tl = torch.full((n,), 3.0e38)
    cand = torch.tensor([[0, 1, 2]] * n, dtype=torch.int32)
    join = w2.pair_join_reference(cs_set, cand, *rays)
    _, _, (_, _, _, _, slot_of_pair) = kernel_join(cs_set, cand, *rays)
    per_pair = dict(
        t=[[1.0, 1.0, 2.0], [1.0, 1.0, 0.5], [3.0, 1.0, 1.0], [2.0, 2.0, 2.0]],
        tri=[[7, 5, 1], [5, 5, 9], [1, 6, 6], [4, 4, 3]],
        u=[[0.1, 0.2, 0.3], [0.4, 0.1, 0.0], [0.9, 0.2, 0.6], [0.3, 0.8, 0.1]],
        v=[[0.0, 0.5, 0.2], [0.1, 0.7, 0.3], [0.0, 0.4, 0.1], [0.6, 0.2, 0.9]],
    )
    d_len = join.fidx.shape[0]
    outs = []
    for name, dtype in (("t", torch.float32), ("tri", torch.int32), ("u", torch.float32), ("v", torch.float32)):
        a = torch.zeros(d_len, dtype=dtype)
        a[slot_of_pair.long()] = torch.tensor(per_pair[name], dtype=dtype).reshape(-1)
        outs.append(a)
    outs.append(torch.ones(d_len, dtype=torch.int32))
    cursor = torch.full((n,), -1, dtype=torch.int32)
    remaining = torch.zeros(n, dtype=torch.int32)
    want = w2.select_reference(cs_set.num_supers, cand, join, outs, tl, cursor, False, False, remaining)
    got = select_through(cs_set.num_supers, cand, slot_of_pair, outs, tl, cursor, False, False, remaining)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert want[1].tolist() == [5, 9, 6, 3]
    assert want[0].tolist() == [1.0, 0.5, 1.0, 2.0]
    assert torch.equal(want[2], torch.tensor([0.2, 0.0, 0.6, 0.1]))
    assert torch.equal(want[3], torch.tensor([0.5, 0.3, 0.4, 0.9]))


# --------------------------------------------------------------------------
# The wrappers
# --------------------------------------------------------------------------


def test_wrappers_take_the_twins_on_the_cpu_and_raise_elsewhere(meshes):
    cs_set = meshes["mesh2k"]
    n, kc = 500, 4
    rays = _rays(n, seed=9)
    cand = _cand(cs_set, rays, kc, "extracted", seed=0)
    launches = launch_counts()
    got, want = w2._pair_join(cs_set, cand, *rays), w2.pair_join_reference(cs_set, cand, *rays)
    assert got.slot_of_pair is None and torch.equal(got.fidx, want.fidx) and torch.equal(got.sidx, want.sidx)
    outs = w2.mt_chunks_reference(got.block_cluster, cs_set.super_geom, cs_set.super_sbox, *got.pairs, False)
    cursor = torch.full((n,), -1, dtype=torch.int32)
    rem = torch.zeros(n, dtype=torch.int32)
    a = w2._select(cs_set.num_supers, cand, got, outs, rays[6], cursor, False, False, rem)
    b = w2.select_reference(cs_set.num_supers, cand, want, outs, rays[6], cursor, False, False, rem)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert launch_counts() == launches

    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    fake = SimpleNamespace(num_supers=40, super_box=meta(40, 6))
    with pytest.raises(ValueError, match="unsupported device"):
        w2._pair_join(fake, meta(8, 4, dt=torch.int32), *(meta(8) for _ in range(7)))
    with pytest.raises(ValueError, match="unsupported device"):
        w2._select(40, meta(8, 4, dt=torch.int32), got, outs, meta(8), meta(8, dt=torch.int32), False, False,
                   meta(8, dt=torch.int32))


def test_no_join_launch_on_the_cpu_under_tracing():
    """A small render under tracing: the join runs every round, on the twin,
    and ``launches.wave2_join`` stays 0; the pair-slot counters still count."""
    scene, meta = random_mesh_scene(2000, seed=1, device="cpu")
    cam = make_camera(RigidTransform(), device="cpu")
    vp = Viewport(scene, meta, cam, ViewportParams(8, 8, seed=3), RenderParams(max_depth=2, mis=True), device="cpu")
    launches = launch_counts()
    profiler.reset()
    try:
        with profiler.enable():
            vp.render(1)
        counters = profiler.counters()
        joins = sum(1 for r in profiler.records() if r.name == "wave2.join")
    finally:
        profiler.reset()
    assert joins > 0 and counters["wave2.pair_slots_sent"] > counters["wave2.pair_slots_real"] > 0
    assert counters.get("launches.wave2_join", 0) == 0 and launch_counts() == launches
