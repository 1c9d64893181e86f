"""Ties and edge cases of the two phase-2 kernels of the block-candidate
traversal, on hand-built candidate tables
(``tools/torch_check_traverse.py::phase2_tie_case``): equal t in two slots of
one cluster and in two candidates, pad slots and pad rays, any-hit lanes whose
first hit is not in slot 0, a block whose loop ends at j = 0, a block of +inf
entries, kb = 1, one block and odd block counts, K from 8 to 128.

1. The JAX ``_phase2_kernel`` and ``_phase2_stream_kernel`` (through
   ``pl.pallas_call`` in interpret mode, with the grid specs of their
   launchers) and the port's plain versions on the same tables: tri ids
   equal, t within rtol 1e-5 + atol 1e-6, u and v within atol 1e-4.  Not bit for bit:
   XLA:CPU contracts a multiply and its add into one fused operation, PyTorch
   rounds both, and the three dot products cancel (as
   ``tests/test_torch_mt_ties.py`` and ``tests/test_torch_pallas_traverse.py``
   state; 5e-6 of t at t = 0.27 and 2e-8 at t = 0.001 do occur on these tables).  Copies of one triangle give equal t on either side, so the ties
   are exact in both and the ids must agree.  In any-hit mode t is 0 or the
   ray's limit and u = v = 0: equal bit for bit.
2. The control flow of ``csrc/phase2_grid.cu`` (the max of t exchanged only
   after a live step, the next live step found by a ballot over staged
   entries, the next candidate fetched under the old max and dropped when the
   new max kills it) and of ``csrc/phase2_stream.cu`` (the box test made
   before the entry test so that one exchange carries both, tiles asked for
   ahead and waited for before the exit), written out as plain PyTorch per
   ray block with the plain versions' arithmetic: identical (t, tri, u, v) to
   the plain versions, which walk all blocks at once, and every tile that was
   asked for is waited for exactly once.
3. The kernels' fold of one candidate where two (or four) lanes share a ray:
   each lane folds its run of whole groups of four slots in order from the
   step's starting state, and the lanes merge to the least t and, among equal
   t, the lower lane.  Written with the plain version's ``_mt_candidate`` on
   the runs: identical to ``_mt_candidate`` on all K slots, also where a
   copied triangle puts its equal t into two runs.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.ops import pallas_traverse as ref_pt
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import pallas_traverse as pt
from raytracer_tpu_torch.ops.cluster_traverse import slab_inv, slab_test
from raytracer_tpu_torch.scene.clusters import build_clusters

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from torch_check_traverse import PHASE2_TIE_CASES, phase2_case_tensors, phase2_tie_case  # noqa: E402
from traversal_bench import coherent_rays, incoherent_rays, make_mesh  # noqa: E402

CASES = dict(PHASE2_TIE_CASES)
INF = float("inf")


@functools.lru_cache(maxsize=None)
def _case(label):
    case = phase2_tie_case(**CASES[label])
    return case, phase2_case_tensors(case, "cpu")


def _jax_grid_kernel(cand, entry, tri_block, tri_id, rays):
    """The TPU grid kernel on the CPU: a (B, kb) grid in interpret mode, as
    ``_pallas_closest_hit_padded`` lays it out."""
    b, kb = cand.shape
    k = tri_id.shape[1]
    ray_spec = pl.BlockSpec((1, 8, 128), lambda bi, j, cand, entry: (bi, 0, 0), memory_space=pltpu.VMEM)
    pick = lambda bi, j, cand, entry: (cand[bi, j], 0, 0)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(b, kb),
        in_specs=[pl.BlockSpec((1, 1, k * 9), pick, memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 1, k), pick, memory_space=pltpu.VMEM)] + [ray_spec] * 7,
        out_specs=[ray_spec] * 4,
    )
    f32s = jax.ShapeDtypeStruct((b, 8, 128), jnp.float32)
    i32s = jax.ShapeDtypeStruct((b, 8, 128), jnp.int32)
    outs = pl.pallas_call(functools.partial(ref_pt._phase2_kernel, k=k), grid_spec=grid_spec,
                          out_shape=[f32s, i32s, f32s, f32s], interpret=True)(
        jnp.asarray(cand), jnp.asarray(entry), jnp.asarray(tri_block)[:, None, :], jnp.asarray(tri_id)[:, None, :],
        *map(jnp.asarray, rays))
    return [np.asarray(x) for x in outs]


def _jax_stream_kernel(cand, entry, stream_block, rays, k, any_hit):
    """The TPU stream kernel on the CPU: one grid step per ray block in
    interpret mode, as ``_pallas_stream_trace`` lays it out."""
    b, kb = cand.shape
    ray_spec = pl.BlockSpec((1, 8, 128), lambda bi, cand, entry: (bi, 0, 0), memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)] + [ray_spec] * 7,
        out_specs=[ray_spec] * 4,
        scratch_shapes=[pltpu.SMEM((2,) + tuple(stream_block.shape[1:]), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
    )
    f32s = jax.ShapeDtypeStruct((b, 8, 128), jnp.float32)
    i32s = jax.ShapeDtypeStruct((b, 8, 128), jnp.int32)
    outs = pl.pallas_call(functools.partial(ref_pt._phase2_stream_kernel, k=k, kb=kb, any_hit=any_hit),
                          grid_spec=grid_spec, out_shape=[f32s, i32s, f32s, f32s], interpret=True)(
        jnp.asarray(cand), jnp.asarray(entry), jnp.asarray(stream_block), *map(jnp.asarray, rays))
    return [np.asarray(x) for x in outs]


def _assert_close(got, ref, exact):
    for name, a, b in zip(("t", "tri", "u", "v"), (x.numpy() for x in got), ref):
        assert a.dtype == b.dtype, name
        if exact or name == "tri":
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 if name == "t" else 1e-4, err_msg=name)


# The JAX kernels unroll K slots and walk B x kb grid steps in interpret mode: the small tables.
# The stream kernel's 128 unrolled slots inside its while loop take minutes to compile on the CPU,
# so its K = 128 table is held by the control-flow checks below and on the card only.
JAX_LABELS = ["ties K=8 B=3 kb=6", "ties K=16 B=5 kb=12", "ties K=8 B=1 kb=1"]


@pytest.mark.parametrize("label", JAX_LABELS + ["ties K=128 B=2 kb=4"])
def test_jax_grid_kernel_and_plain_version_agree_on_ties(label):
    case, (cand, entry, tri_block, tri_id, _, rays) = _case(label)
    ref = _jax_grid_kernel(case["cand"], case["entry"], case["tri_block"], case["tri_id"], case["rays"])
    got = pt.phase2_grid_reference(cand, entry, tri_block, tri_id, *rays)
    assert (got[1] >= 0).sum() > 300 * cand.shape[0]  # the rays really hit
    _assert_close(got, ref, exact=False)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any-hit"])
@pytest.mark.parametrize("label", JAX_LABELS)
def test_jax_stream_kernel_and_plain_version_agree_on_ties(label, any_hit):
    case, (cand, entry, _, _, stream_block, rays) = _case(label)
    k = CASES[label]["k"]
    ref = _jax_stream_kernel(case["cand"], case["entry"], stream_block.numpy(), case["rays"], k, any_hit)
    got = pt.phase2_stream_reference(cand, entry, stream_block, *rays, k, any_hit)
    assert (got[1] >= 0).sum() > 100 * cand.shape[0]
    _assert_close(got, ref, exact=any_hit)


def test_tie_case_has_its_special_blocks_and_slots():
    case, (cand, entry, tri_block, tri_id, stream_block, rays) = _case("ties K=16 B=5 kb=12")
    k = 16
    geom = case["tri_block"].reshape(-1, k, 9)
    assert np.array_equal(geom[:, 1], geom[:, 5])  # equal t in two slots of one cluster
    assert np.array_equal(geom[np.arange(1, 9) % 8, 3], geom[:, 2])  # and in two candidates
    assert np.array_equal(case["cand"][:, 1], (case["cand"][:, 0] + 1) % 8)
    assert (case["tri_id"][:, -1] == -1).all() and np.abs(geom[:, -1]).sum() > 0  # pad slots keep a triangle
    ids = case["tri_id"][case["tri_id"] >= 0]
    assert np.unique(ids).size == ids.size  # copies carry ids of their own
    tm = case["rays"][6]
    assert (tm[:, 7, 64:] == 0).all() and 0 < (tm[:, :7] == 0).sum() < 0.1 * tm[:, :7].size  # pad rays
    assert np.isinf(case["entry"][0, 9]) and np.isinf(case["entry"][-2]).all() and case["entry"][-1, 0] == 1e30
    assert case["cand"].min() >= 0 and case["cand"].max() < 8  # valid ids in every slot, the +inf ones too

    stats, grid_stats = {}, {}
    t, tri, _, _ = pt.phase2_stream_reference(cand, entry, stream_block, *rays, k, False, stats=stats)
    pt.phase2_grid_reference(cand, entry, tri_block, tri_id, *rays, stats=grid_stats)
    steps = stats["block_steps"].tolist()
    assert steps[-1] == 0 and steps[-2] == 0 and 0 < steps[0] <= 9  # ends at j = 0; all +inf; ends at the +inf slot
    assert grid_stats["block_visits"][-1] > 0 and grid_stats["block_visits"][-2] == 0  # the grid loop skips j = 0 ...
    assert grid_stats["block_visits"][0] > steps[0]  # ... and goes on behind the +inf slot
    assert (tri[-1] == -1).all() and torch.equal(t[-1], rays[6][-1])
    # any-hit lanes whose first hit is not in slot 0, and hits on both members of a copied pair
    tri_any = pt.phase2_stream_reference(cand, entry, stream_block, *rays, k, True)[1]
    slot_of = {int(i): s for row in case["tri_id"] for s, i in enumerate(row) if i >= 0}
    slots = np.array([slot_of[int(i)] for i in tri_any[tri_any >= 0]])
    assert (slots != 0).sum() > 1000 and (slots == 1).sum() > 50
    assert not (slots == 5).any()  # slot 5 copies slot 1, which comes first
    pad_ids = tri[torch.as_tensor(tm == 0)]
    assert (pad_ids == -1).all()  # pad rays hit nothing


def test_giant_triangle_needs_the_ieee_division():
    """The case that sends the kernels' fast reciprocal back to the IEEE
    division: a determinant of -1e38 lies beyond 2^125, its reciprocal is a
    denormal, and the plain versions hit at t = 1 with it."""
    case, (cand, entry, tri_block, tri_id, stream_block, rays) = _case("giant triangle K=8 B=2 kb=3")
    want_id = int(case["tri_id"][case["cand"][0, 0], 0])
    for t, tri, u, v in (pt.phase2_grid_reference(cand, entry, tri_block, tri_id, *rays),
                         pt.phase2_stream_reference(cand, entry, stream_block, *rays, 8, False)):
        assert (tri[0, 0, :8] == want_id).all() and (t[0, 0, :8] == 1.0).all()
        np.testing.assert_allclose(u[0, 0, :8].numpy(), 0.3, rtol=1e-6)
        np.testing.assert_allclose(v[0, 0, :8].numpy(), 0.3, rtol=1e-6)
    inv_det = 1.0 / torch.tensor(-1e38)
    assert 0.0 < float(-inv_det) < float(torch.finfo(torch.float32).tiny)  # a denormal, not flushed to zero


# --------------------------------------------------------------------------
# the CUDA kernels' control flow as plain PyTorch, one ray block at a time
# --------------------------------------------------------------------------


def _staged(entry_row, base, n):
    """Entries [base, base + n) of a table row as the kernels stage them:
    +inf at and beyond kb."""
    out = torch.full((n,), INF)
    have = entry_row[base:base + n]
    out[:have.numel()] = have
    return out


def grid_skip_ahead(cand, entry, tri_block, tri_id, ox, oy, oz, dx, dy, dz, tm, chunk=256, lanes=32, stats=None):
    """``csrc/phase2_grid.cu`` per ray block: the max of t is taken once at
    the start and once after each live step; ``next_live`` scans ``lanes``
    staged entries at a time for the first below the max and moves the staged
    chunk forward; the next live step under the OLD max is fetched before this
    one is tested and dropped if the new max kills it."""
    k = tri_id.shape[1]
    kb = cand.shape[1]
    outs = []
    for b in range(cand.shape[0]):
        rays = tuple(a[b:b + 1] for a in (ox, oy, oz, dx, dy, dz))
        state = (tm[b:b + 1].clone(), torch.full_like(tm[b:b + 1], -1, dtype=torch.int32),
                 torch.zeros_like(tm[b:b + 1]), torch.zeros_like(tm[b:b + 1]))
        base = [0]
        staged = [_staged(entry[b], 0, chunk)]
        fetched, tested = [], []

        def next_live(frm, m):
            while frm < kb:
                if frm >= base[0] + chunk:
                    base[0] = frm
                    staged[0] = _staged(entry[b], frm, chunk)
                o = frm - base[0] + torch.arange(lanes)
                mine = torch.where(o < chunk, staged[0][torch.clamp_max(o, chunk - 1)], INF)
                live = (mine < m).nonzero()
                if live.numel():
                    first = int(live[0])
                    return frm + first, float(mine[first])
                frm = min(frm + lanes, base[0] + chunk)
            return kb, INF

        def fetch(j):
            if j < kb:
                assert base[0] <= j < base[0] + chunk  # its cluster id is read from the staged chunk
                fetched.append(j)

        m = state[0].amax()
        cur, _ = next_live(0, m)
        fetch(cur)
        while cur < kb:
            nxt, e_nxt = next_live(cur + 1, m)
            fetch(nxt)
            c = cand[b, cur].long()[None]
            state = pt._mt_candidate(tri_block[c].reshape(1, k, 9), tri_id[c], rays, *state, any_hit=False)
            tested.append(cur)
            m = state[0].amax()
            while nxt < kb and not e_nxt < m:
                nxt, e_nxt = next_live(nxt + 1, m)
                fetch(nxt)
            cur = nxt
        assert set(tested) <= set(fetched) and len(fetched) == len(set(fetched))
        if stats is not None:
            stats["dropped"] = stats.get("dropped", 0) + len(fetched) - len(tested)
            stats["tested"] = stats.get("tested", 0) + len(tested)
        outs.append(state)
    return tuple(torch.cat([o[i] for o in outs]) for i in range(4))


def stream_one_exchange(cand, entry, stream_block, ox, oy, oz, dx, dy, dz, tm, k, any_hit, chunk=256, ahead=2,
                        slots=4):
    """``csrc/phase2_stream.cu`` per ray block: an entry of +inf ends the
    loop before its tile is looked at; otherwise the step waits for its tile,
    makes the box test, takes max t and the OR of the box tests in one
    exchange, asks for the tile ``ahead`` steps on, and only then applies the
    entry test.  A ring of ``slots`` tiles; tiles in flight at the end are
    waited for."""
    tiles = stream_block.reshape(stream_block.shape[0], -1)
    kb = cand.shape[1]
    outs = []
    for b in range(cand.shape[0]):
        rays = tuple(a[b:b + 1] for a in (ox, oy, oz, dx, dy, dz))
        inv = tuple(slab_inv(a) for a in rays[3:])
        t, tri = tm[b:b + 1].clone(), torch.full_like(tm[b:b + 1], -1, dtype=torch.int32)
        u, v = torch.zeros_like(t), torch.zeros_like(t)
        base = 0
        staged = _staged(entry[b], 0, chunk + ahead)
        ring = [None] * slots  # the candidate step whose tile a slot holds or awaits
        asked_for, waited_for = [], []

        def fetch(jj, o):
            if staged[o] < INF:
                assert ring[jj % slots] is None  # the slot's last tile has been waited for
                ring[jj % slots] = jj
                asked_for.append(jj)

        def wait_tile(jj):
            assert ring[jj % slots] == jj
            waited_for.append(jj)

        for jj in range(ahead):
            fetch(jj, jj)
        waited, asked = 0, ahead
        for j in range(kb):
            if j - base == chunk:
                base = j
                staged = _staged(entry[b], base, chunk + ahead)
            o = j - base
            e = staged[o]
            if not e < INF:
                break
            wait_tile(j)
            waited = j + 1
            tile = tiles[cand[b, j].long()][None]
            box = tuple(tile[:, 10 * k + i, None, None] for i in range(6))
            bmin, bmax = slab_test(box, *rays[:3], *inv)
            any_box = bool(((bmax >= torch.clamp_min(bmin, 0.0)) & (bmin < t)).any())
            m = t.amax()
            if j >= 1:
                ring[(j - 1) % slots] = None  # the barrier: every thread is done with step j - 1's tile
            fetch(j + ahead, o + ahead)
            asked = j + ahead + 1
            if not e < m:
                break
            if not any_box:
                continue
            t, tri, u, v = pt._mt_candidate(tile[:, :9 * k].reshape(1, k, 9), tile[:, 9 * k:10 * k].to(torch.int32),
                                            rays, t, tri, u, v, any_hit)
        for jj in range(waited, asked):
            if staged[jj - base] < INF:
                wait_tile(jj)
        assert asked_for == waited_for  # every tile asked for was waited for, once, in order
        outs.append((t, tri, u, v))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(4))


@pytest.fixture(scope="module")
def mesh_tables():
    """BFS and dense candidate tables of a 2k-triangle mesh at k=8 for 1,024
    coherent and 1,024 incoherent rays (two ray blocks)."""
    rng = np.random.default_rng(5)
    cs = build_clusters(*make_mesh(2000, rng), k=8, device="cpu")
    oc, dc = coherent_rays(1024, rng)
    oi, di = incoherent_rays(1024, rng)
    cat = lambda a, b: torch.as_tensor(np.concatenate([np.asarray(a), np.asarray(b)]).astype(np.float32))
    o = Vec3(*(cat(oc[i], oi[i]) for i in range(3)))
    d = Vec3(*(cat(dc[i], di[i]) for i in range(3)))
    return cs, o, d


def _tables(mesh_tables, front, tm_value):
    cs, o, d = mesh_tables
    tm = torch.full((2048,), tm_value)
    rays = tuple(pt._rblk(a) for a in (*o, *d, tm))
    if front == "dense":
        cand, entry = pt._block_candidates(cs, o, d, tm, 48)
    else:
        cand, entry, _ = pt._block_candidates_bfs(cs, o, d, tm, 64)
    return cs, cand.contiguous(), entry.contiguous(), rays


@pytest.mark.parametrize("chunk,lanes", [(256, 32), (8, 4)], ids=["chunk256", "chunk8"])
@pytest.mark.parametrize("label", list(CASES) + ["mesh dense", "mesh bfs"])
def test_grid_skip_ahead_equals_the_plain_version(label, chunk, lanes, mesh_tables):
    if label.startswith("mesh"):
        cs, cand, entry, rays = _tables(mesh_tables, label.split()[1], 3.0e38)
        tri_block, tri_id = cs.tri_block, cs.tri_id
    else:
        _, (cand, entry, tri_block, tri_id, _, rays) = _case(label)
    stats, plain_stats = {}, {}
    got = grid_skip_ahead(cand, entry, tri_block, tri_id, *rays, chunk=chunk, lanes=lanes, stats=stats)
    want = pt.phase2_grid_reference(cand, entry, tri_block, tri_id, *rays, stats=plain_stats)
    assert stats["tested"] == plain_stats["visits"]  # exactly the live steps of the plain version
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    if label in ("ties K=16 B=5 kb=12", "ties K=64 B=7 kb=9"):
        assert stats["dropped"] > 0  # the new max did kill a step that had been fetched


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any-hit"])
@pytest.mark.parametrize("chunk,ahead,slots", [(256, 2, 4), (4, 3, 4), (3, 1, 2)], ids=["ring4", "chunk4", "ring2"])
@pytest.mark.parametrize("label", list(CASES) + ["mesh bfs"])
def test_stream_one_exchange_equals_the_plain_version(label, chunk, ahead, slots, any_hit, mesh_tables):
    if label.startswith("mesh"):
        cs, cand, entry, rays = _tables(mesh_tables, "bfs", 20.0 if any_hit else 3.0e38)
        stream_block, k = cs.stream_block, 8
    else:
        _, (cand, entry, _, _, stream_block, rays) = _case(label)
        k = CASES[label]["k"]
    got = stream_one_exchange(cand, entry, stream_block, *rays, k, any_hit, chunk=chunk, ahead=ahead, slots=slots)
    want = pt.phase2_stream_reference(cand, entry, stream_block, *rays, k, any_hit)
    assert int((want[1] >= 0).sum()) > 100
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name


# --------------------------------------------------------------------------
# the fold of one candidate split over the lanes that share a ray
# --------------------------------------------------------------------------


def split_fold(geom, tid, rays, t, tri, u, v, any_hit, split):
    """``csrc/mt_test.cuh::test_slots``: lane ``sub`` of a ray folds slots
    [sub * run, sub * run + run) with run = K / split rounded up to whole
    groups of four; then the butterfly merge, a lane taking its partner's
    state where that has the lesser t or, at equal t, is the lower lane."""
    k = geom.shape[1]
    run = -(-k // (4 * split)) * 4
    lanes = []
    for sub in range(split):
        lo = min(sub * run, k)
        hi = min(lo + run, k)
        lanes.append(pt._mt_candidate(geom[:, lo:hi], tid[:, lo:hi], rays, t, tri, u, v, any_hit) if hi > lo
                     else (t, tri, u, v))
    o = 1
    while o < split:
        merged = []
        for sub in range(split):
            mine, other = lanes[sub], lanes[sub ^ o]
            take = (other[0] < mine[0]) | ((other[0] == mine[0]) & bool(sub & o))
            merged.append(tuple(torch.where(take, b, a) for a, b in zip(mine, other)))
        lanes = merged
        o <<= 1
    for lane in lanes[1:]:  # every lane of the ray ends with the same state
        assert all(torch.equal(a, b) for a, b in zip(lane, lanes[0]))
    return lanes[0]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any-hit"])
@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("label", list(CASES))
def test_split_fold_equals_the_sequential_fold(label, split, any_hit):
    """Every candidate of every block, from the state the candidates before
    it left, so that parked lanes, earlier hits at the same t and pad rays
    all occur as starting states."""
    _, (cand, entry, tri_block, tri_id, _, rays7) = _case(label)
    k = tri_id.shape[1]
    rays, tm = tuple(rays7[:6]), rays7[6]
    state = (tm.clone(), torch.full_like(tm, -1, dtype=torch.int32), torch.zeros_like(tm), torch.zeros_like(tm))
    ties = 0
    for j in range(min(cand.shape[1], 12)):
        c = cand[:, j].long()
        geom, tid = tri_block[c].reshape(-1, k, 9), tri_id[c]
        want = pt._mt_candidate(geom, tid, rays, *state, any_hit)
        got = split_fold(geom, tid, rays, *state, any_hit, split)
        for name, a, b in zip(("t", "tri", "u", "v"), got, want):
            assert torch.equal(a, b), (name, j)
        ties += int(((want[1] != state[1]) & (want[1] >= 0)).sum())
        state = want
    assert ties > 100  # the fold did change the state
