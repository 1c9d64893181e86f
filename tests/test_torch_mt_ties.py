"""Ties in the wave2 Möller-Trumbore kernel: equal t from different tri ids,
in one triangle slot, across the slots of one sub and across subs.

1. The JAX ``_mt_kernel`` (through ``pl.pallas_call`` in interpret mode, as
   ``tools/probe_r5c.py::stage_pallas`` launches it) and the port's plain twin
   ``mt_chunks_reference`` on the same hand-built chunks
   (``tools/torch_check_traverse.py::tie_case``): tri and done equal; t
   within rtol 1e-6 + atol 1e-6, u and v within atol 1e-4.  Not bit for bit:
   XLA:CPU contracts a multiply and its add into one fused operation, PyTorch
   rounds both, and ``(tvec . p) * inv_det`` cancels at coordinates up to 20
   (the same bound as ``test_torch_wave2.py`` states for u and v).  Copies of
   one triangle still give equal t on either side, so the ties are exact in
   both and the ids must agree.  In any-hit mode t is 0 or |tl| and u = v = 0:
   equal bit for bit.
2. The running best that ``csrc/wave2_mt.cu`` keeps per pair, one state
   (t, tri, u, v, mask of the slots at t) instead of the TPU kernel's 8
   slots, written out below as a plain function that walks the triangles in
   the kernel's order with the twin's arithmetic: identical (t, tri, u, v) to
   the twin on the tie inputs, on other seeds and on chunks the engine joins
   from a mesh.
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

from raytracer_tpu.ops import wave2_traverse as ref_w2
from raytracer_tpu_torch.ops import wave2_traverse as w2
from raytracer_tpu_torch.ops.cluster_traverse import slab_inv
from raytracer_tpu_torch.scene.clusters import build_clusters

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from torch_check_traverse import tie_case  # noqa: E402
from traversal_bench import incoherent_rays, make_mesh  # noqa: E402


def _tensors(case):
    table, geom, sbox, pairs = case
    return [torch.as_tensor(x) for x in (table, geom, sbox, *pairs)]


def _jax_mt_kernel(case, any_hit):
    """The TPU kernel on the CPU: one grid step per chunk, interpret mode."""
    table, geom, sbox, pairs = case
    b2, (cs, rows8k, _) = table.shape[0], geom.shape
    k = rows8k // 8
    pick = lambda i, c: (jnp.clip(c[i], 0, cs - 1), 0, 0)
    pair_spec = pl.BlockSpec((1, 8, 128), lambda i, c: (i, 0, 0), memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(b2,),
        in_specs=[pl.BlockSpec((1, rows8k, 16), pick, memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 8, 8), pick, memory_space=pltpu.VMEM)] + [pair_spec] * 7,
        out_specs=[pair_spec] * 5,
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.float32)] * 4,
    )
    f32s = jax.ShapeDtypeStruct((b2, 8, 128), jnp.float32)
    i32s = jax.ShapeDtypeStruct((b2, 8, 128), jnp.int32)
    outs = pl.pallas_call(
        functools.partial(ref_w2._mt_kernel, k=k, cs=cs, any_hit=any_hit),
        grid_spec=grid_spec, out_shape=[f32s, i32s, f32s, f32s, i32s], interpret=True,
    )(jnp.asarray(table), jnp.asarray(geom), jnp.asarray(sbox), *map(jnp.asarray, pairs))
    return [np.asarray(x) for x in outs]


def _row_gates(sbox, ox, oy, oz, dx, dy, dz, tl):
    """(B2, R, 8 subs, 128) slab test of every pair against its chunk's sub
    boxes, as the twin spells it."""
    e = lambda a: a[:, :, None, :]
    sb = lambda q: sbox[:, None, :, q, None]
    ix, iy, iz = slab_inv(dx), slab_inv(dy), slab_inv(dz)
    t1x, t2x = (sb(0) - e(ox)) * e(ix), (sb(3) - e(ox)) * e(ix)
    t1y, t2y = (sb(1) - e(oy)) * e(iy), (sb(4) - e(oy)) * e(iy)
    t1z, t2z = (sb(2) - e(oz)) * e(iz), (sb(5) - e(oz)) * e(iz)
    bmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z))
    bmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z))
    tla = torch.abs(tl)
    return (bmax >= torch.clamp_min(bmin, 0.0)) & (bmin < e(tla)) & e(tla > 0.0)


def single_state_mt(block_cluster, super_geom, super_sbox, ox, oy, oz, dx, dy, dz, tl, any_hit, stats=None):
    """What ``csrc/wave2_mt.cu`` does per pair, all pairs at once: the
    triangles of the opened subs one after the other in row order, one
    running best (bt, btid, bu, bv) and the mask ``slots`` of the triangle
    slots (row & 7) that have reached bt.  Tri ids are unique among the rows
    that are not padding, as ``build_clusters`` makes them.  Returns
    (t, tri, u, v)."""
    cs, k = super_geom.shape[0], super_geom.shape[1] // 8
    live = (block_cluster < cs)[:, None, None]
    c = torch.clamp(block_cluster, 0, cs - 1).long()
    geom, sbox = super_geom[c], super_sbox[c]
    rah = (tl < 0.0) | any_hit
    rtl = torch.abs(tl)
    row_open = _row_gates(sbox, ox, oy, oz, dx, dy, dz, tl).any(-1) & live  # (B2, R, 8)
    bt, btid = rtl.clone(), torch.full_like(rtl, -1.0)
    bu, bv = torch.zeros_like(rtl), torch.zeros_like(rtl)
    slots = torch.zeros_like(rtl, dtype=torch.int32)
    joins = 0
    for row in range(8 * k):
        col = lambda q: geom[:, row, q, None, None]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, tid = (col(q) for q in range(10))
        bit = 1 << (row & 7)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        okd = torch.abs(det) > w2.TRI_EPS
        inv_det = 1.0 / torch.where(okd, det, 1.0)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        uu = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        inside = (row_open[:, :, row // k, None] & okd & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                  & (tt > w2.HIT_EPS) & (tid >= 0.0))
        below = inside & (tt < bt)
        level = inside & (tt == bt)
        fresh = (slots & bit) == 0
        seen = slots != 0
        replace = below & ~rah
        join = fresh & torch.where(rah, below, level & seen)
        take = replace | (join & (~seen | (tid < btid)))
        if not any_hit:
            bu = torch.where(take, uu, bu)
            bv = torch.where(take, vv, bv)
        btid = torch.where(take, tid.expand_as(btid), btid)
        bt = torch.where(replace, tt, bt)
        slots = torch.where(replace, bit, torch.where(join, slots | bit, slots))
        joins += int((join & seen).sum())
    if stats is not None:
        stats["joins"] = joins
    got = slots != 0
    t = torch.where(got, torch.minimum(torch.where(rah, 0.0, bt), rtl), rtl)
    return t, torch.where(got, btid, -1.0).to(torch.int32), bu, bv


@pytest.fixture(scope="module")
def mesh_chunks():
    """Chunks as the engine joins them: a 2k-triangle mesh at k=8, 1,024
    incoherent rays with mixed limits, kc=16."""
    rng = np.random.default_rng(3)
    cs = build_clusters(*make_mesh(2000, rng), k=8, device="cpu")
    o, d = incoherent_rays(1024, rng)
    rays = [torch.as_tensor(np.array(a, np.float32)) for a in (*o, *d)]
    u = rng.random(1024)
    tl = np.where(u < 0.3, -rng.uniform(1.0, 20.0, 1024), 3.0e38).astype(np.float32)
    tl[u > 0.95] = 0.0
    tl = torch.as_tensor(tl)
    cand, _ = w2._p1_extract(cs, *rays, tl, torch.full((1024,), -1, dtype=torch.int32), 16)
    join = w2._pair_join(cs, cand, *rays, tl)
    return [join.block_cluster, cs.super_geom, cs.super_sbox, *join.pairs]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any-hit"])
@pytest.mark.parametrize("k", [8, 16])
def test_jax_kernel_and_twin_agree_on_ties(k, any_hit):
    case = tie_case(k, seed=0)
    ref = _jax_mt_kernel(case, any_hit)
    got = [x.numpy() for x in w2.mt_chunks_reference(*_tensors(case), any_hit=any_hit)]
    assert (got[1] >= 0).sum() > 2000  # the rays really hit
    for name, a, b in zip(("t", "tri", "u", "v", "done"), got, ref):
        assert a.dtype == b.dtype, name
        if any_hit or name in ("tri", "done"):
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 if name == "t" else 1e-4, err_msg=name)


@pytest.mark.parametrize("k", [8, 16])
def test_tie_case_has_its_special_rows(k):
    table, geom, sbox, pairs = tie_case(k, seed=0)
    args = _tensors((table, geom, sbox, pairs))
    live = table < geom.shape[0]
    gates = _row_gates(args[2][torch.clamp(args[0], max=geom.shape[0] - 1).long()], *args[3:]).numpy()
    assert (gates[live, 5, 7, :].sum(-1) == 1).all() and gates[live, 5, 7, 17].all()  # one pair opens sub 7
    assert ((pairs[6][:, 6] != 0).sum(-1) == 4).all()  # row 6: fillers but for 4 lanes
    kinds = [(pairs[6][:, r] > 0).any() and (pairs[6][:, r] < 0).any() and (pairs[6][:, r] == 0).any()
             for r in (0, 1, 2, 3, 4, 7)]
    assert all(kinds)  # closest, any-hit and filler lanes share rows
    ids = geom[..., 9]
    assert np.unique(ids[ids >= 0]).size == (ids >= 0).sum()  # copies carry ids of their own


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any-hit"])
@pytest.mark.parametrize("case_id", ["ties-k8-s0", "ties-k8-s1", "ties-k8-s2", "ties-k16-s0", "ties-k16-s1",
                                     "ties-k16-s2", "mesh"])
def test_single_state_equals_eight_slots(case_id, any_hit, mesh_chunks):
    if case_id == "mesh":
        args = mesh_chunks
    else:
        _, k, seed = case_id.split("-")
        args = _tensors(tie_case(int(k[1:]), seed=int(seed[1:])))
    stats = {}
    got = single_state_mt(*args, any_hit=any_hit, stats=stats)
    want = w2.mt_chunks_reference(*args, any_hit=any_hit)
    assert int((want[1] >= 0).sum()) > 100
    if case_id != "mesh":
        assert stats["joins"] > 100  # slots did reach an equal t after the first
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
