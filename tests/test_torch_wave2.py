"""Port parity: the wave2 sort-join engine of raytracer_tpu_torch against the
JAX package's, which runs its Pallas MT kernel in interpret mode on the CPU
(as the JAX engine does off-TPU).  The port runs its kernel's plain twin.

One 2k-triangle mesh clustered at k=8 (interpret-mode compile takes ~19 s
at k=8 against ~80 s at the default k=64) and one batch of 2,048 rays
(coherent + incoherent), built once per module so each JAX mode compiles
once.  Tolerances: tri ids equal on >= 99.9% of rays, any disagreement a
tie within |dt| <= 1e-4; t, u, v within rtol=1e-5, atol=1e-5 where the
tri ids agree; occlusion and overflow exact.  Integer stages (candidates,
the stage-1 sort permutation, the filler-padded order, block_cluster) are
bit equal.
"""

import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import wave2_traverse as ref_w2
from raytracer_tpu.scene.clusters import build_clusters as ref_build_clusters
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import wave2_traverse as w2
from raytracer_tpu_torch.scene.clusters import build_clusters

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from traversal_bench import coherent_rays, incoherent_rays, make_mesh  # noqa: E402

K = 8
N_RAYS = 2048


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    v0, e1, e2 = make_mesh(2000, rng)
    oc, dc = coherent_rays(N_RAYS // 2, rng)
    oi, di = incoherent_rays(N_RAYS // 2, rng)
    cat = lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]).astype(np.float32)
    o = [cat(oc[i], oi[i]) for i in range(3)]
    d = [cat(dc[i], di[i]) for i in range(3)]
    # mixed-sign limits: negative lanes are any-hit (occlusion) queries,
    # zero lanes have no work
    u = rng.random(N_RAYS)
    tm = np.where(u < 0.3, -rng.uniform(1.0, 20.0, N_RAYS), 3.0e38).astype(np.float32)
    tm[u > 0.95] = 0.0
    return dict(
        ref_cs=ref_build_clusters(v0, e1, e2, k=K),
        cs=build_clusters(v0, e1, e2, k=K, device="cpu"),
        o=o, d=d, tm=tm,
    )


def _ref_rays(c):
    return RefVec3(*map(jnp.asarray, c["o"])), RefVec3(*map(jnp.asarray, c["d"]))


def _rays(c):
    return Vec3(*map(torch.as_tensor, c["o"])), Vec3(*map(torch.as_tensor, c["d"]))


@pytest.fixture(scope="module")
def closest(case):
    ref = ref_w2.wave2_closest_hit(case["ref_cs"], *_ref_rays(case), jnp.asarray(case["tm"]))
    got = w2.wave2_closest_hit(case["cs"], *_rays(case), torch.as_tensor(case["tm"]))
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_clusters_equal(case):
    for f in ("super_box", "super_geom", "super_sbox", "tri_id"):
        assert np.array_equal(getattr(case["cs"], f).numpy(), np.asarray(getattr(case["ref_cs"], f))), f


def test_closest_hit_matches(closest):
    (rt, rtri, ru, rv, rovf), (t, tri, u, v, ovf) = closest
    same = rtri == tri
    assert same.mean() >= 0.999, same.mean()
    assert np.all(np.abs(rt[~same] - t[~same]) <= 1e-4)  # disagreements are ties
    hit = same & (tri >= 0)
    assert hit.sum() > 200  # the batch really hits the mesh
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u[same], ru[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v[same], rv[same], rtol=1e-5, atol=1e-5)
    assert np.array_equal(t[tri < 0], rt[rtri < 0])  # misses report BIG
    assert not rovf.any() and not ovf.any()


def test_any_hit_lanes_are_occlusion_queries(case, closest):
    (_, rtri, _, _, _), (t, tri, _, _, _) = closest
    ah = case["tm"] < 0
    assert np.array_equal(tri[ah] >= 0, rtri[ah] >= 0)
    assert np.all(t[ah & (tri >= 0)] == 0.0)  # collapsed to 0 on the first hit


def test_any_hit_matches(case):
    lim = np.abs(case["tm"])
    ref_occ, ref_ovf = ref_w2.wave2_any_hit(case["ref_cs"], *_ref_rays(case), jnp.asarray(lim))
    occ, ovf = w2.wave2_any_hit(case["cs"], *_rays(case), torch.as_tensor(lim))
    assert np.array_equal(occ.numpy(), np.asarray(ref_occ))
    assert occ.numpy().mean() > 0.05
    assert not np.asarray(ref_ovf).any() and not ovf.numpy().any()


def _capture_ref_round(cs_set, rays, tl, cursor, kc):
    """Run the JAX ``_round`` eagerly, recording its sorts' outputs and the
    arguments of its Pallas call."""
    sorts, calls = [], []
    real_sort, real_pallas = jax.lax.sort, ref_w2.pl.pallas_call

    def sort(operands, *a, **k):
        out = real_sort(operands, *a, **k)
        sorts.append([np.asarray(x) for x in out])
        return out

    def pallas_call(kernel, **k):
        fn = real_pallas(kernel, **k)

        def launch(*args):
            calls.append([np.asarray(x) for x in args])
            return fn(*args)

        return launch

    with mock.patch.object(jax.lax, "sort", sort), mock.patch.object(ref_w2.pl, "pallas_call", pallas_call):
        out = ref_w2._round.__wrapped__(cs_set, *rays, tl, cursor, kc, 1, False)
    return [np.asarray(x) for x in out if not isinstance(x, tuple)], sorts, calls


def test_round_stage_by_stage(case):
    kc = 16
    o, d = case["o"], case["d"]
    tl = case["tm"]
    cursor = np.full(N_RAYS, -1, np.int32)
    ref_rays = [jnp.asarray(a) for a in (*o, *d)]
    rays = [torch.as_tensor(a) for a in (*o, *d)]

    ref_cand, ref_rem = ref_w2._p1_extract(case["ref_cs"], *ref_rays, jnp.asarray(tl), jnp.asarray(cursor), kc)
    cand, rem = w2._p1_extract(case["cs"], *rays, torch.as_tensor(tl), torch.as_tensor(cursor), kc)
    assert np.array_equal(cand.numpy(), np.asarray(ref_cand))
    assert np.array_equal(rem.numpy(), np.asarray(ref_rem))

    ref_out, sorts, calls = _capture_ref_round(case["ref_cs"], ref_rays, jnp.asarray(tl), jnp.asarray(cursor), kc)
    join = w2._pair_join(case["cs"], cand, *rays, torch.as_tensor(tl))
    assert np.array_equal(join.sidx.numpy(), sorts[0][1])  # stage-1 sort permutation
    assert np.array_equal(join.fidx.numpy(), sorts[1][1])  # filler-padded order
    (ref_block_cluster, _, _, *ref_pairs) = calls[0]
    assert np.array_equal(join.block_cluster.numpy(), ref_block_cluster)
    for got, want in zip(join.pairs, ref_pairs):
        assert np.array_equal(got.numpy(), want)

    # the kernel twin on the very chunks the Pallas kernel saw
    outs = w2.mt_chunks(join.block_cluster, case["cs"].super_geom, case["cs"].super_sbox, *join.pairs,
                        any_hit=False)
    ref_outs = sorts[2][1:6]  # the kernel outputs, back in pair order
    back = torch.sort(join.fidx, stable=True).indices
    for i, (got, want) in enumerate(zip(outs, ref_outs)):
        got = got.reshape(-1)[back].numpy()
        if i == 0:  # t
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        elif got.dtype == np.float32:
            # u, v: (t . p) * inv_det cancels; XLA:CPU may contract to FMA
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        else:  # tri, done
            assert np.mean(got == want) >= 0.999

    t, tri, u, v, cur, unres = w2._round(case["cs"], *rays, torch.as_tensor(tl), torch.as_tensor(cursor),
                                         kc, False)
    rt, rtri, ru, rv, rcur, runres = ref_out
    assert np.mean(tri.numpy() == rtri) >= 0.999
    np.testing.assert_allclose(t.numpy(), rt, rtol=1e-5, atol=1e-5)
    assert np.array_equal(cur.numpy(), rcur) and np.array_equal(unres.numpy(), runres)


def test_interp_tri_attr_matches():
    rng = np.random.default_rng(5)
    v0, e1, e2 = make_mesh(500, rng)
    t = v0.shape[0]
    nrm = rng.normal(size=(t, 3, 3)).astype(np.float32)
    uv = rng.random((t, 3, 2)).astype(np.float32)
    mid = rng.integers(0, 4, t).astype(np.int32)
    ref_cs = ref_build_clusters(v0, e1, e2, k=K, normals=nrm, uvs=uv, material_ids=mid)
    cs = build_clusters(v0, e1, e2, k=K, normals=nrm, uvs=uv, material_ids=mid, device="cpu")
    tri = rng.integers(-1, t, 256).astype(np.int32)
    u = rng.random(256).astype(np.float32) * 0.5
    v = rng.random(256).astype(np.float32) * 0.5
    ref = ref_w2.interp_tri_attr(ref_cs, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v))
    got = w2.interp_tri_attr(cs, torch.as_tensor(tri), torch.as_tensor(u), torch.as_tensor(v))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)

