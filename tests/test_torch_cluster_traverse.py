"""Port parity: the dense per-ray cluster traversal of raytracer_tpu_torch
(``ops/cluster_traverse.py``, the ``cluster`` traversal mode) against the JAX
package's.  Plain tensor code on both sides; no kernel.

One 2k-triangle mesh clustered at k=8 and 2,048 rays (half coherent, half
incoherent).  Tolerances: phase-1 candidate ids and entry distances bit
equal (slab tests cannot contract to FMA); tri ids equal on >= 99.9% of rays
with every disagreement a tie within |dt| <= 1e-4; t within rtol 1e-5 / atol
1e-5; u, v within rtol 1e-5 / atol 1e-4 (XLA:CPU may contract their
cancelling products to FMA); occlusion and overflow exact.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import cluster_traverse as ref_ct
from raytracer_tpu.scene.clusters import build_clusters as ref_build_clusters
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import cluster_traverse as ct
from raytracer_tpu_torch.scene.clusters import build_clusters

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from traversal_bench import coherent_rays, incoherent_rays, make_mesh  # noqa: E402

K = 8
N_RAYS = 2048


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(13)
    v0, e1, e2 = make_mesh(2000, rng)
    oc, dc = coherent_rays(N_RAYS // 2, rng)
    oi, di = incoherent_rays(N_RAYS // 2, rng)
    cat = lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]).astype(np.float32)
    o = [cat(oc[i], oi[i]) for i in range(3)]
    d = [cat(dc[i], di[i]) for i in range(3)]
    lim = rng.uniform(1.0, 20.0, N_RAYS).astype(np.float32)
    return dict(ref_cs=ref_build_clusters(v0, e1, e2, k=K), cs=build_clusters(v0, e1, e2, k=K, device="cpu"),
                ref_rays=(RefVec3(*map(jnp.asarray, o)), RefVec3(*map(jnp.asarray, d))),
                rays=(Vec3(*map(torch.as_tensor, o)), Vec3(*map(torch.as_tensor, d))), lim=lim)


@pytest.mark.parametrize("t_max", ["big", "per_ray"])
@pytest.mark.parametrize("kmax", [8, 32])
def test_phase1_candidates_bit_equal(case, kmax, t_max):
    ref_tm, tm = (3.0e38, 3.0e38) if t_max == "big" else (jnp.asarray(case["lim"]), torch.as_tensor(case["lim"]))
    ref_ids, ref_tmins = ref_ct._phase1_candidates(case["ref_cs"], *case["ref_rays"], ref_tm, kmax)
    ids, tmins = ct._phase1_candidates(case["cs"], *case["rays"], tm, kmax)
    assert ids.dtype == torch.int32 and ids.shape == (N_RAYS, kmax)
    assert np.array_equal(tmins.numpy(), np.asarray(ref_tmins))
    # where no cluster is left (+inf keys) both fill with the lowest ids in order
    assert np.array_equal(ids.numpy(), np.asarray(ref_ids))


def test_phase1_chunked_like_one_step(case, monkeypatch):
    whole = ct._phase1_candidates(case["cs"], *case["rays"], 3.0e38, 16)
    monkeypatch.setattr(ct, "_CHUNK_ELEMS", 300 * case["cs"].num_clusters)  # 300 rays a step
    for a, b in zip(whole, ct._phase1_candidates(case["cs"], *case["rays"], 3.0e38, 16)):
        assert torch.equal(a, b)


def test_mt_block_matches(case):
    cs, ref_cs = case["cs"], case["ref_cs"]
    ids, _ = ct._phase1_candidates(cs, *case["rays"], 3.0e38, 1)
    cid = ids[:, 0].long()
    ref = ref_ct._mt_block(ref_cs.tri_block[jnp.asarray(cid.numpy())], *case["ref_rays"], K)
    got = ct._mt_block(cs.tri_block[cid], *case["rays"], K)
    rt, rslot = np.asarray(ref[0]), np.asarray(ref[1])
    t, slot = got[0].numpy(), got[1].numpy()
    same = slot == rslot
    assert same.mean() >= 0.999 and (t[same] < 1e30).sum() > 20  # the nearest cluster alone holds few hits
    np.testing.assert_allclose(t[same], rt[same], rtol=1e-5, atol=1e-5)
    for g, r in zip(got[2:], ref[2:]):  # u, v of the winning slot
        hit = same & (t < 1e30)
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(r)[hit], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kmax", [4, 32])
def test_cluster_closest_hit_matches(case, kmax):
    """kmax=4 truncates many incoherent rays: the overflow mask must agree."""
    ref = [np.asarray(x) for x in ref_ct.cluster_closest_hit(case["ref_cs"], *case["ref_rays"], 3.0e38, kmax)]
    got = [x.numpy() for x in ct.cluster_closest_hit(case["cs"], *case["rays"], 3.0e38, kmax)]
    same = ref[1] == got[1]
    assert same.mean() >= 0.999, same.mean()
    assert np.all(np.abs(ref[0][~same] - got[0][~same]) <= 1e-4)
    assert (same & (got[1] >= 0)).sum() > 100
    np.testing.assert_allclose(got[0][same], ref[0][same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2][same], ref[2][same], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[3][same], ref[3][same], rtol=1e-5, atol=1e-4)
    assert np.array_equal(got[4], ref[4])
    assert got[4].any() == (kmax == 4)
    assert got[1].dtype == np.int32


@pytest.mark.parametrize("kmax", [4, 32])
def test_cluster_any_hit_matches(case, kmax):
    ref_occ, ref_ovf = ref_ct.cluster_any_hit(case["ref_cs"], *case["ref_rays"], jnp.asarray(case["lim"]), kmax)
    occ, ovf = ct.cluster_any_hit(case["cs"], *case["rays"], torch.as_tensor(case["lim"]), kmax)
    assert np.array_equal(occ.numpy(), np.asarray(ref_occ)) and occ.numpy().mean() > 0.05
    assert np.array_equal(ovf.numpy(), np.asarray(ref_ovf))


def test_cluster_agrees_with_wave2(case):
    """Two independent exact engines of the port on the same rays."""
    from raytracer_tpu_torch.ops.wave2_traverse import wave2_closest_hit

    c = ct.cluster_closest_hit(case["cs"], *case["rays"], 3.0e38, 64)
    w = wave2_closest_hit(case["cs"], *case["rays"], 3.0e38)
    ok = ~c[4]
    assert ok.float().mean() > 0.9
    assert (c[1][ok] == w[1][ok]).float().mean() >= 0.999
