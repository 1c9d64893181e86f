"""Port parity: the block-candidate traversal of raytracer_tpu_torch
(``ops/pallas_traverse.py``) against the JAX package's, whose two Pallas
kernels run here in interpret mode on the CPU (``pl.pallas_call`` is patched
to pass ``interpret=True``; nothing in the JAX package changes).  The port
runs its kernels' plain PyTorch versions, as it does for any CPU tensor.

One 2k-triangle mesh clustered at k=8 and 2,048 rays (1,024 coherent, then
1,024 incoherent: two ray blocks), built once per module.  Tolerances:

- host stages are bit equal: ``_ray_sort_keys``, the sort permutation, the
  dense ``cand`` / ``entry`` tables, the BFS ``cand`` / ``entry`` /
  ``overflow`` (slab tests and interval tests are sub-then-mul and
  divisions, which XLA:CPU cannot contract);
- kernel outputs: tri ids equal on >= 99.9% of rays, every disagreement a
  tie within |dt| <= 1e-4; t within rtol 1e-5 / atol 1e-5; u, v within
  rtol 1e-5 / atol 1e-4 (their numerators cancel, and XLA:CPU may contract
  the products to FMA where the port rounds each product);
- occlusion and overflow exact.
"""

import os
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import pallas_traverse as ref_pt
from raytracer_tpu.scene.clusters import build_clusters as ref_build_clusters
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import pallas_traverse as pt
from raytracer_tpu_torch.scene.clusters import build_clusters

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from traversal_bench import coherent_rays, incoherent_rays, make_mesh  # noqa: E402

K = 8
N_RAYS = 2048
BIGF = 3.0e38


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    """Run the JAX package's TPU kernels in Pallas interpret mode."""
    real = ref_pt.pl.pallas_call
    with mock.patch.object(ref_pt.pl, "pallas_call", lambda kernel, **kw: real(kernel, interpret=True, **kw)):
        yield


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    v0, e1, e2 = make_mesh(2000, rng)
    oc, dc = coherent_rays(N_RAYS // 2, rng)
    oi, di = incoherent_rays(N_RAYS // 2, rng)
    cat = lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]).astype(np.float32)
    o = [cat(oc[i], oi[i]) for i in range(3)]
    d = [cat(dc[i], di[i]) for i in range(3)]
    lim = rng.uniform(1.0, 20.0, N_RAYS).astype(np.float32)
    lim[rng.random(N_RAYS) > 0.95] = 0.0  # lanes with no work
    return dict(ref_cs=ref_build_clusters(v0, e1, e2, k=K), cs=build_clusters(v0, e1, e2, k=K, device="cpu"),
                o=o, d=d, big=np.full(N_RAYS, BIGF, np.float32), lim=lim)


def _ref(c, tm, n=N_RAYS):
    return (RefVec3(*(jnp.asarray(a[:n]) for a in c["o"])), RefVec3(*(jnp.asarray(a[:n]) for a in c["d"])),
            jnp.asarray(tm[:n]))


def _got(c, tm, n=N_RAYS):
    return (Vec3(*(torch.as_tensor(a[:n]) for a in c["o"])), Vec3(*(torch.as_tensor(a[:n]) for a in c["d"])),
            torch.as_tensor(tm[:n]))


def _flat(c, tm, lib):
    return [lib(a) for a in (*c["o"], *c["d"], tm)]


def assert_hits_match(ref, got, min_hits=100):
    """(t, tri, u, v) of the port against the reference's, to the module's
    stated tolerances."""
    rt, rtri, ru, rv = (np.asarray(x) for x in ref[:4])
    t, tri, u, v = (x.numpy() for x in got[:4])
    same = rtri == tri
    assert same.mean() >= 0.999, same.mean()
    assert np.all(np.abs(rt[~same] - t[~same]) <= 1e-4)  # disagreements are ties
    assert (same & (tri >= 0)).sum() >= min_hits  # the batch really hits the mesh
    np.testing.assert_allclose(t[same], rt[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u[same], ru[same], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(v[same], rv[same], rtol=1e-5, atol=1e-4)


def test_sort_keys_and_permutation_bit_equal(case):
    ro, rd, _ = _ref(case, case["big"])
    o, d, _ = _got(case, case["big"])
    ref_keys = ref_pt._ray_sort_keys(case["ref_cs"], ro, rd)
    keys = pt._ray_sort_keys(case["cs"], o, d)
    assert keys.dtype == torch.int32 and np.array_equal(keys.numpy(), np.asarray(ref_keys))
    # pads and dead lanes sort last, equal keys keep their order
    ref_keys = jnp.where(jnp.asarray(case["lim"]) > 0.0, ref_keys, jnp.int32(0x7FFFFFFF))
    keys = torch.where(torch.as_tensor(case["lim"]) > 0.0, keys, 0x7FFFFFFF)
    assert np.array_equal(torch.sort(keys, stable=True).indices.numpy(), np.asarray(jnp.argsort(ref_keys)))


@pytest.mark.parametrize("kb", [48, 300])
def test_dense_block_candidates_bit_equal(case, kb):
    kb = min(kb, case["cs"].num_clusters)
    ref_cand, ref_entry = ref_pt._block_candidates(case["ref_cs"], *_ref(case, case["lim"]), kb)
    cand, entry = pt._block_candidates(case["cs"], *_got(case, case["lim"]), kb)
    assert cand.dtype == torch.int32 and cand.shape == (N_RAYS // pt.RB, kb)
    assert np.array_equal(cand.numpy(), np.asarray(ref_cand))
    assert np.array_equal(entry.numpy(), np.asarray(ref_entry))
    assert np.isfinite(entry.numpy()).sum() > kb  # real candidates, and equal keys among them
    assert (entry.numpy() == 0.0).sum() > 1


def test_dense_block_candidates_chunked_like_one_step(case, monkeypatch):
    """The ray-block chunking of phase 1 changes nothing."""
    whole = pt._block_candidates(case["cs"], *_got(case, case["big"]), 48)
    monkeypatch.setattr(pt, "_PHASE1_ELEMS", case["cs"].num_clusters * pt.RB)  # one block a step
    for a, b in zip(whole, pt._block_candidates(case["cs"], *_got(case, case["big"]), 48)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kb", [16, 64, 256])
def test_bfs_block_candidates_bit_equal(case, kb):
    """Coherent block first, incoherent second; kb=16 truncates (overflow
    set), kb=256 exceeds the 250 clusters' padded tree only at the leaves."""
    ref = ref_pt._block_candidates_bfs(case["ref_cs"], *_ref(case, case["lim"]), kb)
    got = pt._block_candidates_bfs(case["cs"], *_got(case, case["lim"]), kb)
    for name, r, g in zip(("cand", "entry", "overflow"), ref, got):
        assert np.array_equal(g.numpy(), np.asarray(r)), name
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    if kb == 16:
        assert got[2].any()


def test_interval_entry_and_block_bounds_bit_equal(case):
    ro, rd, rtm = _ref(case, case["lim"])
    o, d, tm = _got(case, case["lim"])
    ref_bounds = ref_pt._block_bounds(ro, rd, rtm.reshape(-1, pt.RB))
    bounds = pt._block_bounds(o, d, tm.reshape(-1, pt.RB))
    for r, g in zip(ref_bounds[:4], bounds[:4]):
        for ra, ga in zip(r, g):
            assert np.array_equal(ga.numpy(), np.asarray(ra))
    assert np.array_equal(bounds[4].numpy(), np.asarray(ref_bounds[4]))
    level = case["cs"].tree_levels[1]
    b = tm.shape[0] // pt.RB
    ref_ent, ref_ok = ref_pt._interval_entry(ref_bounds, jnp.broadcast_to(case["ref_cs"].tree_levels[1][None],
                                                                          (b,) + tuple(level.shape)))
    ent, ok = pt._interval_entry(bounds, level[None].expand(b, -1, -1))
    assert np.array_equal(ent.numpy(), np.asarray(ref_ent)) and np.array_equal(ok.numpy(), np.asarray(ref_ok))


def test_grid_kernel_on_dense_candidates(case):
    """``_pallas_closest_hit_padded``: dense candidates + ``_phase2_kernel``
    against the port's ``phase2_grid`` plain version."""
    ref = ref_pt._pallas_closest_hit_padded(case["ref_cs"], *_flat(case, case["big"], jnp.asarray), 48)
    got = pt._pallas_closest_hit_padded(case["cs"], *_flat(case, case["big"], torch.as_tensor), 48)
    assert_hits_match(ref, got)
    assert got[1].dtype == torch.int32


def test_grid_kernel_on_sorted_bfs_candidates(case):
    """``_pallas_sorted_closest_hit``: the same kernel behind the sorted
    front end; overflow is the BFS's, exact."""
    ref = ref_pt._pallas_sorted_closest_hit(case["ref_cs"], *_flat(case, case["big"], jnp.asarray), 64)
    got = pt._pallas_sorted_closest_hit(case["cs"], *_flat(case, case["big"], torch.as_tensor), 64)
    assert_hits_match(ref, got)
    assert np.array_equal(got[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_kernel_on_sorted_bfs_candidates(case, any_hit):
    """``_pallas_stream_trace``: ``_phase2_stream_kernel`` against the
    port's ``phase2_stream`` plain version, closest-hit and any-hit."""
    tm = case["lim"] if any_hit else case["big"]
    ref = ref_pt._pallas_stream_trace(case["ref_cs"], *_flat(case, tm, jnp.asarray), 64, any_hit)
    got = pt._pallas_stream_trace(case["cs"], *_flat(case, tm, torch.as_tensor), 64, any_hit)
    if any_hit:
        rtri, tri = np.asarray(ref[1]), got[1].numpy()
        assert np.array_equal(tri >= 0, rtri >= 0)  # occlusion exact
        assert (tri >= 0).sum() > 100
        assert np.mean(tri == rtri) >= 0.999
        assert np.all(got[0].numpy()[tri >= 0] == 0.0)  # hit lanes park at t = 0
        assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    else:
        assert_hits_match(ref, got)
    assert np.array_equal(got[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("n", [N_RAYS, 1500])
def test_pallas_cluster_entry_points(case, n):
    """``pallas_cluster_closest_hit`` / ``_any_hit`` at kb=48, also on a ray
    count that needs padding to whole blocks."""
    ref = ref_pt.pallas_cluster_closest_hit(case["ref_cs"], *_ref(case, case["big"], n))
    got = pt.pallas_cluster_closest_hit(case["cs"], *_got(case, case["big"], n))
    assert got[0].shape == (n,)
    assert_hits_match(ref, got)
    assert np.array_equal(got[4].numpy(), np.asarray(ref[4]))
    assert np.array_equal(got[0].numpy()[got[1].numpy() < 0], np.asarray(ref[0])[np.asarray(ref[1]) < 0])
    ref_occ = ref_pt.pallas_cluster_any_hit(case["ref_cs"], *_ref(case, case["lim"], n))
    occ = pt.pallas_cluster_any_hit(case["cs"], *_got(case, case["lim"], n))
    assert np.array_equal(occ.numpy(), np.asarray(ref_occ)) and occ.numpy().mean() > 0.05


@pytest.mark.parametrize("n", [N_RAYS, 1500])
def test_pallas_sorted_entry_points(case, n):
    """``pallas_sorted_closest_hit`` / ``_any_hit``, the two queries of the
    ``sorted-pallas`` mode, at kb=64."""
    ref = ref_pt.pallas_sorted_closest_hit(case["ref_cs"], *_ref(case, case["big"], n), kb=64)
    got = pt.pallas_sorted_closest_hit(case["cs"], *_got(case, case["big"], n), kb=64)
    assert_hits_match(ref, got)
    assert np.array_equal(got[4].numpy(), np.asarray(ref[4]))
    ref_occ, ref_ovf = ref_pt.pallas_sorted_any_hit(case["ref_cs"], *_ref(case, case["lim"], n), kb=64)
    occ, ovf = pt.pallas_sorted_any_hit(case["cs"], *_got(case, case["lim"], n), kb=64)
    assert np.array_equal(occ.numpy(), np.asarray(ref_occ)) and occ.numpy().mean() > 0.05
    assert np.array_equal(ovf.numpy(), np.asarray(ref_ovf))


def test_box_gate_skips_work_not_hits(case):
    """The stream version's block-wide box gate runs the triangle loop for
    fewer (block, candidate) steps than the grid version on the same table,
    and loses no hit by it (a grazing hit at a box face may differ)."""
    rays = [torch.as_tensor(a).reshape(-1, 8, 128) for a in (*case["o"], *case["d"], case["big"])]
    cs = case["cs"]
    cand, entry, _ = pt._block_candidates_bfs(cs, *_got(case, case["big"]), 64)
    stats, grid_stats = {}, {}
    gated = pt.phase2_stream_reference(cand, entry, cs.stream_block, *rays, K, False, stats=stats)
    ungated = pt.phase2_grid_reference(cand, entry, cs.tri_block, cs.tri_id, *rays, stats=grid_stats)
    assert 0 < stats["visits"] < stats["steps"] <= grid_stats["visits"] <= cand.numel()
    assert (gated[1] == ungated[1]).float().mean() >= 0.999


def test_nearest_first_orders_like_top_k():
    key = torch.tensor([[0.0, -0.0, 0.0, float("inf"), 1.0, float("inf"), -0.0, 0.5]])
    val, idx = pt.nearest_first(key, 8)
    import jax

    neg, ref_idx = jax.lax.top_k(-jnp.asarray(key.numpy()), 8)
    assert np.array_equal(idx.numpy(), np.asarray(ref_idx))
    assert np.array_equal(np.signbit(val.numpy()), np.signbit(-np.asarray(neg)))


@pytest.mark.parametrize("wrapper", ["phase2_grid", "phase2_stream"])
def test_wrappers_raise_on_a_device_without_a_kernel(wrapper):
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    rays = [meta(1, 8, 128) for _ in range(7)]
    with pytest.raises(ValueError, match="unsupported device"):
        if wrapper == "phase2_grid":
            pt.phase2_grid(meta(1, 4, dt=torch.int32), meta(1, 4), meta(3, 72), meta(3, 8, dt=torch.int32), *rays)
        else:
            pt.phase2_stream(meta(1, 4, dt=torch.int32), meta(1, 4), meta(3, 8, 128), *rays, 8, False)


def test_pallas_available_names_the_device():
    assert pt.pallas_available("cpu") is False and pt.pallas_available("cuda:0") is True
