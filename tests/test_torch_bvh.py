"""Port parity: the skip-link BVH of raytracer_tpu_torch against the JAX
package's, on the CPU.

The tables (``BVHFlat``) come from the same native builder and the same
packing on the same inputs, so they are bit-equal.  The walk's twin
(``bvh_walk_reference``, what a CPU tensor takes) runs the reference's
lock-step walk: tri ids and occlusion are equal to JAX's; t, u and v differ
only where XLA:CPU fuses multiply-adds, so they are held to a tolerance
against JAX and bit for bit against a numpy float32 Möller-Trumbore of the
hit triangle in the twin's own op order.  Measured at these seeds, at
T = 2,000, on thin triangles where the fused products round differently: t
within 1.3e-5 relative on one ray at t = 0.0044 (5.7e-8 absolute) and within
4.4e-6 on the others, u and v within 2.1e-5 of JAX's.  Hence t within rtol
1e-5 + atol 1e-6 (as the port's phase-2 tests hold t) and u, v within atol
5e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import bvh_traverse as ref_bt
from raytracer_tpu.scene import bvh as ref_bvh
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import bvh_traverse as bt
from raytracer_tpu_torch.ops.cuda_build import launch_counts
from raytracer_tpu_torch.scene import bvh as port_bvh

N_RAYS = 4096
BIG = 3.0e38


def _random_tris(t, seed):
    """Triangles around random centers, as tests/test_bvh.py makes them, with
    random normals, uvs and material ids."""
    rng = np.random.default_rng(seed)
    v = (rng.uniform(-10.0, 10.0, (t, 1, 3)) + rng.normal(0, 0.5, (t, 3, 3))).astype(np.float32)
    n = rng.normal(size=(t, 3, 3)).astype(np.float32)
    uv = rng.random((t, 3, 2)).astype(np.float32)
    mat = rng.integers(0, 4, t).astype(np.int32)
    return v, n, uv, mat


def _random_rays(n, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _both(t_count, seed):
    v, n, uv, mat = _random_tris(t_count, seed)
    ref = ref_bvh.build_bvh_over_triangles(v, n, uv, mat)
    got = port_bvh.build_bvh_over_triangles(v, n, uv, mat, device="cpu")
    return ref, got


def _ref_vec(a):
    return RefVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _vec(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


@pytest.mark.parametrize("t_count", [1, 7, 300, 2000])
def test_bvhflat_bit_equal(t_count):
    (ref_tris, ref), (arrays, got) = _both(t_count, seed=t_count)
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert got.num_nodes == ref.num_nodes
    v0, e1, e2, nrm, uv, mat = arrays
    assert np.array_equal(v0[:, 0], np.asarray(ref_tris.v0.x)) and np.array_equal(e2[:, 2], np.asarray(ref_tris.e2.z))
    assert np.array_equal(nrm[:, 1, 2], np.asarray(ref_tris.n1.z)) and np.array_equal(uv[:, 2, 0], np.asarray(ref_tris.uv2_u))
    assert np.array_equal(mat, np.asarray(ref_tris.material_id))


def test_bvh_stats_and_save_load_round_trip(tmp_path):
    (_, ref), (_, got) = _both(300, seed=5)
    assert port_bvh.bvh_stats(got) == ref_bvh.bvh_stats(ref)
    path = str(tmp_path / "bvh.npz")
    port_bvh.save_bvh(path, got)
    back = port_bvh.load_bvh(path, device="cpu")
    assert all(getattr(back, f).numpy().tobytes() == getattr(got, f).numpy().tobytes() for f in got._fields)
    # and the reference reads the port's file
    ref_back = ref_bvh.load_bvh(path)
    assert all(np.asarray(getattr(ref_back, f)).tobytes() == np.asarray(getattr(ref, f)).tobytes() for f in ref._fields)


def _mt_f32(tri, o, d):
    """Möller-Trumbore of one triangle per ray in numpy float32, in the op
    order of ``bvh_traverse._moller_trumbore``.  Returns (t, u, v)."""
    f = np.float32
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    cross = lambda a, b: np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1], a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                                   a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)
    dot = lambda a, b: a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]
    p = cross(d, e2)
    inv_det = f(1.0) / dot(e1, p)
    tvec = o - v0
    q = cross(tvec, e1)
    return dot(e2, q) * inv_det, dot(tvec, p) * inv_det, dot(d, q) * inv_det


@pytest.mark.parametrize("t_count", [7, 300, 2000])
def test_twin_matches_reference_walk(t_count):
    """Closest hit and any-hit of 4,096 random rays: tri ids and occlusion
    equal to JAX's; t, u, v within the tolerances of the module docstring,
    and bit-equal to a numpy float32 test of the hit triangle."""
    (ref_tris, ref), (arrays, got) = _both(t_count, seed=t_count)
    o, d = _random_rays(N_RAYS, seed=t_count + 1)
    rt, rtri, ru, rv = (np.asarray(x) for x in
                        ref_bt.bvh_closest_hit(ref, ref_tris, _ref_vec(o), _ref_vec(d), jnp.full((N_RAYS,), BIG)))
    t, tri, u, v = (x.numpy() for x in bt.bvh_closest_hit(got, None, _vec(o), _vec(d), BIG))
    assert np.array_equal(tri, rtri) and (tri >= 0).mean() > (0.05 if t_count > 7 else 0.0)
    hit = tri >= 0
    assert np.array_equal(t[~hit], rt[~hit]) and (t[~hit] == np.float32(BIG)).all()
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u, ru, rtol=0, atol=5e-5)
    np.testing.assert_allclose(v, rv, rtol=0, atol=5e-5)
    v0, e1, e2 = arrays[:3]
    geom = np.concatenate([v0, e1, e2], 1)[tri[hit]]
    et, eu, ev = _mt_f32(geom, o[hit], d[hit])
    assert np.array_equal(t[hit], et) and np.array_equal(u[hit], eu) and np.array_equal(v[hit], ev)

    limit = np.random.default_rng(t_count).uniform(1.0, 20.0, N_RAYS).astype(np.float32)
    ref_occ = np.asarray(ref_bt.bvh_any_hit(ref, ref_tris, _ref_vec(o), _ref_vec(d), jnp.asarray(limit)))
    occ = bt.bvh_any_hit(got, None, _vec(o), _vec(d), torch.as_tensor(limit)).numpy()
    assert np.array_equal(occ, ref_occ)
    assert np.array_equal(occ, hit & (t < limit))  # any-hit agrees with the closest hit


def _brute_force_closest(v0, e1, e2, o, d, eps=1e-4):
    """All-pairs Möller-Trumbore in float64 (tests/test_bvh.py's oracle)."""
    best_t = np.full(o.shape[0], np.inf)
    best_i = np.full(o.shape[0], -1, np.int64)
    for i in range(v0.shape[0]):
        pvec = np.cross(d, e2[i])
        det = (e1[i] * pvec).sum(1)
        ok = np.abs(det) > 1e-9
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tvec = o - v0[i]
        u = (tvec * pvec).sum(1) * inv
        qvec = np.cross(tvec, e1[i])
        v = (d * qvec).sum(1) * inv
        t = (e2[i] * qvec).sum(1) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps)
        closer = hit & (t < best_t)
        best_t = np.where(closer, t, best_t)
        best_i = np.where(closer, i, best_i)
    return best_t, best_i


def test_twin_matches_brute_force():
    v, n, uv, mat = _random_tris(500, seed=7)
    (v0, e1, e2, *_), got = port_bvh.build_bvh_over_triangles(v, n, uv, mat, device="cpu")
    o, d = _random_rays(2048, seed=8)
    t, tri, _, _ = (x.numpy() for x in bt.bvh_closest_hit(got, None, _vec(o), _vec(d), BIG))
    f64 = lambda a: a.astype(np.float64)
    bt_, bi = _brute_force_closest(f64(v0), f64(e1), f64(e2), f64(o), f64(d))
    miss = tri < 0
    assert np.array_equal(miss, np.isinf(bt_)) and (~miss).sum() > 100
    np.testing.assert_allclose(t[~miss], bt_[~miss], rtol=1e-4, atol=1e-4)
    assert (tri[~miss] == bi[~miss]).mean() > 0.99  # ties may pick either triangle


def test_t_max_respected():
    (_, _), (_, got) = _both(300, seed=21)
    o, d = _random_rays(1024, seed=22)
    t_all, tri_all, _, _ = bt.bvh_closest_hit(got, None, _vec(o), _vec(d), BIG)
    t_cap, tri_cap, _, _ = bt.bvh_closest_hit(got, None, _vec(o), _vec(d), 5.0)
    hit = tri_cap >= 0
    assert (t_cap[hit] < 5.0).all() and hit.any()
    assert torch.equal(hit, (tri_all >= 0) & (t_all < 5.0))  # hits beyond the cap are misses
    assert torch.equal(tri_cap[hit], tri_all[hit])


def test_step_cap_truncates_as_the_reference(monkeypatch):
    """With MAX_TRAVERSAL_STEPS patched small on both sides, the same rays
    stop early with the same partial answers, and the step counts show it."""
    (ref_tris, ref), (_, got) = _both(2000, seed=3)
    o, d = _random_rays(N_RAYS, seed=4)
    full = bt.bvh_walk(got, _vec(o), _vec(d), torch.full((N_RAYS,), BIG), any_hit=False, count_steps=True)
    monkeypatch.setattr(ref_bt, "MAX_TRAVERSAL_STEPS", 40)
    monkeypatch.setattr(bt, "MAX_TRAVERSAL_STEPS", 40)
    assert bt.walk_budget(got.num_nodes) == 48
    cut = bt.bvh_walk(got, _vec(o), _vec(d), torch.full((N_RAYS,), BIG), any_hit=False, count_steps=True)
    rt, rtri, _, _ = ref_bt.bvh_closest_hit(ref, ref_tris, _ref_vec(o), _ref_vec(d), jnp.full((N_RAYS,), BIG))
    assert np.array_equal(cut.tri.numpy(), np.asarray(rtri))
    capped = full.steps > 48
    assert capped.sum() > 100 and torch.equal(cut.steps, torch.clamp_max(full.steps, 48))
    assert not torch.equal(cut.tri[capped], full.tri[capped])  # some capped rays lost their hit
    assert torch.equal(cut.tri[~capped], full.tri[~capped])
    limit = np.full(N_RAYS, 6.0, np.float32)
    occ = bt.bvh_any_hit(got, None, _vec(o), _vec(d), torch.as_tensor(limit)).numpy()
    assert np.array_equal(occ, np.asarray(ref_bt.bvh_any_hit(ref, ref_tris, _ref_vec(o), _ref_vec(d),
                                                            jnp.asarray(limit))))


def _plain_threading(left, right, axis):
    """The skip links of the tree as the reference's Python builder threads
    them: per octant, a depth-first walk from node 0 that visits the near
    child first; ``hit`` descends, ``miss`` skips the subtree."""
    m = len(left)
    hit, miss = np.zeros((8, m), np.int32), np.zeros((8, m), np.int32)
    left, right, axis = left.tolist(), right.tolist(), axis.tolist()
    for octant in range(8):
        h, ms = hit[octant], miss[octant]
        hl, ml = [0] * m, [0] * m
        stack = [(0, -1)]
        while stack:
            node, cont = stack.pop()
            ml[node] = cont
            near = left[node]
            if near < 0:
                hl[node] = cont
                continue
            far = right[node]
            if (octant >> axis[node]) & 1:
                near, far = far, near
            hl[node] = near
            stack.append((far, cont))
            stack.append((near, far))
        h[:], ms[:] = hl, ml
    return hit, miss


def test_links_of_a_tree_over_a_million_nodes():
    """A tree of 2^20 - 1 nodes, given as node arrays (a complete binary
    tree of depth 20 under a random numbering, node 0 the root, random split
    axes): the native threading's links are the plain threading's.  The
    builder once handed the children over in float lanes as
    ``axis * 1e6 + right`` and refused trees of more than 1,000,000 nodes."""
    depth = 20
    m = (1 << depth) - 1
    rng = np.random.default_rng(5)
    ids = np.concatenate([[0], 1 + rng.permutation(m - 1)]).astype(np.int32)  # heap slot -> node id
    heap = np.arange(m)
    inner = heap < (m - 1) // 2
    left = np.full(m, -1, np.int32)
    right = np.full(m, -1, np.int32)
    left[ids[heap[inner]]] = ids[2 * heap[inner] + 1]
    right[ids[heap[inner]]] = ids[2 * heap[inner] + 2]
    axis = rng.integers(0, 3, m).astype(np.int32)
    assert m > 1_000_000 and right.max() >= 1_000_000
    hit, miss = port_bvh.thread_links(left, right, axis)
    want_hit, want_miss = _plain_threading(left, right, axis)
    assert np.array_equal(hit, want_hit) and np.array_equal(miss, want_miss)


def test_build_hands_the_threading_each_node_s_children_and_axis():
    """The native build's node arrays are a tree over every node (each node
    but the root the child of one inner node, leaves exactly the nodes with
    a first slot), and the links of ``build_bvh_over_triangles`` are the
    plain threading of those arrays."""
    v, n, uv, mat = _random_tris(3000, seed=6)
    nodes_box, node_first, _, _, (left, right, axis) = port_bvh._native_build(v.min(1), v.max(1))
    m = nodes_box.shape[0]
    inner = left >= 0
    assert np.array_equal(inner, node_first < 0) and np.array_equal(inner, right >= 0)
    assert np.array_equal(np.sort(np.concatenate([left[inner], right[inner]])), np.arange(1, m))
    assert set(np.unique(axis[inner]).tolist()) <= {0, 1, 2} and not nodes_box[:, 6:8].any()
    bvh = port_bvh.build_bvh_over_triangles(v, n, uv, mat, device="cpu")[1]
    want_hit, want_miss = _plain_threading(left, right, axis)
    assert np.array_equal(bvh.hit_link.numpy(), want_hit) and np.array_equal(bvh.miss_link.numpy(), want_miss)


def test_walk_wrapper_raises_on_a_device_without_a_kernel():
    before = launch_counts()
    (_, _), (_, got) = _both(7, seed=1)
    meta = lambda: torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bt.bvh_walk(got, Vec3(meta(), meta(), meta()), Vec3(meta(), meta(), meta()), meta(), any_hit=False)
    assert launch_counts() == before  # CPU tensors take the twin and launch nothing
