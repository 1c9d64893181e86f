"""Port parity of wave2's front-to-back extraction and its other settings
(``RT_WAVE2_FTB`` / ``KC``, ``CHUNK``, ``SPATIAL_KEY``, ``SKIP_KERNEL``)
against the JAX package, which runs its Pallas kernel in interpret mode on
the CPU; the port runs its kernel's plain twin.

One 2k-triangle mesh clustered at K = 8 and 2,048 rays (coherent and
incoherent, a third of them any-hit lanes, some with no work), built once.
Tolerances: the extraction's candidates, next entry distances and last keys
bit-equal; a round's integer outputs equal and t within the ``_mt_kernel``
tolerance of ``tests/test_torch_wave2.py`` (rtol = atol = 1e-5; XLA:CPU
contracts multiply-adds); whole traces: tri ids equal on >= 99.9% of rays,
any disagreement a tie within |dt| <= 1e-4, occlusion and overflow exact.
Within the port, the front-to-back trace and the id-order one, and the
traces at ``CHUNK`` = 256 and 1,024, give bit-equal t.
"""

import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_one_thread  # noqa: F401  (one torch thread per worker)
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import wave2_traverse as ref_w2
from raytracer_tpu.scene.clusters import build_clusters as ref_build_clusters
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import wave2_traverse as w2
from raytracer_tpu_torch.scene.clusters import build_clusters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from traversal_bench import coherent_rays, incoherent_rays, make_mesh  # noqa: E402

K = 8
N_RAYS = 2048
KC_FTB = 4


def make_case(seed=7, n_rays=N_RAYS):
    """(v0, e1, e2) of a 2k-triangle mesh and (o, d, tm) of ``n_rays`` rays
    as float32 numpy arrays: mixed-sign limits, negative lanes are any-hit
    queries, zero lanes have no work."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = make_mesh(2000, rng)
    oc, dc = coherent_rays(n_rays // 2, rng)
    oi, di = incoherent_rays(n_rays // 2, rng)
    cat = lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]).astype(np.float32)
    o = [cat(oc[i], oi[i]) for i in range(3)]
    d = [cat(dc[i], di[i]) for i in range(3)]
    u = rng.random(n_rays)
    tm = np.where(u < 0.3, -rng.uniform(1.0, 20.0, n_rays), 3.0e38).astype(np.float32)
    tm[u > 0.95] = 0.0
    return (v0, e1, e2), o, d, tm


@pytest.fixture(scope="module")
def case():
    mesh, o, d, tm = make_case()
    return dict(ref_cs=ref_build_clusters(*mesh, k=K), cs=build_clusters(*mesh, k=K, device="cpu"),
                o=o, d=d, tm=tm)


def _ref_rays(c):
    return RefVec3(*map(jnp.asarray, c["o"])), RefVec3(*map(jnp.asarray, c["d"]))


def _rays(c):
    return Vec3(*map(torch.as_tensor, c["o"])), Vec3(*map(torch.as_tensor, c["d"]))


def _flat(c):
    return [jnp.asarray(a) for a in (*c["o"], *c["d"])], [torch.as_tensor(a) for a in (*c["o"], *c["d"])]


def _bits(a):
    return np.asarray(a).view(np.int32)


# --- the front-to-back extraction -------------------------------------------


def test_id_bits_and_defaults_match_the_reference(monkeypatch):
    for cs in (1, 2, 7, 8, 255, 256, 1563, 3121):
        assert w2._id_bits(cs) == ref_w2._id_bits(cs)
    for env in ({}, {"RT_WAVE2_FTB": "1"}, {"RT_WAVE2_KC": "6"}, {"RT_WAVE2_FTB": "1", "RT_WAVE2_KC": "6"},
                {"RT_WAVE2_FTB": "0"}):
        for name in ("RT_WAVE2_FTB", "RT_WAVE2_KC"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        assert w2._ftb_default() == ref_w2._ftb_default()
        for ftb in (False, True):
            assert w2._kc_default(ftb) == ref_w2._kc_default(ftb)


def test_p1_extract_ftb_bit_equal_with_a_resumed_cursor_and_any_hit_lanes(case):
    """``cand``, ``next_t`` and ``last`` bit-equal from the start (cursor -1),
    from the first call's last keys (a resumed cursor) and from a third
    cursor; a third of the lanes are any-hit (tl < 0), some have tl = 0."""
    ref_rays, rays = _flat(case)
    tl = case["tm"]
    cur = np.full(N_RAYS, -1, np.int32)
    emitted = 0
    for step in range(3):
        ref = ref_w2._p1_extract_ftb(case["ref_cs"], *ref_rays, jnp.asarray(tl), jnp.asarray(cur), KC_FTB)
        got = w2._p1_extract_ftb(case["cs"], *rays, torch.as_tensor(tl), torch.as_tensor(cur), KC_FTB)
        for name, a, b in zip(("cand", "next_t", "last"), ref, got):
            assert np.array_equal(_bits(a), _bits(b.numpy())), (step, name)
        emitted += int((got[0] < case["cs"].num_supers).sum())
        cur = got[2].numpy()
    assert emitted > N_RAYS  # the rays really overlap several supers, across the resumed calls
    assert np.isfinite(got[1].numpy()).any() and np.isinf(got[1].numpy()).any()


def test_p1_extract_ftb_orders_candidates_nearest_first(case):
    """Within the port: with room for every super, the front-to-back
    candidates are the id-order extraction's set, reordered, and no next
    candidate is left."""
    _, rays = _flat(case)
    tl = torch.as_tensor(case["tm"])
    cur = torch.full((N_RAYS,), -1, dtype=torch.int32)
    cs = case["cs"].num_supers
    kc = cs  # all of them: the two orders must name the same set
    cand_f, next_t, _ = w2._p1_extract_ftb(case["cs"], *rays, tl, cur, kc)
    cand_i, _ = w2._p1_extract(case["cs"], *rays, tl, cur, kc)
    assert torch.equal(torch.sort(cand_f, 1).values, cand_i)
    assert bool(torch.isinf(next_t).all())


def _capture_ref_round(cs_set, rays, tl, cursor, kc, any_hit=False, ftb=False):
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
        out = ref_w2._round.__wrapped__(cs_set, *rays, tl, cursor, kc, 1, any_hit, ftb)
    return [np.asarray(x) for x in out if not isinstance(x, tuple)], sorts, calls


def _round_both(case, tl, cursor, kc, any_hit=False, ftb=False):
    ref_rays, rays = _flat(case)
    ref_out, sorts, calls = _capture_ref_round(case["ref_cs"], ref_rays, jnp.asarray(tl), jnp.asarray(cursor),
                                               kc, any_hit, ftb)
    got = w2._round(case["cs"], *rays, torch.as_tensor(tl), torch.as_tensor(cursor), kc, any_hit, ftb)
    return ref_out, [x.numpy() for x in got], sorts, calls


def test_round_ftb_matches_the_reference(case):
    """``_round(ftb=True)`` from a fresh and from a resumed cursor: tri, the
    new cursor and the unresolved flags equal, t (and u, v) within the
    ``_mt_kernel`` tolerance."""
    tl = case["tm"]
    cursor = np.full(N_RAYS, -1, np.int32)
    for step in range(2):
        (rt, rtri, ru, rv, rcur, runres), (t, tri, u, v, cur, unres), _, _ = _round_both(
            case, tl, cursor, KC_FTB, ftb=True)
        assert np.array_equal(tri, rtri), step
        assert np.array_equal(cur, rcur) and np.array_equal(unres, runres), step
        np.testing.assert_allclose(t, rt, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(u, ru, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(v, rv, rtol=1e-5, atol=1e-4)
        assert unres.any() and (tri >= 0).any()
        cursor = cur


def test_key_shift_zero_under_spatial_key_0(case, monkeypatch):
    """``RT_WAVE2_SPATIAL_KEY=0``: the pair key is the super id alone (no
    octant, no Morton), in both packages; the sorts, the chunk table and the
    pairs the kernel sees equal the reference's."""
    monkeypatch.setenv("RT_WAVE2_SPATIAL_KEY", "0")
    ref_rays, rays = _flat(case)
    tl, kc = case["tm"], 16
    cursor = np.full(N_RAYS, -1, np.int32)
    cand, _ = w2._p1_extract(case["cs"], *rays, torch.as_tensor(tl), torch.as_tensor(cursor), kc)
    _, sorts, calls = _capture_ref_round(case["ref_cs"], ref_rays, jnp.asarray(tl), jnp.asarray(cursor), kc)
    join = w2._pair_join(case["cs"], cand, *rays, torch.as_tensor(tl))
    p = N_RAYS * kc
    assert np.array_equal(sorts[0][0][:p], np.sort(cand.numpy().reshape(-1)))  # key == super id
    assert np.array_equal(join.sidx.numpy(), sorts[0][1])
    assert np.array_equal(join.fidx.numpy(), sorts[1][1])
    assert np.array_equal(join.block_cluster.numpy(), calls[0][0])
    for got, want in zip(join.pairs, calls[0][3:]):
        assert np.array_equal(got.numpy(), want)
    monkeypatch.delenv("RT_WAVE2_SPATIAL_KEY")
    spatial = w2._pair_join(case["cs"], cand, *rays, torch.as_tensor(tl))
    assert not torch.equal(spatial.sidx, join.sidx)  # the default key does sort otherwise


def test_skip_kernel_stand_in_outputs(case, monkeypatch):
    """``RT_WAVE2_SKIP_KERNEL``: the sort-join runs, the kernel does not, and
    every chunk reports "processed, no hit", as in the reference."""
    monkeypatch.setenv("RT_WAVE2_SKIP_KERNEL", "1")
    tl = case["tm"]
    cursor = np.full(N_RAYS, -1, np.int32)
    with mock.patch.object(w2, "mt_chunks", side_effect=AssertionError("the kernel ran")):
        for ftb, kc in ((False, 16), (True, KC_FTB)):
            ref_out, got, sorts, calls = _round_both(case, tl, cursor, kc, ftb=ftb)
            assert not calls and len(sorts) == 3  # the three sorts, no Pallas call
            for a, b in zip(ref_out, got):
                assert np.array_equal(_bits(a), _bits(b))
            t, tri, u, v = got[:4]
            assert np.array_equal(t, np.abs(tl)) and (tri == -1).all() and (u == 0).all() and (v == 0).all()


# --- whole traces --------------------------------------------------------------


@pytest.fixture(scope="module")
def ftb_closest(case):
    with mock.patch.dict(os.environ, {"RT_WAVE2_FTB": "1"}):  # the reference reads it at each call
        ref = ref_w2.wave2_closest_hit(case["ref_cs"], *_ref_rays(case), jnp.asarray(case["tm"]), kc=KC_FTB)
    got = w2.wave2_closest_hit(case["cs"], *_rays(case), torch.as_tensor(case["tm"]), kc=KC_FTB, ftb=True)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_closest_hit_ftb_matches_the_reference(ftb_closest):
    (rt, rtri, ru, rv, rovf), (t, tri, u, v, ovf) = ftb_closest
    same = rtri == tri
    assert same.mean() >= 0.999, same.mean()
    assert np.all(np.abs(rt[~same] - t[~same]) <= 1e-4)  # disagreements are ties
    hit = same & (tri >= 0)
    assert hit.sum() > 200
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u[same], ru[same], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(v[same], rv[same], rtol=1e-5, atol=1e-4)
    assert np.array_equal(t[tri < 0], rt[rtri < 0])  # misses report BIG
    assert not rovf.any() and not ovf.any()


def test_public_closest_hit_reads_the_environment(case, ftb_closest, monkeypatch):
    """``RT_WAVE2_FTB=1`` (kc defaults to 4) gives the explicit call's answer."""
    monkeypatch.setenv("RT_WAVE2_FTB", "1")
    w2.reset_stats()
    got = w2.wave2_closest_hit(case["cs"], *_rays(case), torch.as_tensor(case["tm"]))
    for a, b in zip(got, ftb_closest[1]):
        assert np.array_equal(_bits(a.numpy()), _bits(b))
    assert w2.STATS["pair_slots"] >= N_RAYS * KC_FTB and w2.STATS["rounds"] >= 2
    assert w2.STATS["host_syncs"] == 1 + w2.STATS["windows"] + w2.STATS["continuations"]


def test_ftb_and_id_order_give_the_same_t_in_the_port(case, ftb_closest):
    """The two extraction orders visit the same triangles: t bit-equal on
    every ray, tri ids equal but where t ties (a later round replaces a hit
    only at a strictly smaller t, so a tie across rounds keeps its first)."""
    idord = [x.numpy() for x in w2.wave2_closest_hit(case["cs"], *_rays(case), torch.as_tensor(case["tm"]),
                                                    kc=16, ftb=False)]
    t, tri = ftb_closest[1][:2]
    assert np.array_equal(_bits(t), _bits(idord[0]))
    apart = tri != idord[1]
    # each side's tri id is a hit at the same t: a tie, kept as the reference keeps it
    assert (tri[apart] >= 0).all() and (idord[1][apart] >= 0).all() and apart.mean() < 0.01
    ftb6 = w2.wave2_closest_hit(case["cs"], *_rays(case), torch.as_tensor(case["tm"]), kc=6, ftb=True)
    assert np.array_equal(_bits(ftb6[0].numpy()), _bits(t))


def test_any_hit_ftb_matches_the_reference(case):
    lim = np.abs(case["tm"])
    with mock.patch.dict(os.environ, {"RT_WAVE2_FTB": "1"}):
        ref_occ, ref_ovf = ref_w2.wave2_any_hit(case["ref_cs"], *_ref_rays(case), jnp.asarray(lim), kc=KC_FTB)
    occ, ovf = w2.wave2_any_hit(case["cs"], *_rays(case), torch.as_tensor(lim), kc=KC_FTB, ftb=True)
    assert np.array_equal(occ.numpy(), np.asarray(ref_occ))
    assert occ.numpy().mean() > 0.05
    assert not np.asarray(ref_ovf).any() and not ovf.numpy().any()
    occ_id, _ = w2.wave2_any_hit(case["cs"], *_rays(case), torch.as_tensor(lim), kc=16, ftb=False)
    assert torch.equal(occ, occ_id)


# --- the chunk size ----------------------------------------------------------------


def test_twin_at_two_rows_equals_it_at_eight(case):
    """``mt_chunks_reference`` on the same pairs cut into chunks of 2 rows
    (``CHUNK`` = 256) and of 8 (1,024): equal outputs."""
    ref_rays, rays = _flat(case)
    tl = torch.as_tensor(case["tm"])
    cand, _ = w2._p1_extract(case["cs"], *rays, tl, torch.full((N_RAYS,), -1, dtype=torch.int32), 16)
    join = w2._pair_join(case["cs"], cand, *rays, tl)
    b2 = join.block_cluster.shape[0]
    cs = case["cs"]
    for any_hit in (False, True):
        eight = w2.mt_chunks_reference(join.block_cluster, cs.super_geom, cs.super_sbox, *join.pairs, any_hit)
        two = w2.mt_chunks_reference(join.block_cluster.repeat_interleave(4), cs.super_geom, cs.super_sbox,
                                     *(p.reshape(4 * b2, 2, 128) for p in join.pairs), any_hit)
        for a, b in zip(eight, two):
            assert torch.equal(a.reshape(-1), b.reshape(-1))
        assert (eight[1] >= 0).any()


def test_chunk_256_in_a_child_process(case, tmp_path):
    """``RT_WAVE2_CHUNK=256`` (read at import): in a child process both
    packages trace the case, closest-hit id order and front to back, and
    any-hit; the child's port hits are bit-equal to this process's at
    ``CHUNK`` = 1,024, and its JAX hits agree with its port's."""
    out = tmp_path / "chunk256.npz"
    env = dict(os.environ, RT_WAVE2_CHUNK="256", PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_wave2_chunk_worker.py"), str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    child = np.load(out)
    assert int(child["chunk"]) == 256 and int(child["rows"]) == 2
    assert w2.CHUNK == 1024  # this process keeps the default
    tm = torch.as_tensor(case["tm"])
    for mode, kc, ftb in (("id", 16, False), ("ftb", KC_FTB, True)):
        here = w2.wave2_closest_hit(case["cs"], *_rays(case), tm, kc=kc, ftb=ftb)
        for i, name in enumerate(("t", "tri", "u", "v", "ovf")):
            assert np.array_equal(_bits(child[f"port_{mode}_{name}"]), _bits(here[i].numpy())), (mode, name)
        same = child[f"port_{mode}_tri"] == child[f"ref_{mode}_tri"]
        assert same.mean() >= 0.999
        np.testing.assert_allclose(child[f"port_{mode}_t"][same], child[f"ref_{mode}_t"][same], rtol=1e-5, atol=1e-5)
    occ, _ = w2.wave2_any_hit(case["cs"], *_rays(case), tm.abs(), kc=KC_FTB, ftb=True)
    assert np.array_equal(child["port_any"], occ.numpy()) and np.array_equal(child["ref_any"], occ.numpy())


# --- the slice under front to back ----------------------------------------------------


@pytest.fixture
def restore_modes(monkeypatch):
    """Both packages back to 'auto' afterwards; the JAX package reads its
    mode and ``RT_WAVE2_FTB`` while it traces, so its compiled renders are
    dropped too."""
    from raytracer_tpu.ops import traverse as ref_traverse
    from raytracer_tpu_torch.ops import traverse

    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    jax.clear_caches()
    yield ref_traverse, traverse
    traverse.set_traversal_mode("auto")
    ref_traverse.set_traversal_mode("auto")
    jax.clear_caches()


def test_render_under_ftb_matches_the_references(restore_modes, tmp_path, monkeypatch):
    """32^2, depth 6, MIS render of the 2k-triangle bench mesh (clusters at
    K = 8, the reference's tables carried across) with ``RT_WAVE2_FTB=1``
    in both packages, the reference under ``wave2`` with its kernel in
    interpret mode: the render tolerances of ``tests/test_torch_render.py``
    (>= 99.5% of pixels within atol 1e-4 / rtol 1e-3, counters and mean
    within 0.1%), overflow 0 in both."""
    from functools import partial

    import bench_mesh
    from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
    from raytracer_tpu.io.scene_loader import load_scene as ref_load_scene
    from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
    from raytracer_tpu.scene import clusters as ref_clusters
    from raytracer_tpu_torch.integrators.path_tracer import RenderParams
    from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
    from raytracer_tpu_torch.scene.convert import scene_from_numpy

    ref_traverse, traverse = restore_modes
    monkeypatch.setattr(bench_mesh, "BENCH_DIR", str(tmp_path))
    with mock.patch.object(ref_clusters, "build_clusters", partial(ref_clusters.build_clusters, k=K)):
        ref = ref_load_scene(bench_mesh.ensure_scene(2000))
    got = tuple(scene_from_numpy(x if i == 1 else jax.tree_util.tree_map(np.asarray, x), "cpu")
                for i, x in enumerate(ref))
    assert got[0].clusters.tris_per_cluster == K
    monkeypatch.setenv("RT_WAVE2_FTB", "1")
    ref_traverse.set_traversal_mode("wave2")
    rv = RefViewport(*ref, RefViewportParams(32, 32, seed=0), RefRenderParams(max_depth=6, mis=True))
    a = rv.render(1).radiance()
    w2.reset_stats()
    pv = Viewport(*got, ViewportParams(32, 32, seed=0), RenderParams(max_depth=6, mis=True), device="cpu")
    b = pv.render(1).radiance()
    assert w2.STATS["pair_slots"] > 0 and w2.STATS["pair_slots"] % KC_FTB == 0  # kc 4 throughout
    assert np.isfinite(b).all() and b.mean() > 0
    rp, pp = rv.progress(), pv.progress()
    for key in ("total_rays", "total_shadow_rays"):
        assert abs(pp[key] - rp[key]) <= 1e-3 * rp[key], (key, pp[key], rp[key])
    assert pp["total_traversal_overflow"] == rp["total_traversal_overflow"] == 0
    close = np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(b.mean() - a.mean()) <= 1e-3 * abs(a.mean())
