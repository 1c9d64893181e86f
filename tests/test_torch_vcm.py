"""VCM of the port against the JAX package's.

The scene is the Cornell box shifted off the photon grid
(``tools/torch_check_integrators.py::shifted_cornell``), built by the
reference and carried across.  On the unshifted box the walls lie exactly
on cell boundaries (cell 0.1 at the default radius), so a photon's last-bit
position difference between XLA:CPU (which fuses multiply-adds) and the
port moves it into the neighbouring cell, and a query then keeps another
``max_per_cell`` of an overfull cell's run: a different estimate, not a
rounding difference.  ``test_grid_aligned_walls_move_photons_across_cells``
pins that: every photon whose cell differs between the packages sits within
2e-5 cells of a boundary.

Held (stated tolerances; measured worst in brackets):
- the light phase's stacked vertices (32^2 paths, ten bounces): ``valid``
  and ``path_length`` equal, positions within atol 1e-4 on valid lanes, the
  throughput and the MIS quantities within rtol 1e-3 / atol 1e-7
  (bounce-to-bounce rounding compounds; one d_vc of 4,393 at 1.2e-3
  relative, 1.2e-8 absolute);
- ``render_pass_vcm`` at ``pass_idx`` 0 and 1 (VM is off at pass 0), with
  vertex connection only, merging only, and both (16^2, max path length
  4): every film value within rtol 1e-4 / atol 1e-6 (2.7e-6 absolute) but
  at one pixel of the passes with connections at pass 0, pinned in
  ``APART`` (a contribution the reference drops at a camera hit an ulp
  away);
- one pass (pass 1) on the 2k-triangle bench mesh under wave2 with the
  reference's Pallas kernel in interpret mode at K = 8, same tolerance
  (8.6e-6 absolute, 1.0e-5 relative);
- ``axis_name``, a process group of one rank, gives the plain pass bit for
  bit.
"""

import os
import sys
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators import vcm as ref_vcm
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.io.scene_loader import load_scene as ref_load_scene
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.ops import traverse as ref_traverse
from raytracer_tpu.render.film import make_film as ref_make_film
from raytracer_tpu.render.renderer import ViewportParams as RefViewportParams
from raytracer_tpu.sampler.sampler import make_stream as ref_make_stream
from raytracer_tpu.scene import build as ref_build
from raytracer_tpu.scene import clusters as ref_clusters
from raytracer_tpu.scene import types as RT
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import cornell_box as ref_cornell_box, cornell_camera_kw
from raytracer_tpu_torch.integrators import vcm
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.render.film import make_film
from raytracer_tpu_torch.render.renderer import ViewportParams
from raytracer_tpu_torch.sampler.sampler import make_stream
from raytracer_tpu_torch.scene.convert import scene_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import bench_mesh  # noqa: E402
import torch_check_integrators as tci  # noqa: E402

SIZE, LENGTH = 16, 4
FILM_RTOL, FILM_ATOL = 1e-4, 1e-6
# pixel (10, 4) at pass 0: its camera hit lies 4.8e-7 nearer in the port
# (XLA fuses the multiply-add of o + t d); one connection term there that
# the reference drops is kept (1.1e-4 in each channel where the reference
# has 0).  Every other pixel is within the tolerance.
APART = {("vc", 0): [(10, 4)], ("both", 0): [(10, 4)]}
CONFIGS = {"vc": dict(use_vertex_merging=False), "vm": dict(use_vertex_connection=False), "both": {}}


def carry(x):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")


def both(shifted=True):
    if shifted:
        b, t_kw, c_kw = tci.shifted_cornell(ref_build, RefRigidTransform, RT)
        scene, meta = b.build()
    else:
        scene, meta = ref_cornell_box()
        t_kw, c_kw = cornell_camera_kw()
    cam = ref_make_camera(RefRigidTransform(**t_kw), **c_kw)
    return (scene, meta, cam), (carry(scene), meta, carry(cam))


@pytest.fixture(scope="module")
def ref_passes():
    """The reference's pass at pass_idx 0 and 1 for each config, one jit
    compile a config: {(config, pass_idx): film sum}."""
    (rs, rm, rc), _ = both()
    vp = RefViewportParams(SIZE, SIZE, seed=0)
    out = {}
    for name, kw in CONFIGS.items():
        v = ref_vcm.VcmParams(max_path_length=LENGTH, **kw)
        fn = jax.jit(lambda s, c, f, p, v=v: ref_vcm.render_pass_vcm(s, rm, c, f, p, None, vp,
                                                                     RefRenderParams(max_depth=LENGTH), v))
        for p in (0, 1):
            out[name, p] = np.asarray(fn(rs, rc, ref_make_film(SIZE, SIZE), jnp.int32(p)).sum)
    return out


@pytest.mark.parametrize("pass_idx", [0, 1])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_vcm_pass_matches_reference(ref_passes, config, pass_idx):
    _, (ps, pm, pc) = both()
    got = vcm.render_pass_vcm(ps, pm, pc, make_film(SIZE, SIZE, "cpu"), pass_idx, None, ViewportParams(SIZE, SIZE, seed=0),
                              RenderParams(max_depth=LENGTH), vcm.VcmParams(max_path_length=LENGTH, **CONFIGS[config]))
    assert got.num_passes == 1
    b, a = got.sum.numpy(), ref_passes[config, pass_idx]
    assert np.isfinite(b).all() and b.mean() > 0
    apart = ~np.isclose(b, a, rtol=FILM_RTOL, atol=FILM_ATOL).all(-1)
    assert [tuple(int(i) for i in j) for j in zip(*np.nonzero(apart))] == APART.get((config, pass_idx), [])
    for y, x in APART.get((config, pass_idx), []):
        assert (a[y, x] == 0).all() and np.allclose(b[y, x], 1.1453e-4, rtol=1e-3)


def test_vm_is_held_back_one_pass(ref_passes):
    """Merging adds nothing at pass 0 and something at pass 1, in both."""
    assert ref_passes["vm", 1].sum() > ref_passes["vm", 0].sum()
    _, (ps, pm, pc) = both()
    run = lambda p: vcm.render_pass_vcm(ps, pm, pc, make_film(SIZE, SIZE, "cpu"), p, None,
                                        ViewportParams(SIZE, SIZE, seed=0), RenderParams(max_depth=LENGTH),
                                        vcm.VcmParams(max_path_length=LENGTH, use_vertex_connection=False)).sum
    merged0, merged1 = run(0), run(1)
    assert float(merged1.sum()) > float(merged0.sum())


def _light_phases(shifted, length=LENGTH, n=SIZE * SIZE):
    (rs, rm, rc), (ps, pm, pc) = both(shifted)
    v = ref_vcm.VcmParams(max_path_length=length)
    ref = ref_vcm._trace_light_phase(rs, rm, rc, ref_make_stream(jnp.arange(n, dtype=jnp.uint32), jnp.int32(1), seed=0x5EC),
                                     v, n, jnp.float32(0.1), jnp.float32(30.0))[0]
    got = vcm._trace_light_phase(ps, pm, pc, make_stream(torch.arange(n), 1, seed=0x5EC),
                                 vcm.VcmParams(max_path_length=length), n, torch.tensor(0.1), torch.tensor(30.0))[0]
    return ref, got


def test_light_phase_vertices_match_reference():
    ref, got = _light_phases(True, length=10, n=32 * 32)
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(got.path_length.numpy(), np.asarray(ref.path_length))
    assert valid[0].mean() > 0.5 and valid[-1].any()
    for a, b in zip(ref.position, got.position):
        np.testing.assert_allclose(b.numpy()[valid], np.asarray(a)[valid], atol=1e-4)
    for name in ("d_vc", "d_vm", "d_vcm"):
        np.testing.assert_allclose(getattr(got, name).numpy()[valid], np.asarray(getattr(ref, name))[valid], rtol=1e-3,
                                   atol=1e-7)
    for a, b in zip(ref.throughput, got.throughput):
        np.testing.assert_allclose(b.numpy()[valid], np.asarray(a)[valid], rtol=1e-3)


def test_grid_aligned_walls_move_photons_across_cells():
    """On the unshifted box, the photons whose grid cell differs between
    the packages are exactly those within 2e-5 cells of a boundary."""
    ref, got = _light_phases(False, length=10, n=32 * 32)
    valid = got.valid.numpy().reshape(-1)
    inv = 1.0 / (2 * np.float32(0.05))
    cells = []
    for pos in ([np.asarray(c).reshape(-1) for c in ref.position], [c.numpy().reshape(-1) for c in got.position]):
        cells.append(np.stack([np.floor(np.float32(c[valid]) * np.float32(inv)) for c in pos], 1))
    moved = (cells[0] != cells[1]).any(1)
    frac = np.stack([c.numpy().reshape(-1)[valid] * np.float32(inv) for c in got.position], 1)
    dist = np.abs(frac - np.round(frac))[moved]
    assert moved.sum() > 0
    assert (dist.min(1) < 2e-5).all()


def test_axis_name_waits(tmp_path):
    """``axis_name`` no longer waits: a ``torch.distributed`` group of one
    gloo rank sums the splat frame and gathers the photons over itself, and
    the pass equals the plain pass bit for bit (groups of 2 and 4 ranks:
    ``tests/test_torch_parallel.py``)."""
    import torch.distributed as dist

    _, (ps, pm, pc) = both()
    args = (ps, pm, pc, make_film(SIZE, SIZE, "cpu"), 1, None, ViewportParams(SIZE, SIZE, seed=0),
            RenderParams(max_depth=LENGTH), vcm.VcmParams(max_path_length=LENGTH))
    plain = vcm.render_pass_vcm(*args)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        banded = vcm.render_pass_vcm(*args, rows=SIZE, row0=0, axis_name=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert banded.num_passes == plain.num_passes == 1
    assert torch.equal(banded.sum, plain.sum) and float(plain.sum.mean()) > 0


@pytest.fixture
def restore_modes(monkeypatch):
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    yield
    traverse.set_traversal_mode("auto")
    ref_traverse.set_traversal_mode("auto")
    jax.clear_caches()


def test_vcm_pass_matches_reference_on_a_mesh_under_wave2(restore_modes, tmp_path, monkeypatch):
    monkeypatch.setattr(bench_mesh, "BENCH_DIR", str(tmp_path))
    with mock.patch.object(ref_clusters, "build_clusters", partial(ref_clusters.build_clusters, k=8)):
        rs, rm, rc = ref_load_scene(bench_mesh.ensure_scene(2000))
    ps, pc = carry(rs), carry(rc)
    jax.clear_caches()
    ref_traverse.set_traversal_mode("wave2")
    size, length = 12, 3
    v = ref_vcm.VcmParams(max_path_length=length)
    a = jax.jit(lambda s, c, f: ref_vcm.render_pass_vcm(s, rm, c, f, jnp.int32(1), None, RefViewportParams(size, size),
                                                         RefRenderParams(max_depth=length), v))(
        rs, rc, ref_make_film(size, size))
    b = vcm.render_pass_vcm(ps, rm, pc, make_film(size, size, "cpu"), 1, None, ViewportParams(size, size),
                            RenderParams(max_depth=length), vcm.VcmParams(max_path_length=length))
    assert np.isfinite(b.sum.numpy()).all() and float(b.sum.mean()) > 0
    np.testing.assert_allclose(b.sum.numpy(), np.asarray(a.sum), rtol=FILM_RTOL, atol=FILM_ATOL)
