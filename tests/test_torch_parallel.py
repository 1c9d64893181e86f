"""Multi-device rendering of the port (``parallel/mesh.py``, VCM's band
mode) in real ``torch.distributed`` gloo groups of 1, 2 and 4 CPU
processes, spawned from the test (``tests/torch_dist_worker.py``), against
the port's one-device functions and the JAX package's sharded VCM.

The scenes are the Cornell box and the box shifted off the photon grid
(``tools/torch_check_integrators.py::shifted_cornell``), built by the JAX
package and carried across; 16 x 32 (two bands of 16 rows, four of 8),
depth 3, MIS.  Each group meets at a ``file://`` in the test's own
temporary directory, so xdist workers never share a port, and every spawn
has a timeout, so a hung rendezvous fails the test.

Held (stated tolerances):
- the gathered film of 2 and 4 ranks, and every rank's band, bit-equal to
  the 1-rank film and to the port's one-device film, 2 passes; the summed
  counters equal on every rank;
- the 2-rank VCM pass against the JAX package's ``render_pass_vcm_sharded``
  on a 2-device mesh (the same photon order) within ``test_torch_vcm.py``'s
  film tolerance, rtol 1e-4 / atol 1e-6; every group's VCM pass against
  the port's one-device pass within the reference's bound for sharded
  against one-device VCM, rtol 2e-4 / atol 2e-5 (``tests/test_parallel.py``),
  and the 1-rank pass bit-equal to it;
- ``train_step_sharded`` against ``train_step``: the loss within rtol 1e-5,
  the gradients within rtol 2e-4 / atol 1e-6 (``tests/test_parallel.py``),
  bit-equal in a group of one;
- a ``("hosts", "chips")`` mesh of two ranks a host renders the film of the
  1-D mesh bit for bit (``tests/test_multihost.py``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.integrators.vcm import VcmParams as RefVcmParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.parallel import mesh as ref_mesh
from raytracer_tpu.render.film import make_film as ref_make_film
from raytracer_tpu.render.renderer import ViewportParams as RefViewportParams
from raytracer_tpu.scene import build as ref_build
from raytracer_tpu.scene import types as RT
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import cornell_box as ref_cornell_box, cornell_camera_kw
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.integrators.vcm import VcmParams, render_pass_vcm
from raytracer_tpu_torch.parallel import mesh as pm
from raytracer_tpu_torch.render.film import make_film
from raytracer_tpu_torch.render.renderer import ViewportParams, render_passes
from raytracer_tpu_torch.scene.convert import scene_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_check_integrators as tci  # noqa: E402

W, H, DEPTH = 16, 32, 3
WORLDS = (1, 2, 4)
SPAWN_TIMEOUT_S = 300
VP, PARAMS = ViewportParams(W, H, seed=0), RenderParams(max_depth=DEPTH, mis=True)


def carry(x):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")


def unsharded(scene, meta, cam):
    """The port's one-device film and counters of passes 0 and 1 (no
    Halton vector, as the workers render)."""
    return render_passes(scene, meta, cam, make_film(W, H, "cpu"), 0, None, VP, PARAMS, 2)


def ref_scenes():
    """{"cornell": ..., "shifted": ...}: the JAX package's (scene, meta, cam)."""
    out = {}
    for name in ("cornell", "shifted"):
        if name == "shifted":
            b, t_kw, c_kw = tci.shifted_cornell(ref_build, RefRigidTransform, RT)
            scene, meta = b.build()
        else:
            scene, meta = ref_cornell_box()
            t_kw, c_kw = cornell_camera_kw()
        out[name] = (scene, meta, ref_make_camera(RefRigidTransform(**t_kw), **c_kw))
    return out


@pytest.fixture(scope="module")
def scenes():
    ref = ref_scenes()
    return ref, {k: (carry(s), m, carry(c)) for k, (s, m, c) in ref.items()}


@pytest.fixture(scope="module")
def groups(scenes, tmp_path_factory):
    """Spawn a gloo group of each size in ``WORLDS``, all at once; returns
    {world: [each rank's outputs]}."""
    root = tmp_path_factory.mktemp("dist")
    scenes_path = str(root / "scenes.pt")
    torch.save(scenes[1], scenes_path)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        out = root / f"world{world}"
        out.mkdir()
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"), str(rank), str(world),
             str(root / f"rendezvous{world}"), scenes_path, str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
    results, failed = {}, []
    for world, ranks in procs.items():
        for rank, p in enumerate(ranks):
            try:
                text, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in (q for r in procs.values() for q in r):
                    q.kill()
                pytest.fail(f"world {world} rank {rank} did not finish in {SPAWN_TIMEOUT_S} s")
            if p.returncode != 0 or "RANK_OK" not in text:
                failed.append(f"world {world} rank {rank} exit {p.returncode}:\n{text[-3000:]}")
        results[world] = [dict(np.load(root / f"world{world}" / f"rank{r}.npz")) for r in range(world)
                          if (root / f"world{world}" / f"rank{r}.npz").exists()]
    assert not failed, "\n".join(failed)
    return results


def test_worker_ranks_are_their_bands(groups):
    for world, ranks in groups.items():
        assert [int(r["flat_index"]) for r in ranks] == list(range(world))
        # CPU tensors: the gloo helpers copied nothing through the host
        assert all(int(r["host_bytes"]) == 0 for r in ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_n_rank_film_is_the_one_rank_film(groups, scenes, world):
    one = groups[1][0]
    film, _ = unsharded(*scenes[1]["cornell"])
    np.testing.assert_array_equal(one["film_sum"], film.sum.numpy())
    np.testing.assert_array_equal(one["film_secondary"], film.secondary_sum.numpy())
    rows = H // world
    for r, out in enumerate(groups[world]):
        assert int(out["num_passes"]) == 2
        np.testing.assert_array_equal(out["film_sum"], one["film_sum"])
        np.testing.assert_array_equal(out["film_secondary"], one["film_secondary"])
        np.testing.assert_array_equal(out["band_sum"], one["film_sum"][r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(out["band_secondary"], one["film_secondary"][r * rows:(r + 1) * rows])


@pytest.mark.parametrize("world", [2, 4])
def test_counters_are_the_whole_frame_on_every_rank(groups, scenes, world):
    _, counters = unsharded(*scenes[1]["cornell"])
    one = groups[1][0]["counters"]
    np.testing.assert_array_equal(one, [float(c) for c in counters])
    assert one[0] >= 2 * W * H
    for out in groups[world]:
        np.testing.assert_array_equal(out["counters"], one)


@pytest.fixture(scope="module")
def ref_vcm_two_devices(scenes):
    scene, meta, cam = scenes[0]["shifted"]
    mesh = ref_mesh.make_mesh(jax.devices()[:2])
    film = jax.device_put(ref_make_film(W, H), ref_mesh.film_sharding(mesh))
    # one compiled program (called eagerly, shard_map runs op by op)
    run = jax.jit(lambda s, c, f: ref_mesh.render_pass_vcm_sharded(
        scene=s, meta=meta, cam=c, film=f, pass_idx=jnp.int32(0), vp=RefViewportParams(W, H, seed=0),
        params=RefRenderParams(max_depth=DEPTH, mis=True), mesh=mesh, vcm=RefVcmParams(max_path_length=DEPTH)))
    film = run(scene, cam, film)
    return np.asarray(film.sum)


def test_two_rank_vcm_matches_the_reference_sharded_pass(groups, ref_vcm_two_devices):
    for out in groups[2]:
        got = out["vcm_sum"]
        assert np.isfinite(got).all() and got.mean() > 0
        np.testing.assert_allclose(got, ref_vcm_two_devices, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_vcm_matches_the_one_device_pass(groups, scenes, world):
    scene, meta, cam = scenes[1]["shifted"]
    one = render_pass_vcm(scene, meta, cam, make_film(W, H, "cpu"), 0, None, VP, PARAMS,
                          VcmParams(max_path_length=DEPTH)).sum.numpy()
    for out in groups[world]:
        if world == 1:
            np.testing.assert_array_equal(out["vcm_sum"], one)
        np.testing.assert_allclose(out["vcm_sum"], one, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_sharded_matches_train_step(groups, scenes, world):
    scene, meta, cam = scenes[1]["cornell"]
    loss, grads = pm.train_step(scene, meta, cam, torch.full((H, W, 3), 0.25), 1, VP, PARAMS)
    flat = np.stack([g.numpy() for g in (*grads[0], *grads[1], grads[2])])
    assert np.isfinite(flat).all() and np.abs(flat).max() > 0
    for out in groups[world]:
        if world == 1:
            assert out["loss"] == float(loss)
            np.testing.assert_array_equal(out["grads"], flat)
        np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(out["grads"], flat, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_hosts_chips_mesh_matches_flat(groups, world):
    for out in groups[world]:
        assert tuple(out["hc_shape"]) == (world // 2, 2)
        np.testing.assert_array_equal(out["hc_sum"], out["film_sum"])


def test_a_height_the_ranks_do_not_divide_is_an_error():
    class ThreeRanks:
        ndim = 1

        def size(self, dim=None):
            return 3

        def get_coordinate(self):
            return [1]

    assert pm._band(ThreeRanks(), 33) == (11, 11)
    with pytest.raises(ValueError, match="height 32 % devices 3"):
        pm._band(ThreeRanks(), 32)
