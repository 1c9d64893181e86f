"""One rank of a CPU ``torch.distributed`` gloo group, for
``tests/test_torch_parallel.py``.

    python tests/torch_dist_worker.py RANK WORLD INIT_FILE SCENES OUT

``SCENES`` is a ``torch.save`` of {"cornell": (scene, meta, cam),
"shifted": (scene, meta, cam)}, the port's types on the CPU, which the test
carried across from the JAX package.  The rank joins the group at
``file://INIT_FILE`` and, on the port's ``parallel/mesh.py``: renders two
passes of the Cornell box through ``render_pass_sharded`` on a 1-D mesh and
gathers the film; one VCM pass of the shifted box through
``render_pass_vcm_sharded``; one ``train_step_sharded``; and, where the
world is even, two passes on a ``("hosts", "chips")`` mesh of two ranks a
host.  It writes what it got to ``OUT/rank<RANK>.npz`` and prints
``RANK_OK``.  It imports torch, numpy and the port only.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

torch.set_num_threads(1)

W, H = 16, 32
DEPTH = 3


def main():
    rank, world, init_file, scenes_path, out_dir = (int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
    from raytracer_tpu_torch.integrators.path_tracer import RenderParams
    from raytracer_tpu_torch.integrators.vcm import VcmParams
    from raytracer_tpu_torch.parallel import mesh as pm
    from raytracer_tpu_torch.render.film import make_film
    from raytracer_tpu_torch.render.renderer import ViewportParams

    pm.init_distributed(f"file://{init_file}", world, rank, "gloo")
    scenes = torch.load(scenes_path, weights_only=False)
    scene, meta, cam = scenes["cornell"]
    vp, params = ViewportParams(W, H, seed=0), RenderParams(max_depth=DEPTH, mis=True)
    out = {}

    def two_passes(mesh):
        film = pm.film_sharding(make_film(W, H, "cpu"), mesh)
        total = None
        for p in range(2):
            film, counters = pm.render_pass_sharded(scene, meta, cam, film, p, None, vp, params, mesh)
            total = counters if total is None else type(counters)(*(a + b for a, b in zip(total, counters)))
        return film, total

    mesh = pm.make_mesh()
    band, counters = two_passes(mesh)
    whole = pm.gather_film(band, mesh)
    out.update(band_sum=band.sum.numpy(), band_secondary=band.secondary_sum.numpy(), film_sum=whole.sum.numpy(),
               film_secondary=whole.secondary_sum.numpy(), num_passes=whole.num_passes,
               counters=np.array([float(c) for c in counters]), flat_index=pm._flat_index(mesh))

    s_scene, s_meta, s_cam = scenes["shifted"]
    vcm_band = pm.render_pass_vcm_sharded(s_scene, s_meta, s_cam, pm.film_sharding(make_film(W, H, "cpu"), mesh), 0,
                                          vp, params, mesh, vcm=VcmParams(max_path_length=DEPTH))
    out["vcm_sum"] = pm.gather_film(vcm_band, mesh).sum.numpy()

    target = torch.full((H, W, 3), 0.25)
    loss, grads = pm.train_step_sharded(scene, meta, cam, target, 1, vp, params, mesh)
    out["loss"] = float(loss)
    out["grads"] = np.stack([g.numpy() for g in (*grads[0], *grads[1], grads[2])])

    if world % 2 == 0:
        os.environ["LOCAL_WORLD_SIZE"] = "2"  # two ranks a host, as a launcher would say
        hc = pm.make_multihost_mesh()
        out["hc_shape"] = np.array([hc.size(0), hc.size(1)])
        out["hc_sum"] = pm.gather_film(two_passes(hc)[0], hc).sum.numpy()

    out["host_bytes"] = pm.STATS.host_bytes
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    main()
