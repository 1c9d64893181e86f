"""Child process of ``tests/test_torch_wave2_config.py::
test_chunk_256_in_a_child_process``: both wave2 packages read
``RT_WAVE2_CHUNK`` at import, so a chunk size other than the default needs
a process of its own.

    RT_WAVE2_CHUNK=256 python tests/torch_wave2_chunk_worker.py OUT.npz

Traces the test's case (the 2k-triangle mesh at K = 8, 2,048 rays) with
both packages, closest-hit in id order (kc 16) and front to back (kc 4),
and any-hit front to back, and writes the hits to OUT.npz.
"""

import os
import sys
from unittest import mock

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from raytracer_tpu.math.vec import Vec3 as RefVec3  # noqa: E402
from raytracer_tpu.ops import wave2_traverse as ref_w2  # noqa: E402
from raytracer_tpu.scene.clusters import build_clusters as ref_build_clusters  # noqa: E402
from raytracer_tpu_torch.math.vec import Vec3  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.scene.clusters import build_clusters  # noqa: E402
from tests.test_torch_wave2_config import K, KC_FTB, make_case  # noqa: E402


def main(out):
    torch.set_num_threads(1)
    mesh, o, d, tm = make_case()
    ref_cs, cs = ref_build_clusters(*mesh, k=K), build_clusters(*mesh, k=K, device="cpu")
    ref_rays = RefVec3(*map(jnp.asarray, o)), RefVec3(*map(jnp.asarray, d))
    rays = Vec3(*map(torch.as_tensor, o)), Vec3(*map(torch.as_tensor, d))
    res = {"chunk": w2.CHUNK, "rows": w2.ROWS}
    assert ref_w2.CHUNK == w2.CHUNK
    for mode, kc, ftb in (("id", 16, False), ("ftb", KC_FTB, True)):
        got = w2.wave2_closest_hit(cs, *rays, torch.as_tensor(tm), kc=kc, ftb=ftb)
        with mock.patch.dict(os.environ, {"RT_WAVE2_FTB": "1" if ftb else "0"}):
            ref = ref_w2.wave2_closest_hit(ref_cs, *ref_rays, jnp.asarray(tm), kc=kc)
        for name, a, b in zip(("t", "tri", "u", "v", "ovf"), got, ref):
            res[f"port_{mode}_{name}"] = a.numpy()
            res[f"ref_{mode}_{name}"] = np.asarray(b)
    lim = np.abs(tm)
    res["port_any"] = w2.wave2_any_hit(cs, *rays, torch.as_tensor(lim), kc=KC_FTB, ftb=True)[0].numpy()
    with mock.patch.dict(os.environ, {"RT_WAVE2_FTB": "1"}):
        res["ref_any"] = np.asarray(ref_w2.wave2_any_hit(ref_cs, *ref_rays, jnp.asarray(lim), kc=KC_FTB)[0])
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1])
