"""The slice with textures as a whole: the port's Viewport against the JAX
Viewport on the small textured scene of ``tools/torch_gen_interior.py`` (two
meshes, a normal-mapped textured slab, textured props, a lat-long sky that
NEE importance-samples).

The reference renders under ``wave2`` with its Pallas kernel in interpret mode
(what it does on a CPU backend).  Its clusters are built at K = 8 instead of
the default 64, by a patch around its loader: the interpret-mode kernel
compiles in ~20 s at K = 8 and in minutes at K = 64, and the port renders on
the very same cluster set, carried across bit for bit.
"""

import os
import sys
from functools import partial
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.io.scene_loader import load_scene as ref_load_scene
from raytracer_tpu.ops import traverse as ref_traverse
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.scene import clusters as ref_clusters
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.io.scene_loader import load_scene
from raytracer_tpu_torch.ops import traverse
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.convert import scene_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import torch_gen_interior  # noqa: E402

SIZE = 32


@pytest.fixture
def restore_modes(monkeypatch):
    """Both packages back to 'auto' afterwards; the JAX package reads its
    mode while it traces, so its compiled renders are dropped too."""
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    yield
    traverse.set_traversal_mode("auto")
    ref_traverse.set_traversal_mode("auto")
    jax.clear_caches()


def _both(tmp_path):
    """(reference scene, meta, camera) at K = 8 and the same carried across."""
    path = torch_gen_interior.ensure_small_textured(str(tmp_path))
    with mock.patch.object(ref_clusters, "build_clusters", partial(ref_clusters.build_clusters, k=8)):
        ref = ref_load_scene(path, strict=True)
    got = tuple(scene_from_numpy(x if i == 1 else jax.tree_util.tree_map(np.asarray, x), "cpu")
                for i, x in enumerate(ref))
    return path, ref, got


def test_textured_viewport_matches_reference(restore_modes, tmp_path):
    """32^2, depth 4, MIS render of the small textured scene of
    ``tools/torch_gen_interior.py`` (two meshes, a normal-mapped textured
    slab, textured props, a lat-long sky that NEE importance-samples), the
    reference under ``wave2`` with its kernel in interpret mode, the port on
    the reference's tables carried across bit for bit.  Every pixel within
    atol 1e-4 / rtol 1e-3, ray and shadow-ray counts equal, overflow 0."""
    _, ref, got = _both(tmp_path)
    assert ref[0].textures is not None and ref[0].env_dist is not None
    assert got[0].clusters.tris_per_cluster == 8
    jax.clear_caches()
    ref_traverse.set_traversal_mode("wave2")
    rv = RefViewport(*ref, RefViewportParams(SIZE, SIZE, seed=0), RefRenderParams(max_depth=4, mis=True))
    a = rv.render(1).radiance()
    pv = Viewport(*got, ViewportParams(SIZE, SIZE, seed=0), RenderParams(max_depth=4, mis=True), device="cpu")
    b = pv.render(1).radiance()
    assert np.isfinite(b).all() and b.mean() > 0
    rp, pp = rv.progress(), pv.progress()
    assert pp["total_rays"] == rp["total_rays"] and pp["total_shadow_rays"] == rp["total_shadow_rays"] > 0
    assert pp["total_traversal_overflow"] == rp["total_traversal_overflow"] == 0
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)
    # and the display image of the same film: within one 8-bit step
    ia, ib = rv.image().astype(np.int32), pv.image().astype(np.int32)
    assert ib.shape == (SIZE, SIZE, 3) and np.abs(ia - ib).max() <= 1 and ib.min() < ib.max()


def test_textured_scene_through_the_ports_loader(tmp_path):
    """The same file through the port's own loader (numpy BMP reader, own EXR
    codec): the render agrees with the one on the carried-across tables to
    the ulp of the sRGB decode."""
    path = torch_gen_interior.ensure_small_textured(str(tmp_path))
    ref = ref_load_scene(path, strict=True)
    carried = tuple(scene_from_numpy(x if i == 1 else jax.tree_util.tree_map(np.asarray, x), "cpu")
                    for i, x in enumerate(ref))
    own = load_scene(path, strict=True, device="cpu")
    assert own[0].clusters.tris_per_cluster == 64
    assert own[1] == carried[1]
    kw = dict(vp_params=ViewportParams(16, 16, seed=2), render_params=RenderParams(max_depth=3, mis=True), device="cpu")
    a = Viewport(*carried, **kw).render(1)
    b = Viewport(*own, **kw).render(1)
    assert a.progress() == b.progress()
    np.testing.assert_allclose(b.radiance(), a.radiance(), rtol=1e-4, atol=1e-5)
