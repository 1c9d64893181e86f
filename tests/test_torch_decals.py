"""Port parity: decals (``ops/materials.py::_apply_decals`` and their use
by the path tracer and VCM) against the JAX package, on the CPU.

The scenes are built by the JAX package's builder and carried across with
``scene/convert.py``.

- ``_apply_decals`` at 4,096 seeded shading points around the decal boxes
  (so some lie outside every box): a constant decal; a decal that samples
  the atlas for its colour and for its alpha (a bitmap whose x channel
  ramps); two overlapping decals whose ``order`` sets which ends on top;
  a decal off the points; a decal of alpha 0.  Base colour and roughness
  within rtol 1e-6 / atol 1e-7; the points outside every box and the
  alpha-0 decal leave both bit for bit unchanged.
- Renders: the shifted Cornell box with three constant decals on its back
  wall and floor (``tools/torch_check_features.py::decaled_cornell``):
  MIS at 24^2, depth 3, after pass 0 and pass 1; VCM at 16^2, max path
  length 4, at pass 0 and pass 1 (merging is off at pass 0).  Every film
  value within rtol 1e-4 / atol 1e-6, but for the MIS values pinned in
  ``APART``, which differ by the same amounts (up to 2.5e-5) in the same
  render without decals (a last-bit difference of the path tracer on this
  box, not of the decals), and VCM's pixel of ``VCM_APART``, the one
  ``tests/test_torch_vcm.py`` pins on the box without decals.  The decals sample no atlas here: with one, the
  JAX side compiles every texture kind into each of the 2 D lookups of a
  shading and the render takes 80 s instead of 9 (the atlas path is held
  by the ``_apply_decals`` cases above, and on the card by
  ``chip_smoke.py`` phase 20).
- The light tracer passes no shading position to ``resolve_material`` in
  either package, so decals do not reach it: the port's film with the
  decals equals its film without them bit for bit, and the JAX package's
  film with the decals is within rtol 1e-4 / atol 1e-6 of them (a
  reference inconsistency the port keeps).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators import light_tracer as ref_lt, vcm as ref_vcm
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import materials as ref_materials
from raytracer_tpu.ops.textures import AtlasBuilder
from raytracer_tpu.render.film import make_film as ref_make_film
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.scene import build as ref_build, types as RT
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu_torch.integrators import light_tracer, vcm
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import materials
from raytracer_tpu_torch.render.film import make_film
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.convert import scene_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import torch_check_features as tfx  # noqa: E402

N = 4096
RTOL, ATOL = 1e-6, 1e-7
FILM_RTOL, FILM_ATOL = 1e-4, 1e-6
# (pass, row, column, channel) of the MIS film values outside the tolerance;
# the render without decals has the same ones
APART = {0: [(1, 2, 0), (12, 20, 1)], 1: [(2, 1, 0)]}
# VCM's pixel (10, 4) at pass 0: the one tests/test_torch_vcm.py pins (a
# connection the reference drops at a camera hit an ulp away, 1.1453e-4)
VCM_APART = {0: [(10, 4)], 1: []}


def carry(x):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")


def _atlas():
    """Texture 0: a colour bitmap; 1: an alpha ramp along u; 2: a checkerboard."""
    return tfx.decal_atlas(AtlasBuilder()).build()


CASES = {
    "constant": [dict(base_color=(0.8, 0.1, 0.1), roughness=0.2, alpha_min=0.3, alpha_max=0.7)],
    "textured with alpha": [dict(base_color=(1.0, 0.9, 0.8), base_color_tex=0, alpha_tex=1, roughness=0.4,
                                 alpha_min=0.1, alpha_max=1.0)],
    "layered by order": [dict(base_color=(0.9, 0.1, 0.1), roughness=0.1, alpha_min=1.0, alpha_max=1.0, order=0),
                         dict(base_color=(0.1, 0.1, 0.9), roughness=0.9, alpha_min=1.0, alpha_max=1.0, order=5,
                              at=(0.3, 0.2, 0.0)),
                         dict(base_color=(0.1, 0.9, 0.1), base_color_tex=2, roughness=0.5, alpha_min=0.5,
                              alpha_max=0.5, order=5, at=(-0.2, 0.0, 0.1))],
    "outside the box": [dict(base_color=(0.0, 1.0, 0.0), alpha_min=1.0, alpha_max=1.0, at=(50.0, 0.0, 0.0))],
    "alpha 0": [dict(base_color=(0.0, 0.0, 1.0), base_color_tex=0, alpha_tex=1, alpha_min=0.0, alpha_max=0.0)],
}


def _decal_scene(decals, textured=True):
    b = ref_build.SceneBuilder()
    b.add_material(ref_build.MaterialDesc(base_color=(0.5, 0.5, 0.5)))
    if textured:
        b.textures = _atlas()
    for d in decals:
        d = dict(d)
        at = d.pop("at", (0.0, 0.0, 0.0))
        b.add_decal(ref_build.DecalDesc(transform=RefRigidTransform(translation=at, euler_deg=(10.0, 20.0, 30.0)),
                                        half_size=(0.6, 0.5, 0.4), **d))
    b.add_light(ref_build.LightDesc(kind=RT.LIGHT_BACKGROUND, color=(1.0, 1.0, 1.0)))
    return b.build()[0]


@pytest.mark.parametrize("textured", [True, False], ids=["atlas", "no atlas"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_decals_matches_reference(case, textured):
    ref_scene = _decal_scene(CASES[case], textured)
    scene = carry(ref_scene)
    rng = np.random.default_rng(9)
    pos = rng.uniform(-1.0, 1.0, (3, N)).astype(np.float32)
    bc = rng.random((3, N), dtype=np.float32)
    rough = rng.random(N, dtype=np.float32)
    want_bc, want_r = ref_materials._apply_decals(ref_scene, RefVec3(*map(jnp.asarray, pos)),
                                                  RefVec3(*map(jnp.asarray, bc)), jnp.asarray(rough))
    got_bc, got_r = materials._apply_decals(scene, Vec3(*map(torch.as_tensor, pos)), Vec3(*map(torch.as_tensor, bc)),
                                            torch.as_tensor(rough))
    for g, w in zip((*got_bc, got_r), (*want_bc, want_r)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    changed = (got_r.numpy() != rough) | np.any([g.numpy() != b for g, b in zip(got_bc, bc)], axis=0)
    if case in ("outside the box", "alpha 0"):
        assert not changed.any()
    else:
        assert 0.05 < changed.mean() < 0.95  # some points inside a box, some outside
    if case == "layered by order":
        # the decals are applied from the highest order down: where the
        # order-0 red decal covers a point it ends on top
        assert scene.decals.alpha_min.tolist() == [1.0, 0.5, 1.0]
        top = (got_bc[0].numpy() == np.float32(0.9)) & (got_r.numpy() == np.float32(0.1))
        assert top.sum() > 100


def decaled_cornell():
    """``torch_check_features.decaled_cornell`` with constant decals, built
    by the JAX package and carried across."""
    b, t_kw, c_kw = tfx.decaled_cornell(ref_build, RefRigidTransform, RT)
    scene, meta = b.build()
    cam = ref_make_camera(RefRigidTransform(**t_kw), **c_kw)
    return (scene, meta, cam), (carry(scene), meta, carry(cam))


def test_mis_render_with_decals_matches_reference():
    (rs, rm, rc), (ps, pm, pc) = decaled_cornell()
    size, params = 24, dict(max_depth=3, mis=True)
    rv = RefViewport(rs, rm, rc, RefViewportParams(size, size, seed=0), RefRenderParams(**params))
    pv = Viewport(ps, pm, pc, ViewportParams(size, size, seed=0), RenderParams(**params), device="cpu")
    for p in (0, 1):
        a, b = rv.render(1).radiance(), pv.render(1).radiance()
        assert np.isfinite(b).all() and b.mean() > 0
        apart = ~np.isclose(b, a, rtol=FILM_RTOL, atol=FILM_ATOL)
        assert [tuple(int(i) for i in j) for j in np.argwhere(apart)] == APART[p]
        assert np.abs(b - a).max() < 3e-5
    plain = Viewport(ps._replace(decals=None), pm, pc, ViewportParams(size, size, seed=0), RenderParams(**params),
                     device="cpu").render(2).radiance()
    assert (np.abs(plain - b).max(-1) > 1e-3).mean() > 0.05  # the decals show


def test_vcm_pass_with_decals_matches_reference():
    (rs, rm, rc), (ps, pm, pc) = decaled_cornell()
    size, length = 16, 4
    v = ref_vcm.VcmParams(max_path_length=length)
    vp = RefViewportParams(size, size, seed=0)
    fn = jax.jit(lambda s, c, f, p: ref_vcm.render_pass_vcm(s, rm, c, f, p, None, vp, RefRenderParams(max_depth=length),
                                                            v))
    for p in (0, 1):
        a = np.asarray(fn(rs, rc, ref_make_film(size, size), jnp.int32(p)).sum)
        b = vcm.render_pass_vcm(ps, pm, pc, make_film(size, size, "cpu"), p, None, ViewportParams(size, size, seed=0),
                                RenderParams(max_depth=length), vcm.VcmParams(max_path_length=length)).sum.numpy()
        assert np.isfinite(b).all() and b.mean() > 0
        apart = ~np.isclose(b, a, rtol=FILM_RTOL, atol=FILM_ATOL).all(-1)
        assert [tuple(int(i) for i in j) for j in np.argwhere(apart)] == VCM_APART[p]
        for y, x in VCM_APART[p]:
            assert (a[y, x] == 0).all() and np.allclose(b[y, x], 1.1453e-4, rtol=1e-3)


def test_light_tracer_ignores_decals_as_the_reference_does():
    (rs, rm, rc), (ps, pm, pc) = decaled_cornell()
    size, params = 16, dict(max_depth=3)
    port = lambda s: light_tracer.render_pass_light_tracer(s, pm, pc, make_film(size, size, "cpu"), 1, None,
                                                           ViewportParams(size, size, seed=0),
                                                           RenderParams(**params))[0].sum.numpy()
    ref = np.asarray(ref_lt.render_pass_light_tracer(rs, rm, rc, ref_make_film(size, size), jnp.int32(1), None,
                                                     RefViewportParams(size, size, seed=0),
                                                     RefRenderParams(**params))[0].sum)
    with_decals = port(ps)
    assert with_decals.mean() > 0
    np.testing.assert_array_equal(with_decals, port(ps._replace(decals=None)))
    np.testing.assert_allclose(with_decals, ref, rtol=FILM_RTOL, atol=FILM_ATOL)
