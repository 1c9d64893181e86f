"""Port parity: spectral rendering (``color/spectrum.py``, the dispersive
IoR of ``ops/materials.py::resolve_material`` and the hero-wavelength path
of ``integrators/path_tracer.py``) against the JAX package, on the CPU.

- The spectrum functions on 4,096 seeded wavelengths: ``_channel_norm``
  and the wavelength samplers bit for bit; ``cie_xyz`` and ``cauchy_ior``
  within rtol 1e-6 (atol 1e-7 for the lobes' tails: they go through
  ``exp``, where torch and XLA may differ by an ulp).  ``rgb_resolve``
  within rtol 1e-6 and atol 1e-6: each channel is a sum of the three lobes
  times matrix entries up to 3.2 in size, so an ulp of a lobe (or a fused
  multiply-add in XLA) moves a channel by up to 6.5e-7 (measured) where it
  crosses 0.
- ``resolve_material`` on a table with a dispersive material of each form
  (Cauchy C / D, and the (IoR, abbe) form) beside non-dispersive ones, at
  seeded material ids and wavelengths: the ``dispersive`` lanes equal, the
  IoR within rtol 1e-6.
- A 24^2, depth 4, MIS render of a scene with a dispersive glass sphere
  (the abbe form) and a dispersive rough glass sphere (C / D), spectral
  on, after pass 0 and pass 1 (the hero wavelength's stratum follows the
  pass): every pixel within rtol 1e-4 / atol 1e-6, the tolerance of the
  other render parity tests, and the ray counters equal.  (No glass box:
  its face is picked by the dominant axis of the hit point, and a ray
  refracted near an edge takes another face under a last-bit difference;
  this scene with a glass box differs at 2 of 576 pixels with RGB
  throughput too.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.color import spectrum as ref_spectrum
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.ops.materials import resolve_material as ref_resolve_material
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.scene import build as ref_build, types as RT
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu_torch.color import spectrum
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.ops.materials import resolve_material
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.convert import scene_from_numpy

N = 4096
RTOL, ATOL = 1e-6, 1e-7
FILM_RTOL, FILM_ATOL = 1e-4, 1e-6


def carry(x):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")


def _lam():
    return np.random.default_rng(3).uniform(370.0, 740.0, N).astype(np.float32)


def test_channel_norm_and_samplers_bit_equal():
    np.testing.assert_array_equal(spectrum._channel_norm(), ref_spectrum._channel_norm())
    assert spectrum._channel_norm().dtype == np.float64
    u = np.random.default_rng(4).random(N, dtype=np.float32)
    np.testing.assert_array_equal(spectrum.sample_wavelength(torch.as_tensor(u)).numpy(),
                                  np.asarray(ref_spectrum.sample_wavelength(jnp.asarray(u))))
    for p in range(10):
        got = spectrum.sample_wavelength_stratified(torch.as_tensor(u), p).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref_spectrum.sample_wavelength_stratified(jnp.asarray(u),
                                                                                                jnp.int32(p))))
        width = (spectrum.WAVELENGTH_HI - spectrum.WAVELENGTH_LO) / spectrum.NUM_STRATA
        lo = spectrum.WAVELENGTH_LO + (p % spectrum.NUM_STRATA) * width
        assert (got >= lo).all() and (got <= lo + width + 1e-3).all()


@pytest.mark.parametrize("fn,atol", [("cie_xyz", ATOL), ("rgb_resolve", 1e-6)])
def test_cie_and_resolve_match_reference(fn, atol):
    lam = _lam()
    got = getattr(spectrum, fn)(torch.as_tensor(lam))
    want = getattr(ref_spectrum, fn)(jnp.asarray(lam))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=atol)
    if fn == "rgb_resolve":
        # the resolve's mean over a uniform wavelength is white
        u = (np.arange(N, dtype=np.float32) + 0.5) / N
        mean = [float(c.mean()) for c in spectrum.rgb_resolve(spectrum.sample_wavelength(torch.as_tensor(u)))]
        np.testing.assert_allclose(mean, 1.0, rtol=2e-3)


def test_cauchy_ior_matches_reference():
    rng = np.random.default_rng(5)
    n_d = rng.uniform(1.3, 2.0, N).astype(np.float32)
    abbe = rng.uniform(0.0, 80.0, N).astype(np.float32)  # 0 goes through the 1e-3 floor
    abbe[:8] = 0.0
    lam = _lam()
    got = spectrum.cauchy_ior(torch.as_tensor(n_d), torch.as_tensor(abbe), torch.as_tensor(lam))
    want = ref_spectrum.cauchy_ior(jnp.asarray(n_d), jnp.asarray(abbe), jnp.asarray(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert np.isfinite(got.numpy()).all()


def _materials(b):
    """Materials of both dispersion forms beside plain ones."""
    b.add_material(ref_build.MaterialDesc(name="plain", base_color=(0.6, 0.6, 0.6)))
    b.add_material(ref_build.MaterialDesc(name="crown", bsdf="dielectric", ior=1.52, dispersive=True, abbe=58.0,
                                          disp_use_abbe=True))
    b.add_material(ref_build.MaterialDesc(name="flint", bsdf="roughDielectric", ior=1.62, roughness=0.15,
                                          dispersive=True, dispersion_c=0.0091, dispersion_d=0.0004))
    b.add_material(ref_build.MaterialDesc(name="glass", bsdf="dielectric", ior=1.5))


def test_resolve_material_in_both_dispersion_forms():
    b = ref_build.SceneBuilder()
    _materials(b)
    ref_scene, _ = b.build()
    scene = carry(ref_scene)
    rng = np.random.default_rng(6)
    ids = rng.integers(-1, 4, N).astype(np.int32)  # -1: a miss lane reads row 0
    lam = _lam()
    got = resolve_material(scene, torch.as_tensor(ids), wavelength=torch.as_tensor(lam))
    want = ref_resolve_material(ref_scene, jnp.asarray(ids), wavelength=jnp.asarray(lam))
    np.testing.assert_array_equal(got.dispersive.numpy(), np.asarray(want.dispersive))
    np.testing.assert_array_equal(got.bsdf.numpy(), np.asarray(want.bsdf))
    np.testing.assert_allclose(got.ior.numpy(), np.asarray(want.ior), rtol=RTOL)
    ior = got.ior.numpy()
    assert (ior[ids == 3] == np.float32(1.5)).all() and np.ptp(ior[ids == 1]) > 0.005 and np.ptp(ior[ids == 2]) > 0.01
    # without a wavelength the table's IoR stands
    np.testing.assert_array_equal(resolve_material(scene, torch.as_tensor(ids)).ior.numpy(),
                                  np.asarray(ref_resolve_material(ref_scene, jnp.asarray(ids)).ior))


def dispersive_scene():
    """A dispersive glass sphere and a dispersive rough glass sphere on a floor,
    before a wall, under a rect light and a dim background (the JAX
    package's builder; the port gets it through scene_from_numpy)."""
    b = ref_build.SceneBuilder()
    _materials(b)
    plain, crown, flint = b.material_id("plain"), b.material_id("crown"), b.material_id("flint")
    b.add_rect(RefRigidTransform(euler_deg=(-90, 0, 0)), (3.0, 3.0), plain)
    b.add_rect(RefRigidTransform(translation=(0, 1.5, 2.0), euler_deg=(180, 0, 0)), (3.0, 1.5), plain)
    b.add_sphere(RefRigidTransform(translation=(-0.45, 0.5, 0.6)), 0.5, crown)
    b.add_sphere(RefRigidTransform(translation=(0.6, 0.35, 0.4)), 0.35, flint)
    b.add_light(ref_build.LightDesc(kind=RT.LIGHT_AREA, color=(12.0, 12.0, 12.0),
                                    transform=RefRigidTransform(translation=(0.0, 2.8, 0.3), euler_deg=(90, 0, 0)),
                                    shape_kind=RT.SHAPE_RECT, shape_param=(0.6, 0.6, 0.0)))
    b.add_light(ref_build.LightDesc(kind=RT.LIGHT_BACKGROUND, color=(0.2, 0.25, 0.3)))
    scene, meta = b.build()
    cam = ref_make_camera(RefRigidTransform(translation=(0.0, 1.2, -2.5), euler_deg=(15, 0, 0)), fov_deg=50.0)
    return (scene, meta, cam), (carry(scene), meta, carry(cam))


def test_spectral_render_matches_reference_at_pass_0_and_1():
    (rs, rm, rc), (ps, pm, pc) = dispersive_scene()
    size, params = 24, dict(max_depth=4, mis=True, spectral=True)
    rv = RefViewport(rs, rm, rc, RefViewportParams(size, size, seed=0), RefRenderParams(**params))
    pv = Viewport(ps, pm, pc, ViewportParams(size, size, seed=0), RenderParams(**params), device="cpu")
    for p in (0, 1):
        a = rv.render(1).radiance()
        b = pv.render(1).radiance()
        assert np.isfinite(b).all() and b.mean() > 0
        np.testing.assert_allclose(b, a, rtol=FILM_RTOL, atol=FILM_ATOL, err_msg=f"after pass {p}")
        for key in ("total_rays", "total_shadow_rays"):
            assert pv.progress()[key] == rv.progress()[key], key
    # the dispersive props tint what they refract: the channels spread more
    # than in the same render with RGB throughput
    flat = Viewport(ps, pm, pc, ViewportParams(size, size, seed=0), RenderParams(max_depth=4, mis=True),
                    device="cpu").render(2).radiance()
    chroma = lambda img: np.abs(img - img.mean(-1, keepdims=True)).mean()
    assert chroma(b) > chroma(flat)
