"""Port parity: the aperture samplers and the camera with bokeh shapes and
a shutter-close pose (``math/sampling.py``, ``scene/camera.py``) against
the JAX package, on the CPU.

The same seeded numpy samples (4,096 lanes) go through both packages'
``sample_hexagon``, ``sample_regular_polygon`` (5 and 7 blades, and 2,
which is a triangle) and ``sample_square``; and ``generate_rays`` runs on
the same pixel coordinates, sample streams and per-lane shutter times for
the circle, hexagon, square and 5- and 7-blade n-gon apertures, each with
and without a shutter-close pose.  Held: the hexagon and square bit for
bit (the same float32 products); the n-gon and the rays within rtol 1e-6,
with atol 1e-7 for components near 0 (one float32 ulp of 1 is 6e-8, and
torch's and XLA's sin and cos may differ by an ulp).  Measured: the n-gon
within 1.5e-7, ray origins within 2.4e-7 and directions within 1.2e-7
absolute, at most 0.19 of the stated bound.  The sample stream advances by
three dimensions for every shape, as in the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from tests.test_torch_scene import assert_same, to_port
from raytracer_tpu.math import sampling as ref_sampling
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.sampler.sampler import make_stream as ref_make_stream
from raytracer_tpu.scene import camera as ref_camera
from raytracer_tpu_torch.math import sampling
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.sampler.sampler import make_stream
from raytracer_tpu_torch.scene import camera

N = 4096
RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"circle": (camera.BOKEH_CIRCLE, 5), "hexagon": (camera.BOKEH_HEXAGON, 5),
          "square": (camera.BOKEH_SQUARE, 5), "5-gon": (camera.BOKEH_NGON, 5), "7-gon": (camera.BOKEH_NGON, 7)}
END = dict(translation=(0.3, -0.1, 0.4), euler_deg=(3.0, -8.0, 2.0))


def _u(seed, k=3):
    return np.random.default_rng(seed).random((k, N), dtype=np.float32)


def _close(got, want, exact=False):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_hexagon_and_square_bit_equal():
    u = _u(1)
    _close(sampling.sample_hexagon(*map(torch.as_tensor, u)), ref_sampling.sample_hexagon(*map(jnp.asarray, u)),
           exact=True)
    _close(sampling.sample_square(*map(torch.as_tensor, u[:2])), ref_sampling.sample_square(*map(jnp.asarray, u[:2])),
           exact=True)
    x, y = (c.numpy() for c in sampling.sample_hexagon(*map(torch.as_tensor, u)))
    # inside the unit hexagon with vertices at (+-1, 0): |y| <= sqrt(3)/2, |x| + |y|/sqrt(3) <= 1
    assert (np.abs(y) <= 0.8660254 + 1e-6).all() and (np.abs(x) + np.abs(y) / np.sqrt(3) <= 1 + 1e-6).all()


@pytest.mark.parametrize("blades", [2, 5, 7])
def test_regular_polygon_matches_reference(blades):
    u = _u(blades)
    got = sampling.sample_regular_polygon(blades, *map(torch.as_tensor, u))
    _close(got, ref_sampling.sample_regular_polygon(blades, *map(jnp.asarray, u)))
    r = np.hypot(*(c.numpy() for c in got))
    assert r.max() <= 1.0 + 1e-6 and r.max() > 0.9


def _cameras(shape, moving):
    kind, blades = SHAPES[shape]
    kw = dict(fov_deg=45.0, aspect=1.25, enable_dof=True, aperture=0.08, focal_distance=2.5, bokeh_shape=kind,
              aperture_blades=blades)
    t_kw = dict(translation=(0.1, 0.5, -3.0), euler_deg=(5.0, 10.0, 0.0))
    ref = ref_camera.make_camera(RefRigidTransform(**t_kw), transform_end=RefRigidTransform(**END) if moving else None,
                                 **kw)
    got = camera.make_camera(RigidTransform(**t_kw), transform_end=RigidTransform(**END) if moving else None, **kw,
                             device="cpu")
    return ref, got


@pytest.mark.parametrize("moving", [False, True], ids=["static", "shutter pose"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_generate_rays_matches_reference(shape, moving):
    """Rays through each aperture shape, at per-lane shutter times; the
    camera converts field for field; both streams end at the same dim."""
    ref_cam, cam = _cameras(shape, moving)
    assert_same(cam, to_port(ref_cam))
    rng = np.random.default_rng(11)
    cx, cy, time = (rng.random(N, dtype=np.float32) for _ in range(3))
    ids = np.arange(N, dtype=np.uint32)
    ref_rays, ref_stream = ref_camera.generate_rays(ref_cam, jnp.asarray(cx), jnp.asarray(cy),
                                                    ref_make_stream(jnp.asarray(ids), jnp.int32(3), seed=5),
                                                    time=jnp.asarray(time))
    rays, stream = camera.generate_rays(cam, torch.as_tensor(cx), torch.as_tensor(cy),
                                        make_stream(torch.as_tensor(ids.astype(np.int64)), 3, seed=5),
                                        time=torch.as_tensor(time))
    assert int(stream.dim) == int(ref_stream.dim)
    _close(rays.origin, ref_rays.origin)
    _close(rays.dir, ref_rays.dir)
    spread = np.ptp(np.stack([c.numpy() for c in rays.origin]), axis=1).max()
    # the lens spreads origins over the aperture (0.08), the shutter moves them by up to 0.5
    assert (spread > 0.3) if moving else (0.05 < spread < 0.2)


def test_time_without_a_shutter_pose_is_the_static_frame():
    """A camera without ``transform_end`` ignores the rays' times, and one
    with it at time 0 gives the shutter-open pose's rays (within a rounding
    of the re-orthonormalized basis)."""
    _, static = _cameras("hexagon", False)
    _, moving = _cameras("hexagon", True)
    rng = np.random.default_rng(4)
    cx, cy, time = (torch.as_tensor(rng.random(N, dtype=np.float32)) for _ in range(3))
    stream = lambda: make_stream(torch.arange(N), 0, seed=1)
    base = camera.generate_rays(static, cx, cy, stream())[0]
    timed = camera.generate_rays(static, cx, cy, stream(), time=time)[0]
    at_open = camera.generate_rays(moving, cx, cy, stream(), time=torch.zeros(N))[0]
    for a, b, c in zip((*base.dir, *base.origin), (*timed.dir, *timed.origin), (*at_open.dir, *at_open.origin)):
        assert torch.equal(a, b)
        torch.testing.assert_close(c, a, rtol=1e-6, atol=1e-6)
