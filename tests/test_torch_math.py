"""Port parity: math/ and sampler/ of raytracer_tpu_torch against the JAX
package, on the same numpy inputs.

Tolerances: sample streams and hashes are integer work and must be bit
equal; float helpers agree within rtol=1e-5, atol=1e-6 (XLA and torch may
round transcendental functions differently in the last bits)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_tpu.math import fresnel as Rf, microfacet as Rm, sampling as Rs, vec as Rv
from raytracer_tpu.math import transform as Rt
from raytracer_tpu.sampler import sampler as RS
from raytracer_tpu_torch.math import fresnel as Pf, microfacet as Pm, sampling as Ps, vec as Pv
from raytracer_tpu_torch.math import transform as Pt
from raytracer_tpu_torch.sampler import sampler as PS

RTOL, ATOL = 1e-5, 1e-6
N = 512


def _u(rng, *shape):
    return rng.random(shape).astype(np.float32)


def _dirs(rng, n=N):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _close(a, b):
    a = [a] if not isinstance(a, (tuple, list)) else a
    b = [b] if not isinstance(b, (tuple, list)) else b
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy() if torch.is_tensor(y) else np.asarray(y),
                                   np.asarray(x), rtol=RTOL, atol=ATOL)


def _jv(a):
    return Rv.Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def _tv(a):
    return Pv.Vec3(torch.as_tensor(a[:, 0]), torch.as_tensor(a[:, 1]), torch.as_tensor(a[:, 2]))


# --- sampler: bit equality ----------------------------------------------------


IDS = np.arange(4096)


def test_hash_u32_and_combine_bit_equal():
    ref = np.asarray(RS.hash_u32(jnp.asarray(IDS, jnp.uint32))).astype(np.int64)
    assert np.array_equal(PS.hash_u32(torch.as_tensor(IDS)).numpy(), ref)
    for b in (0, 1, 0x9E3779B9, 2**32 - 1):
        ref = np.asarray(RS.hash_combine(jnp.asarray(IDS, jnp.uint32), jnp.uint32(b))).astype(np.int64)
        assert np.array_equal(PS.hash_combine(torch.as_tensor(IDS), b).numpy(), ref)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("low_discrepancy", [False, True])
def test_sample_streams_bit_equal(seed, low_discrepancy):
    for pass_idx in range(3):
        h = RS.halton_frame_vector(pass_idx) if low_discrepancy else None
        blue_r = RS.blue_noise_for_pixels(jnp.asarray(IDS), 64) if low_discrepancy else None
        blue_p = PS.blue_noise_for_pixels(torch.as_tensor(IDS), 64) if low_discrepancy else None
        r = RS.make_stream(jnp.asarray(IDS), jnp.int32(pass_idx), seed=seed,
                           halton=None if h is None else jnp.asarray(h), blue=blue_r)
        p = PS.make_stream(torch.as_tensor(IDS), pass_idx, seed=seed,
                           halton=None if h is None else torch.as_tensor(h), blue=blue_p)
        assert np.array_equal(np.asarray(r.pixel_hash).astype(np.int64), p.pixel_hash.numpy())
        u1, r = RS.next_1d(r)
        v1, p = PS.next_1d(p)
        assert np.array_equal(np.asarray(u1), v1.numpy())
        for _ in range(23):  # crosses the blue-noise (4) dims; 70 would cross MAX_DIMS
            a = RS.next_3d(r)
            b = PS.next_3d(p)
            r, p = a[-1], b[-1]
            for x, y in zip(a[:3], b[:3]):
                assert np.array_equal(np.asarray(x), y.numpy())
    assert np.array_equal(PS.halton_frame_vector(5), RS.halton_frame_vector(5))
    assert np.array_equal(PS.blue_noise_table(), RS.blue_noise_table())


def test_stream_past_max_dims_falls_back_to_hash():
    h = RS.halton_frame_vector(1)
    r = RS.make_stream(jnp.asarray(IDS), jnp.int32(1), seed=3, halton=jnp.asarray(h))
    p = PS.make_stream(torch.as_tensor(IDS), 1, seed=3, halton=torch.as_tensor(h))
    for _ in range(RS.MAX_DIMS + 3):
        a, r = RS.next_1d(r)
        b, p = PS.next_1d(p)
        assert np.array_equal(np.asarray(a), b.numpy())


# --- math -----------------------------------------------------------------------


def test_vec_ops():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(N, 3)).astype(np.float32), rng.normal(size=(N, 3)).astype(np.float32)
    ja, jb, ta, tb = _jv(a), _jv(b), _tv(a), _tv(b)
    _close(Rv.dot(ja, jb), Pv.dot(ta, tb))
    _close(Rv.cross(ja, jb), Pv.cross(ta, tb))
    _close(Rv.normalize(ja, eps=1e-20), Pv.normalize(ta, eps=1e-20))
    _close(Rv.max_component(ja), Pv.max_component(ta))


def test_sampling_helpers():
    rng = np.random.default_rng(1)
    u1, u2 = _u(rng, N), _u(rng, N)
    ju1, ju2, tu1, tu2 = jnp.asarray(u1), jnp.asarray(u2), torch.as_tensor(u1), torch.as_tensor(u2)
    for name in ("sample_circle", "sample_sphere", "sample_hemisphere", "sample_hemisphere_cos",
                 "sample_gaussian2"):
        _close(getattr(Rs, name)(ju1, ju2), getattr(Ps, name)(tu1, tu2))
    cmax = (0.5 + 0.5 * _u(rng, N)).astype(np.float32)
    _close(Rs.sample_cone(jnp.asarray(cmax), ju1, ju2), Ps.sample_cone(torch.as_tensor(cmax), tu1, tu2))
    _close(Rs.sphere_cap_pdf(jnp.asarray(cmax)), Ps.sphere_cap_pdf(torch.as_tensor(cmax)))
    d = _dirs(rng)
    rt, rb = Rs.build_onb(_jv(d))
    pt, pb = Ps.build_onb(_tv(d))
    _close(list(rt) + list(rb), list(pt) + list(pb))
    dist, cos = (1 + 5 * _u(rng, N)), (2 * _u(rng, N) - 1)
    _close(Rs.pdf_area_to_solid_angle(0.3, jnp.asarray(dist), jnp.asarray(cos)),
           Ps.pdf_area_to_solid_angle(0.3, torch.as_tensor(dist), torch.as_tensor(cos)))
    # spherical quad: a 0.5 x 0.5 rect light seen from points below it (the
    # solid angle S = g0 + g1 - k cancels for far points, amplifying ulps)
    ref = rng.uniform([-0.5, 1.0, -0.5], [0.5, 1.9, 0.5], (N, 3)).astype(np.float32)
    s = np.array([-0.25, 1.999, -0.25], np.float32)
    ex = np.array([0.5, 0, 0], np.float32)
    ey = np.array([0, 0, 0.5], np.float32)
    rv = lambda a: Rv.Vec3(*(jnp.float32(x) for x in a))
    pv = lambda a: Pv.Vec3(*(torch.tensor(x) for x in a))
    rq = Rs.spherical_quad_prepare(rv(s), rv(ex), rv(ey), _jv(ref))
    pq = Ps.spherical_quad_prepare(pv(s), pv(ex), pv(ey), _tv(ref))
    _close(rq[-1], pq[-1])
    rp, rpdf = Rs.spherical_quad_sample(rq, _jv(ref), ju1, ju2)
    pp, ppdf = Ps.spherical_quad_sample(pq, _tv(ref), tu1, tu2)
    _close(rp, pp)
    _close(rpdf, ppdf)


def test_microfacet_and_fresnel():
    rng = np.random.default_rng(2)
    a2 = (_u(rng, N) ** 4 + 1e-6).astype(np.float32)
    c = (2 * _u(rng, N) - 1).astype(np.float32)
    c2 = (2 * _u(rng, N) - 1).astype(np.float32)
    u1, u2 = _u(rng, N), _u(rng, N)
    eta = (1.0 + _u(rng, N)).astype(np.float32)
    k = (3 * _u(rng, N)).astype(np.float32)
    J, T = jnp.asarray, torch.as_tensor
    _close(Rm.ggx_d(J(a2), J(c)), Pm.ggx_d(T(a2), T(c)))
    _close(Rm.ggx_pdf(J(a2), J(c)), Pm.ggx_pdf(T(a2), T(c)))
    _close(Rm.ggx_g(J(a2), J(c), J(c2)), Pm.ggx_g(T(a2), T(c), T(c2)))
    _close(Rm.ggx_sample(J(a2), J(u1), J(u2)), Pm.ggx_sample(T(a2), T(u1), T(u2)))
    _close(Rf.fresnel_dielectric(J(c), J(eta)), Pf.fresnel_dielectric(T(c), T(eta)))
    _close(Rf.fresnel_metal(J(c), J(eta), J(k)), Pf.fresnel_metal(T(c), T(eta), T(k)))


def test_transform_matches():
    for euler in ((0, 0, 0), (35, 0, 0), (50, 20, 0), (-90, 12, 33)):
        a = Rt.RigidTransform((1, 2, 3), euler, 1.5)
        b = Pt.RigidTransform((1, 2, 3), euler, 1.5)
        assert np.array_equal(a.rot, b.rot) and np.array_equal(a.translation, b.translation)
    doc = {"translation": [0, 3.5, -7.5], "orientation": [35, 0, 0], "scale": 2.0}
    a, b = Rt.parse_transform(doc), Pt.parse_transform(doc)
    assert np.array_equal(a.rot, b.rot) and np.array_equal(a.translation, b.translation)
    assert a.scale == b.scale
