"""Port parity: piecewise-constant distributions, environment-map sampling
and ``illuminate(env=)`` of raytracer_tpu_torch against the JAX package.

The CDF tables are built on the host in float64 and rounded once, so they are
bit-equal; sampled bin indices are equal; sampled positions and pdfs agree to
rtol 1e-6; directions and ``illuminate`` to rtol 1e-5.  A furnace render
holds the env pdf NEE samples with against the one the miss branch weighs
with: were they to differ, MIS would lose or gain energy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.math import distribution as ref_dist
from raytracer_tpu.math import sampling as ref_sampling
from raytracer_tpu.math.transform import RigidTransform as RefRT
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import lights as ref_lights
from raytracer_tpu.ops import textures as ref_tex
from raytracer_tpu.scene import build as ref_build
from raytracer_tpu.scene import types as RT
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math import distribution as dist
from raytracer_tpu_torch.math import sampling
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import lights, textures as tex
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene import build
from raytracer_tpu_torch.scene.camera import make_camera

N = 4096
J, T_ = jnp.asarray, torch.as_tensor


def _close(want, got, rtol, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _equal(want, got):
    assert np.array_equal(got.numpy(), np.asarray(want))


def _uniform(seed, n=N):
    """[0, 1) samples with the ends and a few exact bin borders put in."""
    u = np.random.default_rng(seed).random(n).astype(np.float32)
    u[:6] = [0.0, 0.99999994, 0.5, 0.25, 0.125, 1e-8]
    return u


def _env_image(h=12, w=20, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32) ** 3
    img[2, 5] = 40.0  # a sun
    img[7] = 0.0  # an empty row: its conditional falls back to uniform
    return img


@pytest.mark.parametrize("values", ["random", "zeros", "spiky"])
def test_distribution_1d(values):
    rng = np.random.default_rng(1)
    v = {"random": rng.random(37), "zeros": np.zeros(9), "spiky": np.r_[np.zeros(5), 3.0, np.zeros(4), 1.0]}[values]
    ref, got = ref_dist.make_distribution(v), dist.make_distribution(v, device="cpu")
    _equal(ref.prob, got.prob)
    _equal(ref.cdf, got.cdf)
    u = _uniform(2)
    ri, rp = ref_dist.sample_discrete(ref, J(u))
    gi, gp = dist.sample_discrete(got, T_(u))
    assert gi.dtype == torch.int32
    _equal(ri, gi)
    _equal(rp, gp)
    rx, rd = ref_dist.sample_continuous(ref, J(u))
    gx, gd = dist.sample_continuous(got, T_(u))
    _close(rx, gx, rtol=1e-6, atol=1e-7)
    _close(rd, gd, rtol=1e-6)


def test_distribution_refuses_bad_input():
    with pytest.raises(ValueError, match="non-negative"):
        dist.make_distribution(np.array([1.0, -1.0]), device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        dist.make_distribution_2d(np.ones(4), device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        dist.make_distribution_2d(-np.ones((2, 2)), device="cpu")


def _dist2d(values="env"):
    v = _env_image().sum(-1).astype(np.float64) if values == "env" else np.zeros((4, 6))
    return ref_dist.make_distribution_2d(v), dist.make_distribution_2d(v, device="cpu")


@pytest.mark.parametrize("values", ["env", "zeros"])
def test_distribution_2d(values):
    ref, got = _dist2d(values)
    for f in ref._fields:
        _equal(getattr(ref, f), getattr(got, f))
    assert (got.height, got.width) == (ref.height, ref.width)
    u1, u2 = _uniform(4), _uniform(5)[::-1].copy()
    ru, rv, rd = ref_dist.sample_2d(ref, J(u1), J(u2))
    gu, gv, gd = dist.sample_2d(got, T_(u1), T_(u2))
    _equal(rd, gd)  # the same texel was picked in every lane
    _close(ru, gu, rtol=1e-6, atol=1e-7)
    _close(rv, gv, rtol=1e-6, atol=1e-7)
    _equal(ref_dist.pdf_2d(ref, J(u1), J(u2)), dist.pdf_2d(got, T_(u1), T_(u2)))
    # the pdf at a sampled point is the density it was sampled with, away
    # from texel borders (half a texel of room)
    h, w = got.density.shape
    fu, fv = (gu * w) % 1.0, (gv * h) % 1.0
    inner = (fu > 1e-3) & (fu < 1 - 1e-3) & (fv > 1e-3) & (fv < 1 - 1e-3)
    assert inner.float().mean() > 0.9
    assert torch.equal(dist.pdf_2d(got, gu, gv)[inner], gd[inner])


def _dirs(seed, n=N):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[0, 1, 0], [0, -1, 0], [1, 0, 0]]
    return d.astype(np.float32)


def _vec_pair(a):
    return (RefVec3(*(J(a[:, i]) for i in range(3))),
            Vec3(*(T_(np.ascontiguousarray(a[:, i])) for i in range(3))))


def test_cartesian_to_spherical_uv():
    rd, pd = _vec_pair(_dirs(6))
    for a, b in zip(ref_sampling.cartesian_to_spherical_uv(rd), sampling.cartesian_to_spherical_uv(pd)):
        _close(a, b, rtol=0, atol=1e-6)


def test_env_sample_direction_and_pdf():
    ref, got = _dist2d()
    u1, u2 = _uniform(7), _uniform(8)
    (rdir, rpdf), (gdir, gpdf) = ref_lights.env_sample_direction(ref, J(u1), J(u2)), \
        lights.env_sample_direction(got, T_(u1), T_(u2))
    for a, b in zip(rdir, gdir):
        _close(a, b, rtol=1e-5, atol=1e-6)
    _close(rpdf, gpdf, rtol=1e-5)
    rd, pd = _vec_pair(_dirs(9))
    _close(ref_lights.env_direction_pdf(ref, rd), lights.env_direction_pdf(got, pd), rtol=1e-5)
    # the pdf a direction was sampled with is the pdf it is weighed with
    inner = (gdir.y.abs() < 0.99)
    back = lights.env_direction_pdf(got, gdir)
    agree = torch.isclose(back, gpdf, rtol=1e-3) | ~inner
    assert agree.float().mean() > 0.97  # texel borders may round to the neighbour


def _env_scenes():
    """A background light with a lat-long bitmap among other lights, through
    both packages."""
    img = _env_image()
    out = []
    for mod_b, mod_t, rt in ((ref_build, ref_tex, RefRT), (build, tex, RigidTransform)):
        atlas = mod_t.AtlasBuilder()
        atlas.add_checkerboard((1, 1, 1), (0, 0, 0))
        env_id = atlas.add_bitmap(img, mod_t.FILTER_BILINEAR_SMOOTHSTEP)
        b = mod_b.SceneBuilder()
        b.add_light(mod_b.LightDesc(kind=RT.LIGHT_AREA, color=(5, 5, 5), transform=rt((0, 3, 0), (90, 0, 0)),
                                    shape_kind=RT.SHAPE_RECT, shape_param=(0.5, 0.5, 0.0)))
        b.add_light(mod_b.LightDesc(kind=RT.LIGHT_BACKGROUND, color=(0.5, 0.6, 0.7), env_tex=env_id))
        b.add_light(mod_b.LightDesc(kind=RT.LIGHT_POINT, color=(3, 3, 3), transform=rt((1, 2, 1))))
        out.append((b, atlas))
    (rb, ra), (pb, pa) = out
    rb.textures = ra.build()
    pb.textures = pa.build("cpu")
    return rb.build(), pb.build("cpu")


def test_scene_env_dist_bit_equal():
    (rs, rm), (ps, pm) = _env_scenes()
    assert ps.env_dist is not None
    for f in rs.env_dist._fields:
        _equal(getattr(rs.env_dist, f), getattr(ps.env_dist, f))
    _equal(rs.lights.env_tex, ps.lights.env_tex)
    assert pm.background_light_index == rm.background_light_index == 1
    # no distribution without an atlas, without a bitmap on the light, or for a procedural texture
    b = build.SceneBuilder()
    b.add_light(build.LightDesc(kind=RT.LIGHT_BACKGROUND, color=(1, 1, 1)))
    assert b.build("cpu")[0].env_dist is None
    b.textures = ps.textures
    assert b.build("cpu")[0].env_dist is None
    b.lights[0].env_tex = 0  # the checkerboard
    assert b.build("cpu")[0].env_dist is None


@pytest.mark.parametrize("sphere_cone", [False, True])
def test_illuminate_with_env(sphere_cone):
    """rtol 1e-5 (atol 1e-5 on directions and distances, as for the other
    light kinds); the background lanes take the env-map direction and pdf."""
    (rs, _), (ps, _) = _env_scenes()
    rng = np.random.default_rng(12)
    idx = np.repeat(np.arange(3), N // 3).astype(np.int32)
    n = idx.shape[0]
    pos = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    us = [_uniform(13 + i, n) for i in range(3)]
    rl, pl = ref_lights.gather_light(rs.lights, J(idx)), lights.gather_light(ps.lights, T_(idx))
    _equal(rl.env_tex, pl.env_tex)
    (rp, pp), (rn, pn) = _vec_pair(pos), _vec_pair(_dirs(14, n))
    r = ref_lights.illuminate(rl, rp, rn, *(J(u) for u in us), env=rs.env_dist, sphere_cone=sphere_cone)
    g = lights.illuminate(pl, pp, pn, *(T_(u) for u in us), env=ps.env_dist, sphere_cone=sphere_cone)
    _equal(r.valid, g.valid)
    for a, b in zip(r.dir_to_light, g.dir_to_light):
        _close(a, b, rtol=1e-5, atol=1e-5)
    rtol = 1e-4 if sphere_cone else 1e-5  # the spherical quad's 1/S, as in test_torch_shading
    for name in ("distance", "direct_pdf_w", "emission_pdf_w", "cos_at_light"):
        _close(getattr(r, name), getattr(g, name), rtol=rtol, atol=1e-5)
    bg = idx == 1
    env_dir, env_pdf = lights.env_sample_direction(ps.env_dist, T_(us[0]), T_(us[1]))
    assert torch.equal(g.dir_to_light.y[bg], env_dir.y[bg]) and torch.equal(g.direct_pdf_w[bg], env_pdf[bg])
    plain = lights.illuminate(pl, pp, pn, *(T_(u) for u in us), sphere_cone=sphere_cone)
    assert (plain.direct_pdf_w[bg] == sampling.uniform_hemisphere_pdf()).all()
    assert torch.equal(plain.direct_pdf_w[~bg], g.direct_pdf_w[~bg])


def _furnace(env_image, passes=12):
    """A white diffuse sphere lit by a background light alone."""
    b = build.SceneBuilder()
    mat = b.add_material(build.MaterialDesc(name="white", bsdf="diffuse", base_color=(0.8, 0.8, 0.8)))
    b.add_sphere(RigidTransform(), 1.0, mat)
    env_tex = RT.INVALID_ID
    if env_image is not None:
        atlas = tex.AtlasBuilder()
        env_tex = atlas.add_bitmap(env_image, tex.FILTER_BILINEAR_SMOOTHSTEP)
        b.textures = atlas.build("cpu")
    b.add_light(build.LightDesc(kind=RT.LIGHT_BACKGROUND, color=(1.0, 1.0, 1.0), env_tex=env_tex))
    scene, meta = b.build("cpu")
    cam = make_camera(RigidTransform((0, 0, -3)), fov_deg=40.0, device="cpu")
    vp = Viewport(scene, meta, cam, ViewportParams(24, 24, seed=0), RenderParams(max_depth=6, mis=True), device="cpu")
    return scene, vp.render(passes).radiance()


def test_furnace_env_map_keeps_energy():
    """A constant env map is the untextured background: importance sampling
    it through the 2-D distribution must give the same mean radiance (within
    2%: both are Monte Carlo estimates of one integral)."""
    _, plain = _furnace(None)
    scene, mapped = _furnace(np.ones((8, 16, 3), np.float32))
    assert scene.env_dist is not None and scene.textures is not None
    assert np.isfinite(mapped).all()
    assert abs(mapped.mean() - plain.mean()) <= 0.02 * plain.mean(), (mapped.mean(), plain.mean())
    # and a brighter map brightens the sphere in proportion
    _, double = _furnace(np.full((8, 16, 3), 2.0, np.float32))
    assert abs(double.mean() - 2.0 * mapped.mean()) <= 0.02 * double.mean()
