"""Port parity: shading (BSDFs, lights, materials) of raytracer_tpu_torch
against the JAX package, on the same numpy inputs.

Tolerance rtol=1e-5, atol=1e-6 on float outputs; boolean outputs (valid,
specular) equal.  Inputs stay away from the lobes' knife edges (cosines
within 1e-3 of a threshold), where one ulp flips a branch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_tpu.math.transform import RigidTransform as RefRT
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import bsdf as ref_bsdf
from raytracer_tpu.ops import lights as ref_lights
from raytracer_tpu.ops import materials as ref_materials
from raytracer_tpu.scene import build as ref_build
from raytracer_tpu.scene import types as RT
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import bsdf, lights, materials
from raytracer_tpu_torch.scene import build

RTOL, ATOL = 1e-5, 1e-6
N = 1024


def _close(want, got, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _vec_pair(a):
    return (RefVec3(*(jnp.asarray(a[:, i]) for i in range(3))),
            Vec3(*(torch.as_tensor(a[:, i]) for i in range(3))))


def _dirs(rng, n=N, min_abs_z=1e-3):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = np.where(np.abs(d[:, 2]) < min_abs_z, min_abs_z * np.sign(d[:, 2] + 1e-9), d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d.astype(np.float32)


def _mat_params(kind, rng):
    f = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)
    cols = dict(bsdf=np.full(N, kind, np.int32), base=rng.random((N, 3)).astype(np.float32),
                rough=np.where(rng.random(N) < 0.1, 0.001, f(0.02, 1.0)).astype(np.float32),
                metal=f(0, 1), ior=f(1.2, 2.0), k=f(0.0, 4.0))
    J, T_ = jnp.asarray, torch.as_tensor
    emis = np.zeros((N, 3), np.float32)
    ref = ref_bsdf.MatParams(J(cols["bsdf"]), _vec_pair(cols["base"])[0], _vec_pair(emis)[0],
                             J(cols["rough"]), J(cols["metal"]), J(cols["ior"]), J(cols["k"]))
    got = bsdf.MatParams(T_(cols["bsdf"]), _vec_pair(cols["base"])[1], _vec_pair(emis)[1],
                         T_(cols["rough"]), T_(cols["metal"]), T_(cols["ior"]), T_(cols["k"]))
    return ref, got


@pytest.mark.parametrize("kind", sorted(RT.BSDF_NAMES.values()))
def test_bsdf_sample_and_evaluate(kind):
    rng = np.random.default_rng(100 + kind)
    ref_mp, mp = _mat_params(kind, rng)
    rwo, wo = _vec_pair(_dirs(rng))
    rwi, wi = _vec_pair(_dirs(rng))
    us = [rng.random(N).astype(np.float32) for _ in range(3)]
    r = ref_bsdf.sample(ref_mp, rwo, *(jnp.asarray(u) for u in us))
    g = bsdf.sample(mp, wo, *(torch.as_tensor(u) for u in us))
    assert np.array_equal(g.valid.numpy(), np.asarray(r.valid))
    assert np.array_equal(g.specular.numpy(), np.asarray(r.specular))
    ok = np.asarray(r.valid)
    for a, b in zip(r.wi, g.wi):
        _close(np.asarray(a)[ok], b[ok])
    for a, b in zip(r.weight, g.weight):
        _close(np.asarray(a)[ok], b[ok])
    _close(np.asarray(r.pdf)[ok], g.pdf[ok])

    rf, rpdf = ref_bsdf.evaluate(ref_mp, rwo, rwi)
    f, pdf = bsdf.evaluate(mp, wo, wi)
    for a, b in zip(rf, f):
        _close(a, b)
    _close(rpdf, pdf)


def _light_tables():
    """Both packages' Lights tables with every light kind and area shape."""
    descs = [
        (RT.LIGHT_AREA, dict(shape_kind=RT.SHAPE_RECT, shape_param=(0.25, 0.4, 0.0)), (0, 2, 0), (90, 0, 0)),
        (RT.LIGHT_AREA, dict(shape_kind=RT.SHAPE_SPHERE, shape_param=(0.3, 0.0, 0.0)), (1, 2, 1), (0, 0, 0)),
        (RT.LIGHT_AREA, dict(shape_kind=RT.SHAPE_BOX, shape_param=(0.2, 0.3, 0.4)), (-1, 2, 0), (10, 20, 30)),
        (RT.LIGHT_POINT, {}, (0, 3, -1), (0, 0, 0)),
        (RT.LIGHT_SPOT, dict(angle_rad=0.6), (0, 3, 1), (90, 0, 0)),
        (RT.LIGHT_DIRECTIONAL, dict(angle_rad=0.2), (0, 0, 0), (50, 20, 0)),
        (RT.LIGHT_DIRECTIONAL, dict(angle_rad=0.0), (0, 0, 0), (40, -10, 0)),
        (RT.LIGHT_BACKGROUND, {}, (0, 0, 0), (0, 0, 0)),
    ]
    rb, pb = ref_build.SceneBuilder(), build.SceneBuilder()
    for i, (kind, kw, tr, eu) in enumerate(descs):
        color = (1.0 + i, 2.0, 0.5)
        rb.add_light(ref_build.LightDesc(kind=kind, color=color, transform=RefRT(tr, eu), **kw))
        pb.add_light(build.LightDesc(kind=kind, color=color, transform=RigidTransform(tr, eu), **kw))
    return rb.build()[0].lights, pb.build("cpu")[0].lights, len(descs)


@pytest.mark.parametrize("sphere_cone", [False, True])
def test_illuminate_every_light_kind(sphere_cone):
    ref_table, table, n_lights = _light_tables()
    rng = np.random.default_rng(11)
    idx = np.repeat(np.arange(n_lights), N // n_lights).astype(np.int32)
    pos = rng.uniform(-1.5, 1.5, (idx.shape[0], 3)).astype(np.float32)
    nrm = _dirs(rng, idx.shape[0])
    us = [rng.random(idx.shape[0]).astype(np.float32) for _ in range(3)]
    rl = ref_lights.gather_light(ref_table, jnp.asarray(idx))
    pl = lights.gather_light(table, torch.as_tensor(idx))
    rp, pp = _vec_pair(pos)
    rn, pn = _vec_pair(nrm)
    r = ref_lights.illuminate(rl, rp, rn, *(jnp.asarray(u) for u in us), sphere_cone=sphere_cone,
                              scene_radius=12.5)
    g = lights.illuminate(pl, pp, pn, *(torch.as_tensor(u) for u in us), sphere_cone=sphere_cone,
                          scene_radius=12.5)
    assert np.array_equal(g.valid.numpy(), np.asarray(r.valid))
    for a, b in zip(r.dir_to_light, g.dir_to_light):
        _close(a, b, atol=1e-5)
    for a, b in zip(r.radiance, g.radiance):
        _close(a, b)
    # solid-angle sampling: the spherical quad's S = g0 + g1 - k cancels for
    # far shading points, so its pdf 1/S keeps fewer correct digits
    rtol = 1e-4 if sphere_cone else RTOL
    for name in ("distance", "direct_pdf_w", "emission_pdf_w", "cos_at_light"):
        _close(getattr(r, name), getattr(g, name), rtol=rtol, atol=1e-5)
    for name in ("kind", "shape_kind", "is_delta", "is_finite", "area", "cos_angle"):
        assert np.array_equal(getattr(pl, name).numpy(), np.asarray(getattr(rl, name))), name
    _close(ref_lights.sphere_cone_cos_max(rl.trans, rl.shape_param.x, rp)[0],
           lights.sphere_cone_cos_max(pl.trans, pl.shape_param.x, pp)[0])


def test_resolve_material_and_radiance_helpers():
    rb, pb = ref_build.SceneBuilder(), build.SceneBuilder()
    rng = np.random.default_rng(3)
    for name, kind in RT.BSDF_NAMES.items():
        kw = dict(name=name, bsdf=name, base_color=tuple(rng.random(3)), emission=tuple(rng.random(3)),
                  roughness=float(rng.random()), metalness=float(rng.random()), ior=1.3 + kind / 10, k=kind / 3)
        rb.add_material(ref_build.MaterialDesc(**kw))
        pb.add_material(build.MaterialDesc(**kw))
    rs, ps = rb.build()[0], pb.build("cpu")[0]
    ids = rng.integers(-1, len(RT.BSDF_NAMES), N).astype(np.int32)
    r = ref_materials.resolve_material(rs, jnp.asarray(ids))
    g = materials.resolve_material(ps, torch.as_tensor(ids))
    for f in bsdf.MatParams._fields:
        a, b = getattr(r, f), getattr(g, f)
        for x, y in (zip(a, b) if isinstance(b, tuple) else [(a, b)]):
            assert np.array_equal(y.numpy(), np.asarray(x)), f

    ref_table, table, n_lights = _light_tables()
    d = _dirs(rng)
    rd, pd = _vec_pair(d)
    for a, b in zip(ref_lights.background_radiance(ref_table, n_lights - 1, rd),
                    lights.background_radiance(table, n_lights - 1, pd)):
        _close(a, b)
    li = np.zeros(N, np.int32)
    rr = ref_lights.area_light_radiance(ref_lights.gather_light(ref_table, jnp.asarray(li)), rd, rd)
    pr = lights.area_light_radiance(lights.gather_light(table, torch.as_tensor(li)), pd, pd)
    assert np.array_equal(pr[2].numpy(), np.asarray(rr[2]))
    _close(rr[1], pr[1])
