"""Port parity: the texture stack (``ops/textures.py``, the texture path of
``ops/materials.py``) of raytracer_tpu_torch against the JAX package.

Inputs are made from a seed with numpy and fed to both.  Tolerances, stated
per test: the packed atlas, the 8-bit lattice hashes, nearest texel fetches
and the checkerboard are bit-equal; filtered bitmaps, noise, mix,
``resolve_material`` and ``apply_normal_map`` agree to atol 1e-6 (XLA on the
CPU fuses multiply-adds, torch does not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import materials as ref_materials
from raytracer_tpu.ops import textures as ref_tex
from raytracer_tpu.ops.intersect import PrimFrame as RefPrimFrame
from raytracer_tpu.scene import presets as ref_presets
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import materials, textures as tex
from raytracer_tpu_torch.ops.intersect import PrimFrame
from raytracer_tpu_torch.scene.convert import scene_from_numpy

ATOL = 1e-6


def _atlas_pairs():
    """The same mixed table through both packages: three bitmaps (one per
    filter, one of them non-square and narrower than the atlas), a
    checkerboard, noise with 1 and 8 octaves, a mix and a constant."""
    rng = np.random.default_rng(5)
    images = [rng.random((8, 8, 3), dtype=np.float32),
              rng.random((5, 3, 3), dtype=np.float32),  # narrower than the atlas
              rng.random((4, 16, 4), dtype=np.float32)]  # alpha channel dropped
    out = []
    for mod in (ref_tex, tex):
        b = mod.AtlasBuilder()
        ids = {}
        ids["nearest"] = b.add_bitmap(images[0], mod.FILTER_NEAREST)
        ids["bilinear"] = b.add_bitmap(images[1], mod.FILTER_BILINEAR)
        ids["smooth"] = b.add_bitmap(images[2], mod.FILTER_BILINEAR_SMOOTHSTEP)
        ids["checker"] = b.add_checkerboard((0.9, 0.1, 0.2), (0.1, 0.8, 0.3))
        ids["noise1"] = b.add_noise((1.0, 0.9, 0.8), (0.0, 0.1, 0.2), 1)
        ids["noise8"] = b.add_noise((0.2, 0.4, 0.6), (0.9, 0.7, 0.5), 12)  # capped at 8
        ids["mix"] = b.add_mix(ids["bilinear"], ids["checker"], ids["noise1"])
        ids["const"] = b.add_const((0.25, 0.5, 0.75))
        out.append((b, ids))
    return out


@pytest.fixture(scope="module")
def atlases():
    (rb, ids), (pb, ids2) = _atlas_pairs()
    assert ids == ids2
    return rb.build(), pb.build("cpu"), ids


def _vec(v):
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)


def _uv(n, seed):
    """Random UVs over [-2, 3), with the seams put in by hand: 0, 1, below 0,
    and exact texel borders of the 3-, 5-, 8- and 16-wide bitmaps."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    edges = np.array([0.0, 1.0, -1e-9, -0.25, 2.0, 1.0 / 3, 2.0 / 3, 0.2, 0.4, 0.6, 0.8, 0.125, 0.5,
                      0.0625, 0.9375, 0.99999994, -1.0, 1.5], np.float32)
    k = len(edges)
    u[:k], v[:k] = edges, edges[::-1]
    u[k:2 * k] = edges  # a border in u with a random v
    v[2 * k:3 * k] = edges
    return u, v


def test_atlas_arrays_bit_equal(atlases):
    ref, got, _ = atlases
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(got, f)
        if f in ("color_a", "color_b"):
            assert np.array_equal(_vec(a), _vec(b)), f
        else:
            assert np.array_equal(np.asarray(a), b.numpy()), f
            assert str(b.dtype).split(".")[-1] == str(np.asarray(a).dtype), f
    assert got.kinds_present == (0, 1, 2, 3, 4) and got.max_octaves == 8


def test_build_atlas_and_empty_atlas_bit_equal():
    rng = np.random.default_rng(1)
    images = [rng.random((3, 7, 3), dtype=np.float32), rng.random((6, 2, 3), dtype=np.float32)]
    ref = ref_tex.build_atlas(images, [0, 2])
    got = tex.build_atlas(images, [0, 2], device="cpu")
    assert np.array_equal(np.asarray(ref.data), got.data.numpy())
    assert np.array_equal(np.asarray(ref.filter_mode), got.filter_mode.numpy())
    assert got.kinds_present == (0,) and got.max_octaves == 0
    ref, got = ref_tex.AtlasBuilder().build(), tex.AtlasBuilder().build("cpu")  # one white constant
    assert np.array_equal(np.asarray(ref.data), got.data.numpy())
    assert np.array_equal(np.asarray(ref.kind), got.kind.numpy())


def test_hash2_bit_equal():
    rng = np.random.default_rng(2)
    ix = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    iy = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    ix[:6] = [0, -1, 1, 2**31 - 1, -2**31, 12345]
    iy[:6] = [0, -1, -2**31, 2**31 - 1, 1, -54321]
    ref = np.asarray(ref_tex._hash2(jnp.asarray(ix), jnp.asarray(iy)))
    got = tex._hash2(torch.from_numpy(ix), torch.from_numpy(iy))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert ref.min() >= 0 and ref.max() <= 255


@pytest.mark.parametrize("name", ["nearest", "bilinear", "smooth", "checker", "noise1", "noise8", "mix", "const",
                                  "invalid"])
def test_sample_texture_many_per_kind(atlases, name):
    """One id for all lanes.  Nearest fetches, the checkerboard, constants and
    INVALID_ID lanes are bit-equal; the rest within atol 1e-6.  The simplex
    choice ``x0 > y0`` may flip on a one-ulp difference: no lane of this grid
    does (every lane is held to the tolerance)."""
    ref, got, ids = atlases
    tid = ids.get(name, -1)
    n = 4096
    u, v = _uv(n, 11)
    a = _vec(ref_tex.sample_texture_many(ref, jnp.full(n, tid, jnp.int32), jnp.asarray(u), jnp.asarray(v)))
    b = _vec(tex.sample_texture_many(got, torch.full((n,), tid, dtype=torch.int32),
                                     torch.from_numpy(u), torch.from_numpy(v)))
    if name in ("nearest", "checker", "const", "invalid"):
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
    if name == "invalid":
        assert (b == 1.0).all()


def test_sample_texture_many_mixed_ids(atlases):
    ref, got, ids = atlases
    n = 8192
    rng = np.random.default_rng(4)
    tid = rng.integers(-1, len(ids), n).astype(np.int32)
    u, v = _uv(n, 12)
    a = _vec(ref_tex.sample_texture_many(ref, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v)))
    b = _vec(tex.sample_texture_many(got, torch.from_numpy(tid), torch.from_numpy(u), torch.from_numpy(v)))
    np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
    assert (b[tid == -1] == 1.0).all()


def test_static_facts_leave_out_nothing_that_is_selected(atlases):
    """The narrowed table (kinds present, most octaves) gives bit for bit
    what the table with the defaults (everything evaluated) gives."""
    _, got, ids = atlases
    rng = np.random.default_rng(8)
    images = [rng.random((4, 4, 3), dtype=np.float32)]
    b = tex.AtlasBuilder()
    b.add_bitmap(images[0], tex.FILTER_BILINEAR)
    b.add_noise((1, 1, 1), (0, 0, 0), 3)
    narrow = b.build("cpu")
    assert narrow.kinds_present == (0, 2) and narrow.max_octaves == 3
    full = narrow._replace(kinds_present=type(narrow)._field_defaults["kinds_present"],
                           max_octaves=type(narrow)._field_defaults["max_octaves"])
    n = 2048
    u, v = _uv(n, 13)
    tid = torch.from_numpy(rng.integers(-1, 2, n).astype(np.int32))
    x = tex.sample_texture_many(narrow, tid, torch.from_numpy(u), torch.from_numpy(v))
    y = tex.sample_texture_many(full, tid, torch.from_numpy(u), torch.from_numpy(v))
    assert all(torch.equal(p, q) for p, q in zip(x, y))


def _textured_scene():
    """The reference's mesh preset with the mixed atlas and texture ids drawn
    per material, and the same scene carried across."""
    (rb, ids), _ = _atlas_pairs()
    scene, _meta = ref_presets.random_mesh_scene(500)
    m = scene.materials.bsdf.shape[0]
    rng = np.random.default_rng(6)
    col = lambda: jnp.asarray(rng.integers(-1, len(ids), m).astype(np.int32))
    mats = scene.materials._replace(
        base_color_tex=col(), emission_tex=col(), roughness_tex=col(), metalness_tex=col(), normal_tex=col(),
        emission=RefVec3(*(jnp.asarray(rng.random(m, dtype=np.float32)) for _ in range(3))),
        normal_strength=jnp.asarray(rng.uniform(0.0, 1.0, m).astype(np.float32)))
    scene = scene._replace(materials=mats, textures=rb.build())
    return scene, scene_from_numpy(jax.tree_util.tree_map(np.asarray, scene), "cpu")


def test_convert_carries_the_atlas():
    ref, got = _textured_scene()
    _, pb = _atlas_pairs()
    want = pb[0].build("cpu")
    for f in want._fields:
        a, b = getattr(want, f), getattr(got.textures, f)
        same = all(torch.equal(p, q) for p, q in zip(a, b)) if isinstance(a, Vec3) else \
            torch.equal(a, b) if torch.is_tensor(a) else a == b
        assert same, f
    assert torch.equal(got.materials.normal_tex, torch.from_numpy(np.array(ref.materials.normal_tex)))


def test_resolve_material_with_textures():
    """atol 1e-6 on every float column; the bsdf kinds are equal."""
    ref, got = _textured_scene()
    n = 4096
    rng = np.random.default_rng(9)
    mid = rng.integers(-1, ref.materials.bsdf.shape[0], n).astype(np.int32)
    u, v = _uv(n, 14)
    a = ref_materials.resolve_material(ref, jnp.asarray(mid), jnp.asarray(u), jnp.asarray(v))
    b = materials.resolve_material(got, torch.from_numpy(mid), torch.from_numpy(u), torch.from_numpy(v))
    assert np.array_equal(np.asarray(a.bsdf), b.bsdf.numpy())
    for f in ("base_color", "emission"):
        np.testing.assert_allclose(_vec(getattr(b, f)), _vec(getattr(a, f)), rtol=0, atol=ATOL, err_msg=f)
    for f in ("roughness", "metalness", "ior", "k"):
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)), rtol=0, atol=ATOL, err_msg=f)
    # without UVs, and without an atlas, the table rows come back untouched
    plain = materials.resolve_material(got, torch.from_numpy(mid))
    bare = materials.resolve_material(got._replace(textures=None), torch.from_numpy(mid),
                                      torch.from_numpy(u), torch.from_numpy(v))
    idx = torch.from_numpy(np.maximum(mid, 0)).long()
    for mp in (plain, bare):
        assert torch.equal(mp.base_color.x, got.materials.base_color.x[idx])
        assert torch.equal(mp.roughness, got.materials.roughness[idx])


def _frames(n, seed, n_mats):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    helper = np.where(np.abs(nrm[:, :1]) < 0.9, [[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]]).astype(np.float32)
    tan = np.cross(helper, nrm).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    bit = np.cross(nrm, tan).astype(np.float32)
    u, v = _uv(n, seed + 1)
    fields = dict(position=rng.normal(size=(n, 3)).astype(np.float32), normal=nrm, tangent=tan, bitangent=bit)
    mid = rng.integers(-1, n_mats, n).astype(np.int32)
    lid = np.full(n, -1, np.int32)
    rv = lambda a: RefVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    pv = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))
    ref = RefPrimFrame(**{k: rv(a) for k, a in fields.items()}, tex_u=jnp.asarray(u), tex_v=jnp.asarray(v),
                       material_id=jnp.asarray(mid), light_id=jnp.asarray(lid))
    got = PrimFrame(**{k: pv(a) for k, a in fields.items()}, tex_u=torch.from_numpy(u), tex_v=torch.from_numpy(v),
                    material_id=torch.from_numpy(mid), light_id=torch.from_numpy(lid))
    return ref, got


def test_apply_normal_map():
    """atol 1e-6 on the perturbed normal, tangent and bitangent."""
    ref, got = _textured_scene()
    rf, pf = _frames(4096, 20, ref.materials.bsdf.shape[0])
    a = ref_materials.apply_normal_map(ref, rf)
    b = materials.apply_normal_map(got, pf)
    for f in ("normal", "tangent", "bitangent"):
        np.testing.assert_allclose(_vec(getattr(b, f)), _vec(getattr(a, f)), rtol=0, atol=ATOL, err_msg=f)
    assert not np.allclose(_vec(b.normal), _vec(pf.normal))  # the map did perturb
    assert torch.equal(b.position.x, pf.position.x) and torch.equal(b.tex_u, pf.tex_u)
    # a scene without textures gets its frame back as it is, untouched
    assert materials.apply_normal_map(got._replace(textures=None), pf) is pf
