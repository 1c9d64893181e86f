"""Port parity: scene construction (BVH triangle order, clusters, builder,
loader, camera) of raytracer_tpu_torch against the JAX package.

Everything here is host work on the same inputs, so arrays must be bit
equal and the scene metadata equal."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.io.scene_loader import load_scene as ref_load_scene
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.scene import presets as ref_presets
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.clusters import build_clusters as ref_build_clusters
from raytracer_tpu_torch.io.scene_loader import SceneLoadError, load_scene
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.clusters import build_clusters
from raytracer_tpu_torch.scene.convert import scene_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import bench_mesh  # noqa: E402

CLUSTER_FIELDS = ("box_min_x", "box_min_y", "box_min_z", "box_max_x", "box_max_y", "box_max_z",
                  "tri_block", "tri_id", "stream_block", "super_box", "super_geom", "super_sbox", "tri_attr")


def to_port(obj):
    """The JAX object's arrays to numpy, then the port's type by field name
    (SceneMeta holds no arrays and is no pytree: it converts as it is)."""
    if not dataclasses.is_dataclass(obj) or hasattr(obj, "origin"):
        obj = jax.tree_util.tree_map(np.asarray, obj)
    return scene_from_numpy(obj, "cpu")


def assert_same(a, b, path="scene"):
    """Bit equality of two port-side structures (tensors, tuples, scalars).
    float32 tensors compare as their bit patterns: the BVH's int lanes are
    stored in them and read as NaN where they hold -1."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape, path
        bits = (lambda x: x.view(torch.int32)) if a.dtype == torch.float32 else (lambda x: x)
        assert torch.equal(bits(a), bits(b)), path
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}.{getattr(a, '_fields', range(len(a)))[i]}")
    else:
        assert a == b, path


@pytest.fixture
def bench_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_mesh, "BENCH_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("n_tris", [2000, 20000])
def test_build_clusters_bit_equal(n_tris):
    verts, faces = bench_mesh.make_mesh(n_tris)
    tri = verts[faces].astype(np.float32)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    rng = np.random.default_rng(3)
    nrm = rng.normal(size=tri.shape).astype(np.float32)
    uv = rng.random((tri.shape[0], 3, 2)).astype(np.float32)
    mid = rng.integers(0, 5, tri.shape[0]).astype(np.int32)
    for k in (8, 64):
        ref = ref_build_clusters(v0, e1, e2, k=k, normals=nrm, uvs=uv, material_ids=mid)
        got = build_clusters(v0, e1, e2, k=k, normals=nrm, uvs=uv, material_ids=mid, device="cpu")
        for f in CLUSTER_FIELDS:
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f))), (k, f)
            assert getattr(got, f).dtype == torch.as_tensor(np.array(getattr(ref, f))).dtype, (k, f)
        assert len(got.tree_levels) == len(ref.tree_levels)
        for lvl, (a, b) in enumerate(zip(got.tree_levels, ref.tree_levels)):
            assert np.array_equal(a.numpy(), np.asarray(b)), (k, "tree_levels", lvl)
        assert got.num_supers == ref.num_supers and got.tris_per_cluster == ref.tris_per_cluster


def test_random_mesh_scene_bit_equal():
    ref_scene, ref_meta = ref_presets.random_mesh_scene(2000)
    scene, meta = presets.random_mesh_scene(2000, device="cpu")
    assert_same(scene, to_port(ref_scene))
    assert meta == to_port(ref_meta)


def test_cornell_box_bit_equal():
    ref_scene, ref_meta = ref_presets.cornell_box()
    scene, meta = presets.cornell_box(device="cpu")
    assert_same(scene, to_port(ref_scene))
    assert meta == to_port(ref_meta)
    t_kw, c_kw = presets.cornell_camera_kw()
    assert_same(make_camera(RigidTransform(**t_kw), **c_kw, device="cpu"),
                to_port(ref_make_camera(RefRigidTransform(**t_kw), **c_kw)))


@pytest.mark.parametrize("n_tris", [2000, 20000])
def test_load_bench_scene_bit_equal(bench_dir, n_tris):
    path = bench_mesh.ensure_scene(n_tris)
    ref_scene, ref_meta, ref_cam = ref_load_scene(path)
    scene, meta, cam = load_scene(path, device="cpu")
    assert_same(scene, to_port(ref_scene))
    assert meta == to_port(ref_meta)
    assert_same(cam, to_port(ref_cam))
    assert scene.tris.count == ref_scene.tris.count


def test_loader_refuses_what_waits(tmp_path):
    """csg still raises; a texture key no longer does: a file that is not
    there becomes a white placeholder with a warning, or raises under
    ``strict``.  A mesh placed twice no longer raises either: it loads as one
    shared geometry and two instances."""
    import json

    p = tmp_path / "tex.json"
    p.write_text(json.dumps({"materials": [{"name": "m", "baseColorTexture": "a.bmp"}]}))
    with pytest.warns(UserWarning, match="1 texture file"):
        scene, _, _ = load_scene(str(p), device="cpu")
    assert scene.textures is not None and scene.textures.kind.tolist() == [4]  # one white constant
    assert scene.materials.base_color_tex.tolist() == [0]
    with pytest.raises(SceneLoadError, match="texture not found"):
        load_scene(str(p), strict=True, device="cpu")
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    p.write_text(json.dumps({"objects": [{"type": "mesh", "path": str(obj)},
                                         {"type": "mesh", "path": str(obj)}]}))
    scene, _, _ = load_scene(str(p), device="cpu")
    assert scene.tris is None and scene.bvh is None
    assert len(scene.mesh_geoms) == 1 and scene.mesh_geoms[0].tris.count == 1
    assert scene.instances.count == 2 and scene.instances.mesh_ids == (0, 0)
    p.write_text(json.dumps({"objects": [{"type": "csg"}]}))
    with pytest.raises(SceneLoadError, match="csg"):
        load_scene(str(p), device="cpu")


def _write_test_bitmaps(tmp_path):
    """A 6x5 BMP (its 18-byte rows are padded to 20), a 7x3 BMP and an 8x4
    lat-long EXR, from a seed."""
    from PIL import Image

    from raytracer_tpu.io.exr import write_exr

    rng = np.random.default_rng(21)
    for name, (h, w) in (("a.bmp", (5, 6)), ("b.bmp", (3, 7))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB").save(tmp_path / name)
    env = rng.random((4, 8, 3)).astype(np.float32) * 3.0
    write_exr(str(tmp_path / "env.exr"), env, half=False)
    return env


def test_read_bmp_equals_pil(tmp_path):
    """The port's numpy BMP reader against PIL: equal uint8 arrays, for the
    usual bottom-up file and for a top-down one (negative height)."""
    import struct

    from PIL import Image

    from raytracer_tpu_torch.io.bmp import read_bmp, write_bmp

    _write_test_bitmaps(tmp_path)
    for name in ("a.bmp", "b.bmp"):
        path = tmp_path / name
        want = np.asarray(Image.open(path).convert("RGB"))
        assert np.array_equal(read_bmp(str(path)), want), name
        raw = bytearray(path.read_bytes())
        (offset,) = struct.unpack_from("<I", raw, 10)
        w, h = struct.unpack_from("<ii", raw, 18)
        stride = (w * 3 + 3) & ~3
        rows = [bytes(raw[offset + i * stride: offset + (i + 1) * stride]) for i in range(h)]
        raw[offset:offset + h * stride] = b"".join(rows[::-1])
        struct.pack_into("<i", raw, 22, -h)
        top_down = tmp_path / ("td_" + name)
        top_down.write_bytes(bytes(raw))
        assert np.array_equal(np.asarray(Image.open(top_down).convert("RGB")), want)
        assert np.array_equal(read_bmp(str(top_down)), want), name
        write_bmp(str(tmp_path / ("np_" + name)), want)
        assert np.array_equal(np.asarray(Image.open(tmp_path / ("np_" + name)).convert("RGB")), want)
        assert np.array_equal(read_bmp(str(tmp_path / ("np_" + name))), want)
    (tmp_path / "not.bmp").write_bytes(b"PNG" + bytes(60))
    with pytest.raises(ValueError, match="not a BMP"):
        read_bmp(str(tmp_path / "not.bmp"))
    with pytest.raises(ValueError, match="uint8"):
        write_bmp(str(tmp_path / "f.bmp"), np.zeros((2, 2, 3), np.float32))


def test_exr_codec_is_the_reference_copy(tmp_path):
    from raytracer_tpu.io import exr as ref_exr
    from raytracer_tpu_torch.io import exr

    import ast

    def code(path):  # the module without its docstring
        with open(path) as f:
            tree = ast.parse(f.read())
        return ast.dump(ast.Module(tree.body[1:], []))

    assert code(ref_exr.__file__) == code(exr.__file__)
    img = np.random.default_rng(2).random((5, 9, 3)).astype(np.float32)
    for half in (False, True):
        exr.write_exr(str(tmp_path / "x.exr"), img, half=half)
        assert np.array_equal(exr.read_exr(str(tmp_path / "x.exr")), ref_exr.read_exr(str(tmp_path / "x.exr")))
    assert np.array_equal(exr.read_exr(str(tmp_path / "x.exr")), img.astype(np.float16).astype(np.float32))


def _textured_scene_json(tmp_path):
    import json

    _write_test_bitmaps(tmp_path)
    doc = {
        "textures": [
            {"name": "blend", "type": "mix", "textureA": "tiles", "textureB": "speckle", "weight": "board"},
            {"name": "tiles", "type": "bitmap", "path": "a.bmp"},
            {"name": "board", "type": "checkerboard", "colorA": [1, 1, 1], "colorB": [0.1, 0.1, 0.1]},
            {"name": "speckle", "type": "noise", "colorA": [0.9, 0.8, 0.7], "colorB": [0.2, 0.2, 0.3], "octaves": 3},
            {"name": "sky", "type": "bitmap", "path": "env.exr"},
            {"name": "gone", "type": "bitmap", "path": "nowhere.bmp"},
        ],
        "materials": [
            {"name": "floor", "bsdf": "roughPlastic", "baseColor": [0.9, 0.9, 0.9], "baseColorTexture": "blend",
             "roughness": 0.4, "roughnessTexture": "board", "normalMap": "b.bmp", "normalMapStrength": 0.6},
            {"name": "ball", "bsdf": "roughMetal", "baseColorTexture": "tiles", "metalnessTexture": "speckle",
             "emissionTexture": "gone", "maskMap": "nowhere2.bmp"},
        ],
        "objects": [
            {"type": "plane", "size": [4, 4], "textureScale": [0.5, 0.25], "material": "floor",
             "transform": {"orientation": [-90, 0, 0]}},
            {"type": "sphere", "radius": 0.7, "material": "ball", "transform": {"translation": [0, 0.7, 0]}},
        ],
        "lights": [
            {"type": "area", "color": [6, 6, 6], "texture": "board",
             "transform": {"translation": [0, 3, 0], "orientation": [90, 0, 0]},
             "shape": {"type": "rect", "size": [0.5, 0.5]}},
            {"type": "background", "color": [0.8, 0.9, 1.0], "texture": "sky"},
        ],
        "camera": {"transform": {"translation": [0, 1.5, -4], "orientation": [10, 0, 0]}, "fieldOfView": 50.0},
    }
    path = tmp_path / "textured.json"
    path.write_text(json.dumps(doc))
    return str(path)


def assert_same_scene(scene, ref_scene):
    """Bit equality of everything but the atlas pixels, which come from an
    sRGB decode that differs by at most one ulp between the packages
    (tests/test_torch_postprocess.py); EXR pixels are not decoded and so the
    env distribution is bit-equal too."""
    want = to_port(ref_scene)
    assert_same(scene._replace(textures=None), want._replace(textures=None))
    assert_same(scene.textures._replace(data=None), want.textures._replace(data=None), "textures")
    np.testing.assert_allclose(scene.textures.data.numpy(), want.textures.data.numpy(), rtol=0, atol=6e-8)


def test_load_textured_scene_matches_reference(tmp_path):
    """A JSON with a ``textures`` block (a mix declared before its parts, a
    BMP, an EXR, a missing file), materials naming declared textures and bare
    paths, an area and a background light with a ``texture``."""
    path = _textured_scene_json(tmp_path)
    with pytest.warns(UserWarning, match="2 texture file"):
        ref_scene, ref_meta, ref_cam = ref_load_scene(path)
    with pytest.warns(UserWarning, match="2 texture file"):
        scene, meta, cam = load_scene(path, device="cpu")
    assert_same_scene(scene, ref_scene)
    assert meta == to_port(ref_meta)
    assert_same(cam, to_port(ref_cam))
    assert scene.env_dist is not None and scene.env_dist.density.shape == (4, 8)
    assert scene.textures.kinds_present == (0, 1, 2, 3, 4) and scene.textures.max_octaves == 3
    # the BMP went through numpy on this side and PIL on the other: the same texels
    y0, h, w = (int(getattr(scene.textures, f)[1]) for f in ("y0", "height", "width"))
    assert (h, w) == (5, 6)
    from raytracer_tpu_torch.io.bmp import read_bmp, write_bmp

    decoded = scene.textures.data[y0:y0 + h, :w]
    first_row = torch.as_tensor(read_bmp(str(tmp_path / "a.bmp"))[-1].astype(np.float32) / 255.0)
    assert torch.all((decoded[0] > 0.5) == (first_row > 0.7354))  # row 0 is the image's bottom row (raw BMP order)
    with pytest.raises(SceneLoadError, match="texture not found"):
        load_scene(path, strict=True, device="cpu")


def test_other_bitmap_formats_go_through_pil_lazily(tmp_path, monkeypatch):
    import json
    import sys

    from PIL import Image

    Image.fromarray(np.full((2, 2, 3), 128, np.uint8), "RGB").save(tmp_path / "t.png")
    p = tmp_path / "png.json"
    p.write_text(json.dumps({"materials": [{"name": "m", "baseColorTexture": "t.png"}]}))
    scene, _, _ = load_scene(str(p), strict=True, device="cpu")
    ref_scene, _, _ = ref_load_scene(str(p), strict=True)
    assert_same_scene(scene, ref_scene)
    monkeypatch.setitem(sys.modules, "PIL", None)  # a host without PIL
    for strict in (True, False):  # only a file that is not there becomes a placeholder
        with pytest.raises(SceneLoadError, match="needs PIL"):
            load_scene(str(p), strict=strict, device="cpu")


@pytest.mark.parametrize("strict", [True, False])
def test_a_corrupt_bmp_is_an_error_and_not_a_placeholder(tmp_path, strict):
    """A 24-bit BMP cut short raises with the reader's message, also on a host
    without PIL; an 8-bit BMP (another variant) still goes to PIL."""
    import json

    from PIL import Image

    from raytracer_tpu_torch.io.bmp import write_bmp

    write_bmp(str(tmp_path / "t.bmp"), np.full((4, 4, 3), 128, np.uint8))
    whole = (tmp_path / "t.bmp").read_bytes()
    p = tmp_path / "bmp.json"
    p.write_text(json.dumps({"materials": [{"name": "m", "baseColorTexture": "t.bmp"}]}))
    for cut, message in ((len(whole) - 5, "pixel array cut short"), (30, "header cut short")):
        (tmp_path / "t.bmp").write_bytes(whole[:cut])
        with pytest.raises(SceneLoadError, match=message):
            load_scene(str(p), strict=strict, device="cpu")
    Image.fromarray(np.full((4, 4), 77, np.uint8), "L").save(tmp_path / "t.bmp")  # an 8-bit palette file
    scene, _, _ = load_scene(str(p), strict=strict, device="cpu")
    ref_scene, _, _ = ref_load_scene(str(p), strict=strict)
    assert_same_scene(scene, ref_scene)


def test_obj_texture_maps_are_ignored_as_in_the_reference(tmp_path):
    """The same multi-mesh .obj + .mtl with ``map_Kd`` / ``map_bump`` /
    ``map_d`` lines through both loaders: the material tables (and the whole
    scene) are equal, and neither builds an atlas."""
    import json

    (tmp_path / "m.mtl").write_text(
        "newmtl stone\nKd 0.8 0.7 0.6\nmap_Kd stone.bmp\nmap_bump stone_n.bmp\n"
        "newmtl glow\nKd 0.1 0.2 0.3\nKe 2 2 1\nmap_d mask.bmp\nNi 1.33\n"
        "newmtl plain\nKd 0.5 0.5 0.5\n")
    (tmp_path / "a.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\n"
        "usemtl stone\nf 1/1 2/2 3/3\nusemtl glow\nf 2/2 4/4 3/3\n")
    (tmp_path / "b.obj").write_text(
        "mtllib m.mtl\nv 0 0 1\nv 1 0 1\nv 0 1 1\nusemtl plain\nf 1 2 3\nusemtl stone\nf 3 2 1\n")
    p = tmp_path / "two.json"
    p.write_text(json.dumps({
        "materials": [{"name": "base", "bsdf": "diffuse"}],
        "objects": [{"type": "mesh", "path": "a.obj"},
                    {"type": "mesh", "path": "b.obj", "transform": {"translation": [0, 0, 2]}}],
        "lights": [{"type": "background", "color": [1, 1, 1]}]}))
    ref_scene, ref_meta, _ = ref_load_scene(str(p))
    scene, meta, _ = load_scene(str(p), device="cpu")
    assert ref_scene.textures is None and scene.textures is None and scene.env_dist is None
    assert_same(scene.materials, to_port(ref_scene.materials), "materials")
    assert_same(scene, to_port(ref_scene))
    assert meta == to_port(ref_meta)
    assert scene.tris.count == 4 and (scene.materials.base_color_tex == -1).all()


def test_interior_generator_writes_the_reference_bitmaps_without_pil(tmp_path, monkeypatch):
    """``tools/torch_gen_interior.py`` runs ``tools/gen_interior.py`` with a
    numpy BMP writer in place of its PIL one: the three generated bitmaps
    decode to the same pixels either way."""
    from PIL import Image

    import gen_interior
    import torch_gen_interior

    pil_writer = gen_interior._write_bmp
    monkeypatch.setattr(gen_interior, "BENCH_DIR", str(tmp_path / "pil"))
    want = gen_interior._textures(np.random.default_rng(gen_interior.SEED))
    monkeypatch.setattr(gen_interior, "_write_bmp", pil_writer)  # restored after the test
    torch_gen_interior._use(str(tmp_path / "np"))
    got = gen_interior._textures(np.random.default_rng(gen_interior.SEED))
    assert sorted(want) == sorted(got) == ["floor", "marble", "plaster"]
    for k in want:
        assert got[k].startswith(str(tmp_path / "np"))
        assert np.array_equal(np.asarray(Image.open(want[k]).convert("RGB")),
                              np.asarray(Image.open(got[k]).convert("RGB"))), k


def test_small_textured_scene_loads_like_the_reference(tmp_path, monkeypatch):
    """The textured layout of ``torch_gen_interior`` (what the 800k-triangle
    textured interior adds, over two small meshes) through both loaders."""
    import gen_interior
    import torch_gen_interior

    monkeypatch.setattr(gen_interior, "BENCH_DIR", gen_interior.BENCH_DIR)  # restored after the test
    monkeypatch.setattr(gen_interior, "_write_bmp", gen_interior._write_bmp)
    path = torch_gen_interior.ensure_small_textured(str(tmp_path))
    assert torch_gen_interior.ensure_small_textured(str(tmp_path)) == path  # idempotent
    ref_scene, ref_meta, ref_cam = ref_load_scene(path, strict=True)
    scene, meta, cam = load_scene(path, strict=True, device="cpu")
    assert_same_scene(scene, ref_scene)
    assert meta == to_port(ref_meta)
    assert_same(cam, to_port(ref_cam))
    assert scene.tris.count == 450 + 640 and scene.prims.count == 4
    assert scene.textures.kinds_present == (0, 1, 2, 3) and scene.textures.max_octaves == 4
    assert scene.env_dist.density.shape == (64, 128)
    assert (scene.materials.normal_tex >= 0).sum() == 1 and meta.light_kinds == (0, 1)
    # the normal map decodes to unit vectors that point out of the surface
    n = torch_gen_interior.normal_map() * 2.0 - 1.0
    assert np.allclose(np.linalg.norm(n, axis=-1), 1.0) and (n[..., 2] > 0.5).all()
    sky = torch_gen_interior.sky_map()
    assert sky.dtype == np.float32 and sky.max() > 20.0 and sky[-1].max() < 0.2  # a sun above a dim ground


def test_convert_refuses_waiting_fields():
    """A reference object with a field its port type lacks raises instead
    of losing it; the fields that used to wait (decals, velocities, the
    dispersion columns, the camera's shutter pose and bokeh) now carry."""
    from collections import namedtuple

    from raytracer_tpu.scene import types as RT

    ref_scene, _ = ref_presets.cornell_box()
    ref_scene = jax.tree_util.tree_map(np.asarray, ref_scene)
    assert scene_from_numpy(ref_scene, "cpu").prims.vel.x.shape == ref_scene.prims.vel.x.shape
    grown = namedtuple("Primitives", RT.Primitives._fields + ("spin",))(*ref_scene.prims, np.zeros(3, np.float32))
    with pytest.raises(TypeError, match="spin"):
        scene_from_numpy(ref_scene._replace(prims=grown), "cpu")
    cam = ref_make_camera(RefRigidTransform())
    grown_cam = dataclasses.make_dataclass("Camera", [(f.name, object) for f in dataclasses.fields(cam)]
                                           + [("shutter_curve", object)])
    with pytest.raises(TypeError, match="shutter_curve"):
        scene_from_numpy(grown_cam(**{f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)},
                                   shutter_curve=0), "cpu")


@pytest.mark.parametrize("name", ["SceneData", "Primitives", "Triangles", "Materials", "Lights", "Camera",
                                  "SceneMeta", "TextureAtlas", "BVHFlat", "MeshGeom", "Instances", "Decals",
                                  "Rot3", "ClusterSet"])
def test_port_types_hold_every_reference_field(name):
    """The field diff of the two packages' scene types is empty: every field
    of a reference type is a field of the port type of the same name."""
    from raytracer_tpu.scene import clusters as ref_clusters, types as RT
    from raytracer_tpu_torch.scene import convert

    ref_cls = getattr(ref_clusters if name == "ClusterSet" else RT, name)
    port_cls = convert._PORT_TYPES[name]
    missing = set(convert._field_names(ref_cls)) - set(convert._field_names(port_cls))
    assert not missing, missing


def _fx_scene(build_mod, rigid, types_mod):
    """A scene of every effect, built by one package's builder: moving prims
    and a moving instance, dispersive materials in both forms and three
    decals (two of equal order, to pin the stable sort)."""
    b = build_mod.SceneBuilder()
    glass = b.add_material(build_mod.MaterialDesc(name="glass", bsdf="dielectric", ior=1.6, dispersive=True,
                                                  abbe=22.0, disp_use_abbe=True))
    flint = b.add_material(build_mod.MaterialDesc(name="flint", bsdf="roughDielectric", roughness=0.2,
                                                  dispersive=True, dispersion_c=0.0095, dispersion_d=0.0004))
    wall = b.add_material(build_mod.MaterialDesc(name="wall", base_color=(0.6, 0.6, 0.5)))
    b.add_sphere(rigid(translation=(0.0, 0.5, 2.0)), 0.5, glass, velocity=(0.4, 0.0, 0.1))
    b.add_box(rigid(translation=(1.0, 0.3, 2.5), euler_deg=(0, 30, 0)), (0.3, 0.3, 0.3), flint,
              velocity=(0.0, 0.2, 0.0))
    b.add_rect(rigid(translation=(0, 0, 4), euler_deg=(180, 0, 0)), (3.0, 3.0), wall, velocity=(0.0, 0.0, -0.5),
               uv_scale=(2.0, 1.0))
    v = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], [0, 1.5, 0]], np.float64)
    f = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], np.int64)
    mid = b.add_mesh_geometry(v, f, np.tile([[0.0, 1.0, 0.0]], (5, 1)), None, np.full(4, wall))
    b.add_mesh_instance(mid, rigid(translation=(-1.0, 0.0, 3.0)), velocity=(0.3, 0.0, 0.0))
    for order, color, where in ((2, (0.9, 0.1, 0.1), (0, 0, 4)), (0, (0.1, 0.9, 0.1), (0.5, 0, 4)),
                                (2, (0.1, 0.1, 0.9), (-0.5, 0.2, 4))):
        b.add_decal(build_mod.DecalDesc(transform=rigid(translation=where, euler_deg=(0, 0, 15)),
                                        half_size=(0.8, 0.6, 0.3), base_color=color, roughness=0.25,
                                        alpha_min=0.2, alpha_max=0.9, order=order))
    b.add_light(build_mod.LightDesc(kind=types_mod.LIGHT_BACKGROUND, color=(0.5, 0.5, 0.5)))
    return b


def test_builders_carry_every_effect_bit_for_bit():
    """Velocities of prims and instances, the dispersion columns, the
    decal table (sorted by descending order) and the camera's shutter pose
    and bokeh: the two builders' tables equal bit for bit, and so are they
    after scene_from_numpy carried the reference's across."""
    from raytracer_tpu.scene import build as ref_build
    from raytracer_tpu.scene import types as RT
    from raytracer_tpu_torch.scene import build
    from raytracer_tpu_torch.scene import types as T

    ref_scene, ref_meta = _fx_scene(ref_build, RefRigidTransform, RT).build()
    scene, meta = _fx_scene(build, RigidTransform, T).build("cpu")
    carried = to_port(ref_scene)
    assert isinstance(carried.decals, T.Decals)
    assert_same(scene, carried)
    assert meta == to_port(ref_meta)
    assert scene.decals.count == 3 and scene.decals.base_color.y.tolist()[-1] == pytest.approx(0.9)
    assert scene.materials.dispersive.tolist() == [True, True, False]
    assert scene.materials.disp_use_abbe.tolist() == [True, False, False]
    assert scene.prims.vel.z.tolist() == pytest.approx([0.1, 0.0, -0.5])
    kw = dict(fov_deg=50.0, enable_dof=True, aperture=0.05, focal_distance=3.0, bokeh_shape=3, aperture_blades=7)
    end = dict(translation=(0.2, 0.1, -0.3), euler_deg=(2.0, 5.0, 0.0))
    cam = make_camera(RigidTransform(), transform_end=RigidTransform(**end), **kw, device="cpu")
    ref_cam = ref_make_camera(RefRigidTransform(), transform_end=RefRigidTransform(**end), **kw)
    assert_same(cam, to_port(ref_cam))
    assert cam.enable_motion_blur and cam.bokeh_shape == 3 and cam.aperture_blades == 7


def test_loader_reads_the_dispersion_keys_like_the_reference(tmp_path):
    """A JSON material with ``dispersive`` and ``abbe`` (the Abbe form), one
    with ``dispersionC`` / ``dispersionD`` (the Cauchy form) and one with
    neither: the two loaders' material tables equal bit for bit."""
    import json

    p = tmp_path / "disp.json"
    p.write_text(json.dumps({
        "materials": [
            {"name": "crown", "bsdf": "dielectric", "IoR": 1.52, "dispersive": True, "abbe": 58.0},
            {"name": "flint", "bsdf": "roughDielectric", "IoR": 1.62, "dispersive": True, "dispersionC": 0.0091,
             "dispersionD": 0.0003},
            {"name": "plain", "bsdf": "diffuse"},
        ],
        "objects": [{"type": "sphere", "radius": 0.5, "material": "crown"},
                    {"type": "sphere", "radius": 0.3, "material": "flint", "transform": {"translation": [1, 0, 0]}}],
        "lights": [{"type": "background", "color": [1, 1, 1]}]}))
    ref_scene, _, _ = ref_load_scene(str(p))
    scene, _, _ = load_scene(str(p), device="cpu")
    assert_same(scene.materials, to_port(ref_scene.materials), "materials")
    assert scene.materials.disp_use_abbe.tolist() == [True, False, False]
    assert scene.materials.dispersive.tolist() == [True, True, False]
    assert_same(scene, to_port(ref_scene))
