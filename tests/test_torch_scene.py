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
    """Bit equality of two port-side structures (tensors, tuples, scalars)."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
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
    import json

    p = tmp_path / "tex.json"
    p.write_text(json.dumps({"materials": [{"name": "m", "baseColorTexture": "a.bmp"}]}))
    with pytest.raises(SceneLoadError, match="ROADMAP"):
        load_scene(str(p), device="cpu")
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    p.write_text(json.dumps({"objects": [{"type": "mesh", "path": str(obj)},
                                         {"type": "mesh", "path": str(obj)}]}))
    with pytest.raises(SceneLoadError, match="instancing"):
        load_scene(str(p), device="cpu")


def test_convert_refuses_waiting_fields():
    ref_scene, _ = ref_presets.cornell_box()
    with pytest.raises(NotImplementedError, match="decals"):
        scene_from_numpy(jax.tree_util.tree_map(np.asarray, ref_scene._replace(decals=("x",))), "cpu")
