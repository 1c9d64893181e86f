"""The port's float32 square roots and its pure-Python BVH builder against
the JAX package's, on the CPU.

Roots: torch's float32 ``sqrt`` on the CPU is an ulp off in ~0.6% of lanes,
where XLA's (and CUDA's) is correctly rounded, so every float32 root of the
port goes through ``math/vec.py::sqrt_rn``.  Over 2^20 seeded lanes,
against the JAX functions run op by op (eager): ``sqrt_rn``, its gradient
(JAX's ``g * (0.5 / sqrt(x))``), ``normalize`` and the samplers that take a
root are bit-equal.  XLA's and torch's ``sin`` / ``cos`` differ in the last
bit in ~8% of lanes, so the samplers that also call them (cosine
hemisphere, cone, disk, sphere) run here with XLA's ``sin`` / ``cos`` put
into the port: what remains is the root and the arithmetic around it.

Builder: the port's copy of the reference's ``build_sah_tree`` is held node
for node, and ``_build_arrays_python`` array for array, on three small
meshes; ``build_bvh_over_triangles`` falls back to it (one warning) where
the native library cannot be built or loaded, and the walk over that tree
finds the native tree's hits at the same t, bit for bit.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.math import sampling as ref_sampling
from raytracer_tpu.math import vec as ref_vec
from raytracer_tpu.scene import bvh as ref_bvh
from raytracer_tpu_torch import native
from raytracer_tpu_torch.math import sampling, vec
from raytracer_tpu_torch.ops import bvh_traverse as bt
from raytracer_tpu_torch.scene import bvh as port_bvh

N = 1 << 20


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _roots_input(seed=0):
    """Non-negative normal float32 lanes over all magnitudes, the edges
    first.  No denormals: XLA:CPU reads a denormal input as 0, which is
    flushing, not rounding (CUDA's root takes them as they are)."""
    rng = np.random.default_rng(seed)
    x = (rng.random(N) * 10.0 ** rng.uniform(-37, 38, N)).astype(np.float32)
    x = np.where(x < np.finfo(np.float32).tiny, np.float32(1.0), x)
    x[:8] = [0.0, np.finfo(np.float32).tiny, 1.0, 2.0, 3.4028235e38, np.inf, 0.25, 1.5]
    return x


def test_sqrt_rn_is_xla_sqrt_bit_for_bit():
    x = _roots_input()
    want = np.asarray(jnp.sqrt(jnp.asarray(x)))
    assert np.array_equal(_bits(vec.sqrt_rn(torch.as_tensor(x)).numpy()), _bits(want))
    # the fault it repairs: torch's float32 root on the CPU rounds otherwise in some lanes
    assert np.mean(_bits(torch.sqrt(torch.as_tensor(x)).numpy()) != _bits(want)) < 0.02
    # float64 (the gradient checks' float64 runs) takes torch's root, which is correctly rounded there
    x64 = torch.as_tensor(x[:4096], dtype=torch.float64)
    assert torch.equal(vec.sqrt_rn(x64), torch.sqrt(x64))


def test_sqrt_rn_gradient_is_jaxs():
    x = _roots_input(1)
    x = x[(x > 1e-30) & (x < 1e30)][: 1 << 16]
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(jnp.sqrt, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.as_tensor(x).requires_grad_()
    y = vec.sqrt_rn(xt)
    assert np.array_equal(_bits(y.detach().numpy()), _bits(np.asarray(jnp.sqrt(jnp.asarray(x)))))
    (got,) = torch.autograd.grad(y, xt, torch.as_tensor(g))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_normalize_bit_equal():
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(3, N)) * rng.uniform(0.01, 100.0, N)).astype(np.float32)
    for eps in (0.0, 1e-20):
        want = ref_vec.normalize(ref_vec.Vec3(*map(jnp.asarray, a)), eps=eps)
        got = vec.normalize(vec.Vec3(*map(torch.as_tensor, a)), eps=eps)
        for w, g in zip(want, got):
            assert np.array_equal(_bits(g.numpy()), _bits(w))


def _xla(fn):
    return lambda x: torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))


SAMPLERS = {
    "cosine hemisphere": (lambda m, u: m.sample_hemisphere_cos(u[0], u[1]), 2),
    "cone": (lambda m, u: m.sample_cone(u[2], u[0], u[1]), 3),
    "disk": (lambda m, u: m.sample_circle(u[0], u[1]), 2),
    "sphere": (lambda m, u: m.sample_sphere(u[0], u[1]), 2),
    "triangle barycentric": (lambda m, u: m.sample_triangle_barycentric(u[0], u[1]), 2),
}


@pytest.mark.parametrize("name", SAMPLERS)
def test_root_samplers_bit_equal(name):
    fn, dims = SAMPLERS[name]
    u = np.random.default_rng(4).random((dims, N), dtype=np.float32)
    u[:, :4] = np.array([0.0, 1.0 - 2**-24, 0.5, 2**-24], np.float32)
    want = fn(ref_sampling, [jnp.asarray(x) for x in u])
    with mock.patch.object(torch, "sin", _xla(jnp.sin)), mock.patch.object(torch, "cos", _xla(jnp.cos)):
        got = fn(sampling, [torch.as_tensor(x) for x in u])
    for w, g in zip(want, got):
        assert np.array_equal(_bits(g.numpy()), _bits(w))


# --- the pure-Python BVH builder ---------------------------------------------------


def _random_tris(t, seed):
    rng = np.random.default_rng(seed)
    v = (rng.uniform(-10.0, 10.0, (t, 1, 3)) + rng.normal(0, 0.5, (t, 3, 3))).astype(np.float32)
    return v, rng.normal(size=(t, 3, 3)).astype(np.float32), rng.random((t, 3, 2)).astype(np.float32), \
        rng.integers(0, 4, t).astype(np.int32)


MESHES = ((40, 0), (300, 1), (1500, 2))


@pytest.mark.parametrize("t,seed", MESHES)
def test_build_sah_tree_node_for_node(t, seed):
    v = _random_tris(t, seed)[0]
    ref_nodes, ref_perm = ref_bvh.build_sah_tree(v.min(1), v.max(1))
    nodes, perm = port_bvh.build_sah_tree(v.min(1), v.max(1))
    assert np.array_equal(perm, ref_perm) and len(nodes) == len(ref_nodes) > 1
    for a, b in zip(nodes, ref_nodes):
        assert np.array_equal(a.box_min, b.box_min) and np.array_equal(a.box_max, b.box_max)
        assert a[2:] == b[2:]


@pytest.mark.parametrize("t,seed", MESHES)
def test_build_arrays_python_array_for_array(t, seed):
    v = _random_tris(t, seed)[0]
    want = ref_bvh._build_arrays_python(v.min(1), v.max(1))
    got = port_bvh._build_arrays_python(v.min(1), v.max(1))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _unbuildable(name):
    raise RuntimeError("g++ could not build it (test)")


def test_fallback_builds_with_python_and_walks_to_the_native_trees_t():
    v, n, uv, mat = _random_tris(1500, 5)
    counts = dict(port_bvh.BUILDER_COUNTS)
    _, native_bvh = port_bvh.build_bvh_over_triangles(v, n, uv, mat, device="cpu")
    with mock.patch.object(native, "load_library", _unbuildable), mock.patch.object(port_bvh, "log_warning") as warn:
        arrays, py_bvh = port_bvh.build_bvh_over_triangles(v, n, uv, mat, device="cpu")
    assert port_bvh.BUILDER_COUNTS == {"native": counts["native"] + 1, "python": counts["python"] + 1}
    assert warn.call_count == 1 and "_build_arrays_python" in warn.call_args[0][0]
    # the same arrays as the reference's Python-built BVH
    ref_tris, ref_py = _reference_python_build(v, n, uv, mat)
    assert np.array_equal(py_bvh.packed_nodes.numpy().view(np.int32), np.asarray(ref_py.packed_nodes).view(np.int32))
    assert np.array_equal(py_bvh.leaf_geom.numpy().view(np.int32), np.asarray(ref_py.leaf_geom).view(np.int32))
    assert np.array_equal(arrays[0], np.stack([np.asarray(c) for c in ref_tris.v0], -1))

    rng = np.random.default_rng(6)
    o = rng.uniform(-12.0, 12.0, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = lambda a: vec.Vec3(*(torch.as_tensor(a[:, i].copy()) for i in range(3)))
    tmax = torch.full((4096,), 3.0e38)
    a = bt.bvh_walk_reference(native_bvh, ray(o), ray(d), tmax, any_hit=False)
    b = bt.bvh_walk_reference(py_bvh, ray(o), ray(d), tmax, any_hit=False)
    assert int((a.tri >= 0).sum()) > 500
    assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32)) and torch.equal(a.tri >= 0, b.tri >= 0)
    occ = [bt.bvh_walk_reference(x, ray(o), ray(d), torch.full((4096,), 6.0), any_hit=True).occluded
           for x in (native_bvh, py_bvh)]
    assert torch.equal(*occ)


def _reference_python_build(v, n, uv, mat):
    with mock.patch.object(ref_bvh, "_build_arrays_native", lambda *a: None):
        return ref_bvh.build_bvh_over_triangles(v, n, uv, mat)
