"""Host-side BVH build, kept for the triangle order it fixes (port of
``raytracer_tpu/scene/bvh.py``, host build only).

Triangle ids everywhere index the triangles in BVH leaf order, so the port
must reproduce the reference's ``perm``.  It therefore runs its own copy of
the native sweep-SAH builder (``raytracer_tpu_torch/native``), built with
g++ at first use, and raises when that build fails instead of taking a
slower path that could order ties differently.  The packed traversal
tables (``BVHFlat``) wait for the ``bvh`` traversal backend.
"""

from __future__ import annotations

import ctypes

import numpy as np

LEAF_SIZE = 4  # triangles per (padded) leaf


def build_perm(box_min: np.ndarray, box_max: np.ndarray) -> np.ndarray:
    """(T,) int64 leaf-order permutation of the items with these AABBs."""
    from ..native import load_library

    lib = load_library("bvh_builder")  # raises when g++ cannot build it
    n = box_min.shape[0]
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    bmin = np.ascontiguousarray(box_min, np.float32)
    bmax = np.ascontiguousarray(box_max, np.float32)
    nodes_box = np.zeros((2 * n, 8), np.float32)
    node_first = np.zeros(2 * n, np.int32)
    perm = np.zeros(n, np.int32)
    padded_ids = np.zeros(4 * n, np.int32)
    num_padded = np.zeros(1, np.int32)

    def P(a, ty):
        return a.ctypes.data_as(ty)

    m = lib.bvh_build(
        P(bmin, f32p), P(bmax, f32p), ctypes.c_int(n), ctypes.c_int(LEAF_SIZE),
        P(nodes_box, f32p), P(node_first, i32p), P(perm, i32p),
        P(padded_ids, i32p), P(num_padded, i32p),
    )
    if m <= 0:
        raise RuntimeError(f"native BVH build failed (returned {m}) for {n} triangles")
    return perm.astype(np.int64)


def build_bvh_over_triangles(tri_v, tri_n, tri_uv, tri_mat):
    """Reorder triangle data to BVH leaf order.

    Returns host numpy arrays ``(v0, e1, e2, normals, uvs, material_ids)``
    in leaf order — what ``SceneBuilder.build`` turns into ``Triangles``
    and the cluster set."""
    perm = build_perm(tri_v.min(1), tri_v.max(1))
    v = tri_v[perm].astype(np.float32)
    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    return (
        v0, e1, e2,
        tri_n[perm].astype(np.float32),
        tri_uv[perm].astype(np.float32),
        tri_mat[perm].astype(np.int32),
    )
