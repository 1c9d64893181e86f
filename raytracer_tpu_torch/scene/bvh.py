"""Host-side BVH build: triangle leaf order and the skip-link traversal
tables (port of ``raytracer_tpu/scene/bvh.py``).

Triangle ids everywhere index the triangles in BVH leaf order, so the port
must reproduce the reference's ``perm``.  It therefore runs its own copy of
the native sweep-SAH builder (``raytracer_tpu_torch/native``), built with
g++ at first use, and raises when that build fails.  Known departure: the
reference falls back to a pure-Python tree builder
(``_build_arrays_python``) when no C++ toolchain is there; the port has no
such fallback, since a slower path could order ties differently.

After the tree is built, ``thread_links`` threads skip links per ray
octant: for each of the 8 direction-sign combinations, a depth-first order
that visits the near child first records ``hit`` (descend) and ``miss``
(skip the subtree).  The walk of ``ops/bvh_traverse.py`` then needs one
int32 of state per ray.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .types import BVHFlat

LEAF_SIZE = 4  # triangles per (padded) leaf


def _native_build(box_min: np.ndarray, box_max: np.ndarray):
    """Native sweep-SAH build of the items with these AABBs.  Returns
    (nodes_box (M, 8), node_first (M,), perm (T,), padded_ids (Tpad,),
    (left, right, axis): (M,) int32 arrays of every node's children, -1 at
    a leaf, and its split axis)."""
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
    tree = np.zeros((3, 2 * n), np.int32)

    def P(a, ty):
        return a.ctypes.data_as(ty)

    m = lib.bvh_build(
        P(bmin, f32p), P(bmax, f32p), ctypes.c_int(n), ctypes.c_int(LEAF_SIZE),
        P(nodes_box, f32p), P(node_first, i32p), P(perm, i32p),
        P(padded_ids, i32p), P(num_padded, i32p), P(tree[0], i32p), P(tree[1], i32p), P(tree[2], i32p),
    )
    if m <= 0:
        raise RuntimeError(f"native BVH build failed (returned {m}) for {n} triangles")
    return (nodes_box[:m], node_first[:m], perm.astype(np.int64), padded_ids[: int(num_padded[0])],
            tuple(tree[:, :m]))


def thread_links(left: np.ndarray, right: np.ndarray, axis: np.ndarray):
    """Per-octant skip links (8, M) hit and miss of the tree whose node i
    has children ``left[i]``, ``right[i]`` (-1 at a leaf) and split axis
    ``axis[i]``, node 0 the root: for each octant, the depth-first order
    that visits the near child first (the right one where the octant's bit
    of the node's axis is set)."""
    from ..native import load_library

    lib = load_library("bvh_builder")
    i32p = ctypes.POINTER(ctypes.c_int32)
    m = left.shape[0]
    lanes = [np.ascontiguousarray(a, np.int32) for a in (left, right, axis)]
    hit = np.zeros((8, m), np.int32)
    miss = np.zeros((8, m), np.int32)
    lib.bvh_thread_links(*(a.ctypes.data_as(i32p) for a in lanes), ctypes.c_int(m),
                         hit.ctypes.data_as(i32p), miss.ctypes.data_as(i32p))
    return hit, miss


def build_bvh_over_triangles(tri_v, tri_n, tri_uv, tri_mat, *, device):
    """Build the BVH and reorder the triangle data to its leaf order.

    Returns ``((v0, e1, e2, normals, uvs, material_ids), bvh)``: host numpy
    arrays in leaf order (what ``SceneBuilder.build`` turns into
    ``Triangles`` and the cluster set) and the ``BVHFlat`` on ``device``,
    built exactly as the reference builds it.  The padded leaf slots name
    reordered triangle ids, so a walk's ``tri_id`` indexes the returned
    arrays directly."""
    nodes_box, node_first, perm, padded_ids, tree = _native_build(tri_v.min(1), tri_v.max(1))
    hit, miss = thread_links(*tree)

    v = tri_v[perm].astype(np.float32)
    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    arrays = (v0, e1, e2, tri_n[perm].astype(np.float32), tri_uv[perm].astype(np.float32),
              tri_mat[perm].astype(np.int32))

    # pads are degenerate all-zero triangles: they can never be hit
    safe_ids = np.maximum(padded_ids, 0)
    padded_geom = np.concatenate([v0[safe_ids], e1[safe_ids], e2[safe_ids]], axis=1).astype(np.float32)
    padded_geom[padded_ids < 0] = 0.0

    # one (9,) row per (octant, node) and one (40,) row per leaf: a walk
    # step reads two rows
    m = nodes_box.shape[0]
    leaf_rows = padded_ids.shape[0] // LEAF_SIZE
    packed = np.zeros((8, m, 9), np.float32)
    packed[:, :, 0:6] = nodes_box[None, :, 0:6]
    leaf_row_of_node = np.where(node_first >= 0, node_first // LEAF_SIZE, -1).astype(np.int32)
    packed[:, :, 6] = leaf_row_of_node[None, :].view(np.float32)
    packed[:, :, 7] = hit.view(np.float32)
    packed[:, :, 8] = miss.view(np.float32)
    leaf_geom = np.zeros((max(leaf_rows, 1), 40), np.float32)
    if leaf_rows:
        leaf_geom[:, 0:36] = padded_geom.reshape(leaf_rows, LEAF_SIZE * 9)
        leaf_geom[:, 36:40] = padded_ids.astype(np.int32).reshape(leaf_rows, LEAF_SIZE).view(np.float32)

    on = lambda a: torch.as_tensor(a, device=device)
    bvh = BVHFlat(
        nodes_box=on(nodes_box),
        node_first_tri=on(node_first),
        hit_link=on(hit),
        miss_link=on(miss),
        tri_geom=on(padded_geom),
        tri_id=on(padded_ids.astype(np.int32)),
        packed_nodes=on(packed.reshape(8 * m, 9)),
        leaf_geom=on(leaf_geom),
    )
    return arrays, bvh


def bvh_stats(bvh: BVHFlat) -> dict:
    """Node, leaf and triangle-slot counts of a BVH."""
    nf = bvh.node_first_tri
    return {
        "num_nodes": int(nf.shape[0]),
        "num_leaves": int((nf >= 0).sum()),
        "padded_tris": int(bvh.tri_id.shape[0]),
        "real_tris": int((bvh.tri_id >= 0).sum()),
    }


def save_bvh(path: str, bvh: BVHFlat) -> None:
    """Write a flattened BVH to ``path`` (a compressed ``.npz``), so that a
    repeat load can skip the build."""
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **{k: v.cpu().numpy() for k, v in bvh._asdict().items()})
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_bvh(path: str, *, device) -> BVHFlat:
    """Load a flattened BVH written by :func:`save_bvh` onto ``device``."""
    with np.load(path, allow_pickle=False) as z:
        return BVHFlat(**{k: torch.as_tensor(z[k], device=device) for k in BVHFlat._fields})
