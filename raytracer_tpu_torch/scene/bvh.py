"""Host-side BVH build: triangle leaf order and the skip-link traversal
tables (port of ``raytracer_tpu/scene/bvh.py``).

Triangle ids everywhere index the triangles in BVH leaf order, so the port
must reproduce the reference's ``perm``.  It therefore runs its own copy of
the native sweep-SAH builder (``raytracer_tpu_torch/native``), built with
g++ at first use.  Where that library cannot be built or loaded it falls
back, as the reference does, to its copy of the reference's pure-Python
builder (``build_sah_tree``, ``_thread_links``, ``_build_arrays_python``),
with one warning line; ``BUILDER_COUNTS`` counts the trees each builder
made.  The two builders agree on the tree's answers (the same hits at the
same t), not necessarily on its order of ties, and so on triangle ids.

After the tree is built, ``thread_links`` threads skip links per ray
octant: for each of the 8 direction-sign combinations, a depth-first order
that visits the near child first records ``hit`` (descend) and ``miss``
(skip the subtree).  The walk of ``ops/bvh_traverse.py`` then needs one
int32 of state per ray.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from ..utils.logger import log_warning
from .types import BVHFlat

LEAF_SIZE = 4  # triangles per (padded) leaf
_INVALID = np.int32(-1)
BUILDER_COUNTS = {"native": 0, "python": 0}  # trees built by each builder in this process


class _BuildNode(NamedTuple):
    box_min: np.ndarray  # (3,)
    box_max: np.ndarray
    left: int  # child index or -1
    right: int
    first: int  # first item in permutation (leaves)
    count: int  # number of items (leaves); 0 for inner
    axis: int  # split axis (inner)


def _surface_area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_sah_tree(box_min: np.ndarray, box_max: np.ndarray, max_leaf: int = LEAF_SIZE):
    """Sweep-SAH binary tree over item AABBs.

    Returns (nodes: list[_BuildNode], permutation: (T,) item order).
    Algorithm mirrors `BVHBuilder::BuildNode` (`BVHBuilder.cpp:117-245`):
    exact sweep over every split position on all three axes.
    """
    n_items = box_min.shape[0]
    centers = 0.5 * (box_min + box_max)
    # per-axis globally sorted item orders; partitions preserve sortedness
    sorted_axes = [np.argsort(centers[:, a], kind="stable").astype(np.int64) for a in range(3)]

    nodes: list[_BuildNode] = []
    perm: list[np.ndarray] = []
    in_left = np.zeros(n_items, bool)  # scratch membership mask

    # explicit stack: (node_index, [sorted_idx_axis0, .._axis1, .._axis2])
    nodes.append(None)  # root placeholder
    stack = [(0, sorted_axes)]
    while stack:
        node_idx, idx_by_axis = stack.pop()
        idx = idx_by_axis[0]
        cnt = idx.shape[0]
        bmin = box_min[idx].min(0)
        bmax = box_max[idx].max(0)

        make_leaf = cnt <= max_leaf
        best = None  # (cost, axis, k)
        if not make_leaf:
            parent_sa = max(_surface_area(bmin, bmax), 1e-30)
            leaf_cost = parent_sa * cnt
            for axis in range(3):
                ids = idx_by_axis[axis]
                lo = box_min[ids]
                hi = box_max[ids]
                # prefix box sweep from the left
                pre_min = np.minimum.accumulate(lo, 0)
                pre_max = np.maximum.accumulate(hi, 0)
                # suffix box sweep from the right
                suf_min = np.minimum.accumulate(lo[::-1], 0)[::-1]
                suf_max = np.maximum.accumulate(hi[::-1], 0)[::-1]
                ks = np.arange(1, cnt)
                cost = (
                    _surface_area(pre_min[:-1], pre_max[:-1]) * ks
                    + _surface_area(suf_min[1:], suf_max[1:]) * (cnt - ks)
                )
                k = int(np.argmin(cost))
                if best is None or cost[k] < best[0]:
                    best = (float(cost[k]), axis, k + 1)
            # no beneficial split and small enough -> leaf (the reference's
            # "leaf if cost not improved" rule, with a hard cap for padding)
            if best[0] >= leaf_cost and cnt <= 2 * max_leaf:
                make_leaf = True

        if make_leaf:
            first = sum(p.shape[0] for p in perm)
            perm.append(idx)
            nodes[node_idx] = _BuildNode(bmin, bmax, -1, -1, first, cnt, 0)
            continue

        _, axis, k = best
        left_ids = idx_by_axis[axis][:k]
        in_left[left_ids] = True
        left_by_axis, right_by_axis = [], []
        for a in range(3):
            ids = idx_by_axis[a]
            m = in_left[ids]
            left_by_axis.append(ids[m])
            right_by_axis.append(ids[~m])
        in_left[left_ids] = False

        li = len(nodes)
        nodes.append(None)
        ri = len(nodes)
        nodes.append(None)
        nodes[node_idx] = _BuildNode(bmin, bmax, li, ri, -1, 0, axis)
        # push right first so left is processed first (stable perm order)
        stack.append((ri, right_by_axis))
        stack.append((li, left_by_axis))

    return nodes, np.concatenate(perm) if perm else np.zeros((0,), np.int64)


def _thread_links(nodes: list[_BuildNode]) -> tuple[np.ndarray, np.ndarray]:
    """Per-octant skip links: hit (descend near-first) and miss (skip)."""
    m = len(nodes)
    hit = np.full((8, m), _INVALID, np.int32)
    miss = np.full((8, m), _INVALID, np.int32)
    for octant in range(8):
        neg = [(octant >> a) & 1 for a in range(3)]  # 1 = ray dir negative on axis
        # iterative DFS threading: (node, continuation)
        stack = [(0, -1)]
        while stack:
            node_idx, cont = stack.pop()
            nd = nodes[node_idx]
            miss[octant, node_idx] = cont
            if nd.left < 0:  # leaf: process tris then continue
                hit[octant, node_idx] = cont
                continue
            near, far = nd.left, nd.right
            if neg[nd.axis]:
                near, far = far, near
            hit[octant, node_idx] = near
            stack.append((far, cont))
            stack.append((near, far))
    return hit, miss


def _build_arrays_python(box_min, box_max):
    """Pure-python build -> flat arrays (fallback when no C++ toolchain)."""
    nodes, perm = build_sah_tree(box_min, box_max)
    hit, miss = _thread_links(nodes)
    m = len(nodes)
    nodes_box = np.zeros((m, 8), np.float32)
    padded_ids = []
    node_first = np.full(m, -1, np.int32)
    cursor = 0
    for i, nd in enumerate(nodes):
        nodes_box[i, 0:3] = nd.box_min
        nodes_box[i, 3:6] = nd.box_max
        if nd.left < 0:
            node_first[i] = cursor
            for j in range(LEAF_SIZE):
                padded_ids.append(nd.first + j if j < nd.count else -1)
            cursor += LEAF_SIZE
    return nodes_box, node_first, hit, miss, perm, np.asarray(padded_ids, np.int32)


def _build_arrays_native(box_min, box_max):
    """The native build and its links as ``_build_arrays_python`` returns
    them; None (and one warning) where the library cannot be built or
    loaded."""
    from ..native import load_library

    try:
        load_library("bvh_builder")
    except (RuntimeError, OSError) as e:
        log_warning("native BVH builder unavailable (%s); building %d items with the pure-Python builder "
                    "(scene/bvh.py::_build_arrays_python)", str(e).splitlines()[0], box_min.shape[0])
        return None
    nodes_box, node_first, perm, padded_ids, tree = _native_build(box_min, box_max)
    hit, miss = thread_links(*tree)
    return nodes_box, node_first, hit, miss, perm, padded_ids


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
    built as the reference builds it.  The padded leaf slots name
    reordered triangle ids, so a walk's ``tri_id`` indexes the returned
    arrays directly."""
    box_min, box_max = tri_v.min(1), tri_v.max(1)
    arrays = _build_arrays_native(box_min, box_max)
    BUILDER_COUNTS["native" if arrays is not None else "python"] += 1
    if arrays is None:
        arrays = _build_arrays_python(box_min, box_max)
    nodes_box, node_first, hit, miss, perm, padded_ids = arrays

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
