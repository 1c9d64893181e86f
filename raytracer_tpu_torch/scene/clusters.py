"""Cluster acceleration structure of the mesh traversal engines (port of
``raytracer_tpu/scene/clusters.py``).

Triangles are sorted by the Morton code of their centroid and cut into
clusters of K consecutive triangles.  Three engines read the set:

- ``cluster`` (``ops/cluster_traverse.py``) and the block-candidate kernels
  (``ops/pallas_traverse.py``) slab-test rays against the cluster boxes
  (``box_min_*`` / ``box_max_*``) or walk the complete 8-ary box tree over
  them (``tree_levels``), then run Möller-Trumbore over one cluster's
  ``tri_block`` / ``tri_id`` rows, or over its packed ``stream_block`` tile;
- wave2 groups 8 Morton-consecutive clusters into a super-cluster
  (``super_box``, component-major ``super_geom``, sub boxes ``super_sbox``).

The packing is host numpy and bit-identical to the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SUB_PER_SUPER = 8


class ClusterSet(NamedTuple):
    """Device tensors: C clusters of K padded triangle slots, in Cs
    super-clusters of 8."""

    box_min_x: torch.Tensor  # (C,) f32 cluster AABBs
    box_min_y: torch.Tensor
    box_min_z: torch.Tensor
    box_max_x: torch.Tensor
    box_max_y: torch.Tensor
    box_max_z: torch.Tensor
    tri_block: torch.Tensor  # (C, K*9) f32: K x (v0, e1, e2); degenerate pads
    tri_id: torch.Tensor  # (C, K) int32 leaf-order triangle ids, -1 = pad
    # complete 8-ary tree over the Morton-ordered clusters: level i holds
    # 8^(i+1) nodes, node j's children are nodes [8j, 8j+8) of level i+1, the
    # last level's node j covers cluster j.  Tuple of (Ni, 6) f32
    # [min.xyz, max.xyz]; empty (padding) nodes have min > max
    tree_levels: tuple
    # (C, T*8, 128) f32, one cluster per tile; flat layout [0:9K) geometry,
    # [9K:10K) ids as f32 values (-1 = pad), [10K:10K+6) the cluster box
    stream_block: torch.Tensor
    super_box: torch.Tensor  # (Cs, 6) f32 [min.xyz, max.xyz]; empty: min > max
    # (Cs, 8K, 16) f32 component-major geometry, rows [s*K, (s+1)*K) = sub s,
    # lanes [v0.xyz, e1.xyz, e2.xyz, tri_id, pad]
    super_geom: torch.Tensor
    super_sbox: torch.Tensor  # (Cs, 8, 8) f32 sub boxes [min.xyz, max.xyz, 0, 0]
    # (T, 16) f32 input-order shading attributes [n0, n1, n2, uv0, uv1, uv2,
    # material_id, pad], or None
    tri_attr: torch.Tensor = None

    @property
    def num_supers(self) -> int:
        return self.super_box.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.tri_id.shape[0]

    @property
    def tris_per_cluster(self) -> int:
        return self.tri_id.shape[1]


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """30-bit Morton code from 10-bit quantized coords."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def build_clusters(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, k: int = 64,
    normals: np.ndarray = None, uvs: np.ndarray = None,
    material_ids: np.ndarray = None, *, device,
) -> ClusterSet:
    """Cluster triangle arrays by centroid Morton code.  ``tri_id`` indexes
    the INPUT order; ``normals`` (T,3,3) / ``uvs`` (T,3,2) /
    ``material_ids`` (T,) fill the ``tri_attr`` table."""
    t = v0.shape[0]
    centroid = v0 + (e1 + e2) / 3.0
    lo = centroid.min(0)
    hi = centroid.max(0)
    scale = 1023.0 / np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroid - lo) * scale), 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable")

    v0o, e1o, e2o = v0[order], e1[order], e2[order]
    c = (t + k - 1) // k
    pad = c * k - t
    geom = np.concatenate([v0o, e1o, e2o], axis=1).astype(np.float32)  # (t, 9)
    if pad:
        geom = np.concatenate([geom, np.zeros((pad, 9), np.float32)], 0)
    ids = np.concatenate([order.astype(np.int32), np.full(pad, -1, np.int32)])

    blocks = geom.reshape(c, k, 9)
    # cluster bounds from member triangle AABBs (pads contribute nothing)
    verts = np.stack(
        [blocks[..., 0:3], blocks[..., 0:3] + blocks[..., 3:6], blocks[..., 0:3] + blocks[..., 6:9]],
        axis=2,
    )  # (c, k, 3, 3)
    valid = (ids.reshape(c, k) >= 0)[..., None, None]
    vmin = np.where(valid, verts, np.inf).min(axis=(1, 2))
    vmax = np.where(valid, verts, -np.inf).max(axis=(1, 2))

    super_box, super_geom, super_sbox = _pack_super_clusters(
        blocks.reshape(c, k * 9), ids.reshape(c, k), vmin, vmax
    )
    tri_attr = _pack_tri_attr(t, normals, uvs, material_ids)
    dev = lambda a: torch.as_tensor(a).to(device)
    vmin, vmax = vmin.astype(np.float32), vmax.astype(np.float32)
    return ClusterSet(
        box_min_x=dev(vmin[:, 0]), box_min_y=dev(vmin[:, 1]), box_min_z=dev(vmin[:, 2]),
        box_max_x=dev(vmax[:, 0]), box_max_y=dev(vmax[:, 1]), box_max_z=dev(vmax[:, 2]),
        tri_block=dev(blocks.reshape(c, k * 9)),
        tri_id=dev(ids.reshape(c, k)),
        tree_levels=tuple(dev(level) for level in _build_cluster_tree(vmin, vmax)),
        stream_block=dev(_pack_stream_blocks(blocks.reshape(c, k * 9), ids.reshape(c, k), vmin, vmax)),
        super_box=dev(super_box),
        super_geom=dev(super_geom),
        super_sbox=dev(super_sbox),
        tri_attr=dev(tri_attr) if tri_attr is not None else None,
    )


def _pack_tri_attr(t, normals, uvs, material_ids):
    """(T, 16) input-order shading attribute table, or None."""
    if normals is None and uvs is None and material_ids is None:
        return None
    out = np.zeros((max(t, 1), 16), np.float32)
    if normals is not None:
        out[:t, 0:9] = np.asarray(normals, np.float32).reshape(t, 9)
    if uvs is not None:
        out[:t, 9:15] = np.asarray(uvs, np.float32).reshape(t, 6)
    if material_ids is not None:
        out[:t, 15] = np.asarray(material_ids, np.float32)
    return out


def _pack_super_clusters(tri_block: np.ndarray, tri_id: np.ndarray, vmin: np.ndarray, vmax: np.ndarray):
    """Group 8 Morton-consecutive clusters into one super-cluster and pack
    its component-major geometry and 8 sub boxes (host numpy)."""
    c, k9 = tri_block.shape
    k = tri_id.shape[1]
    cs = (c + SUB_PER_SUPER - 1) // SUB_PER_SUPER
    cpad = cs * SUB_PER_SUPER - c
    if cpad:
        tri_block = np.concatenate([tri_block, np.zeros((cpad, k9), np.float32)])
        tri_id = np.concatenate([tri_id, np.full((cpad, k), -1, np.int32)])
        vmin = np.concatenate([vmin, np.full((cpad, 3), np.float32(3e38))])
        vmax = np.concatenate([vmax, np.full((cpad, 3), np.float32(-3e38))])
    smin = vmin.reshape(cs, SUB_PER_SUPER, 3).min(1)
    smax = vmax.reshape(cs, SUB_PER_SUPER, 3).max(1)
    super_box = np.concatenate([smin, smax], axis=1).astype(np.float32)
    sb = np.concatenate(
        [vmin.reshape(cs, SUB_PER_SUPER, 3), vmax.reshape(cs, SUB_PER_SUPER, 3)], axis=2
    )  # (cs, 8, 6)
    geom = np.zeros((cs, SUB_PER_SUPER * k, 16), np.float32)
    geom[:, :, :9] = tri_block.reshape(cs, SUB_PER_SUPER * k, 9)
    geom[:, :, 9] = tri_id.reshape(cs, SUB_PER_SUPER * k).astype(np.float32)
    sbox = np.zeros((cs, SUB_PER_SUPER, 8), np.float32)
    sbox[:, :, :6] = sb
    return super_box, geom, sbox


def _pack_stream_blocks(tri_block: np.ndarray, tri_id: np.ndarray, vmin: np.ndarray, vmax: np.ndarray):
    """Pack (geometry, ids, cluster box) of each cluster into whole tiles of
    (8, 128) floats: [0:9K) geometry, [9K:10K) ids as f32 values (exact to
    2^24; -1 = pad), [10K:10K+6) cluster AABB min.xyz / max.xyz."""
    c, k9 = tri_block.shape
    k = tri_id.shape[1]
    flat_len = k9 + k + 6
    tiles = (flat_len + 1023) // 1024
    out = np.zeros((c, tiles * 1024), np.float32)
    out[:, :k9] = tri_block
    out[:, k9: k9 + k] = tri_id.astype(np.float32)
    out[:, k9 + k: k9 + k + 3] = vmin
    out[:, k9 + k + 3: k9 + k + 6] = vmax
    return out.reshape(c, tiles * 8, 128)


def _build_cluster_tree(vmin: np.ndarray, vmax: np.ndarray) -> tuple:
    """Complete 8-ary box tree over the Morton-ordered cluster boxes: 8
    consecutive nodes per parent; the last level is the clusters padded to a
    power of 8 with empty boxes (min > max, no ray hits them)."""
    c = vmin.shape[0]
    depth = 1
    while 8 ** depth < c:
        depth += 1
    cap = 8 ** depth
    lo = np.full((cap, 3), np.float32(3e38))
    hi = np.full((cap, 3), np.float32(-3e38))
    lo[:c] = vmin
    hi[:c] = vmax
    levels = [np.concatenate([lo, hi], axis=1).astype(np.float32)]
    while levels[0].shape[0] > 8:
        grp = levels[0].reshape(levels[0].shape[0] // 8, 8, 6)
        parent = np.concatenate([grp[:, :, 0:3].min(axis=1), grp[:, :, 3:6].max(axis=1)], axis=1)
        levels.insert(0, parent.astype(np.float32))
    return tuple(levels)
