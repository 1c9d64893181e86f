"""Super-cluster acceleration structure for the wave2 engine (port of
``raytracer_tpu/scene/clusters.py``).

Triangles are sorted by the Morton code of their centroid and cut into
clusters of K consecutive triangles; 8 Morton-consecutive clusters form a
super-cluster.  Phase 1 of the wave2 engine slab-tests rays against the
super boxes; the MT kernel then streams one super's component-major
geometry and gates its 8 sub-cluster boxes.  The packing is host numpy
and bit-identical to the reference; ``stream_block`` and ``tree_levels``
serve only the ``pallas_traverse`` kernels and wait with them (ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SUB_PER_SUPER = 8


class ClusterSet(NamedTuple):
    """Device tensors of Cs super-clusters of 8 x K triangle slots."""

    tri_id: torch.Tensor  # (C, K) int32 leaf-order triangle ids, -1 = pad
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
    return ClusterSet(
        tri_id=dev(ids.reshape(c, k)),
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
