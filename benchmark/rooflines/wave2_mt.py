"""Roofline count of one launch of ``csrc/wave2_mt.cu`` through
``ops/wave2_traverse.py::mt_chunks``, from the launch's own inputs.

The work counted is what the inputs need, not what the kernel does:

- operations: 25 for each slab test of a live pair lane (a chunk that
  names a real super, a lane with a nonzero limit) against each of its
  super's 8 sub-boxes, and 55 for each Möller-Trumbore test of such a lane
  against each real triangle (id >= 0) of a sub whose box the lane's ray
  enters before its limit;
- bytes: each input read once (the chunk table, every pair slot's 7
  floats, each distinct live super's triangles and sub-boxes) and each of
  the 5 outputs of every pair slot written once.

The card's peaks (NVIDIA's H100 SXM data sheet): 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s of HBM.  The least time of a launch is
the larger of operations over the first and bytes over the second.
"""

from __future__ import annotations

import torch

MODULE = "raytracer_tpu_torch.ops.wave2_traverse"
ATTR = "mt_chunks"
KERNEL = "wave2_mt"  # a device kernel whose name holds this is timed
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SUB_PER_SUPER = 8


def _inv(d):
    return 1.0 / torch.where(torch.abs(d) > 1e-12, d, torch.where(d >= 0, 1e-12, -1e-12))


@torch.no_grad()
def count(args, kwargs) -> tuple[float, float]:
    """(operations, bytes) of one launch ``mt_chunks(block_cluster,
    super_geom, super_sbox, ox, oy, oz, dx, dy, dz, tl, any_hit)``."""
    block_cluster, super_geom, super_sbox, ox, oy, oz, dx, dy, dz, tl = args[:10]
    cs = super_geom.shape[0]
    k = super_geom.shape[1] // SUB_PER_SUPER
    live_chunk = block_cluster < cs
    c = torch.clamp(block_cluster, 0, cs - 1).long()
    tla = torch.abs(tl)
    lane = (tla > 0.0) & live_chunk[:, None, None]  # (B2, R, 128)
    box_tests = float(lane.sum()) * SUB_PER_SUPER
    sbox = super_sbox[c]  # (B2, 8, 8): min xyz, max xyz, -, -
    e = lambda a: a[:, :, None, :]
    sb = lambda q: sbox[:, None, :, q, None]
    t1x, t2x = (sb(0) - e(ox)) * e(_inv(dx)), (sb(3) - e(ox)) * e(_inv(dx))
    t1y, t2y = (sb(1) - e(oy)) * e(_inv(dy)), (sb(4) - e(oy)) * e(_inv(dy))
    t1z, t2z = (sb(2) - e(oz)) * e(_inv(dz)), (sb(5) - e(oz)) * e(_inv(dz))
    near = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z))
    far = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z))
    enters = (far >= torch.clamp_min(near, 0.0)) & (near < e(tla)) & e(lane)  # (B2, R, 8, 128)
    tris = (super_geom[:, :, 9] >= 0.0).reshape(cs, SUB_PER_SUPER, k).sum(-1).to(torch.float64)  # (Cs, 8)
    mt_tests = float((enters.sum((1, 3)).to(torch.float64) * tris[c]).sum())
    supers = torch.unique(c[live_chunk]).numel()
    pair_slots = tl.numel()
    bytes_in = (block_cluster.numel() * 4 + pair_slots * 7 * 4
                + supers * (super_geom.shape[1] * super_geom.shape[2] + SUB_PER_SUPER * super_sbox.shape[2]) * 4)
    bytes_out = pair_slots * 5 * 4
    return 25.0 * box_tests + 55.0 * mt_tests, float(bytes_in + bytes_out)


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time and which bound sets it."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
