"""``o = x + 1`` as a hand-written kernel: the dispatch probe (port of the
``triv`` / ``triv_grid`` Pallas probes of ``tools/probe_r4.py``).

The kernel exists to measure what launching a kernel of the port's own costs
on the card, as one launch of a grid sized to the card that strides over the
whole array and as one thread block per 1,024 elements;
``tools/torch_probe_launch.py`` times both beside the same sum through
PyTorch and beside ``empty_launch``, a kernel that does nothing.  Nothing on a
render path calls it.
"""

from __future__ import annotations

import torch

from .cuda_build import launch


def add_one_reference(x):
    """Plain PyTorch version of ``csrc/add_one.cu``."""
    return x + 1.0


def add_one(x, grid: bool = False):
    """``x + 1`` for a contiguous float32 tensor.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/add_one.cu`` as one block per SM
    striding over the array (``grid=False``) or as one thread block per
    1,024 elements (``grid=True``), or raise.  The kernel moves 16 bytes at a time where
    both pointers allow it and single floats elsewhere."""
    if x.device.type == "cpu":
        return add_one_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"add_one: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() >= 2 ** 31:
        raise ValueError("add_one: input does not match the kernel's dtype, size or layout")
    out = torch.empty_like(x)
    launch("add_one", "add_one_launch", x, out, x.numel(), grid, device=x.device)
    return out


def empty_launch(device):
    """Launch ``csrc/empty_launch.cu``, a kernel that does nothing, on
    ``device``'s current stream: what a launch costs when the kernel costs
    nothing.  CUDA devices only."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_launch: unsupported device {device}")
    launch("empty_launch", "empty_launch", device=device)
