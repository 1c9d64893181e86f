"""The wave2_mt roofline count on a hand-built launch."""

import pytest
import torch

from harness import cells


def launch():
    """Two chunks of 8 rows x 128 pair lanes: chunk 0 names super 0,
    chunk 1 the sentinel (no super).  Super 0's sub 0 is the box
    [-1, 1]^3 and holds 2 real triangles; its other subs sit far away.
    Chunk 0 has 4 live lanes: 3 aim through sub 0, 1 aims past every sub;
    the rest are filler (limit 0)."""
    cs, k = 1, 8
    geom = torch.zeros((cs, 8 * k, 16))
    geom[..., 9] = -1.0
    geom[0, 0, 9], geom[0, 1, 9] = 0.0, 1.0
    sbox = torch.zeros((cs, 8, 8))
    sbox[0, :, 0:3], sbox[0, :, 3:6] = 10.0, 11.0
    sbox[0, 0, 0:3], sbox[0, 0, 3:6] = -1.0, 1.0
    shape = (2, 8, 128)
    ox, oy, oz = torch.zeros(shape), torch.zeros(shape), torch.full(shape, -5.0)
    dx, dy, dz = torch.zeros(shape), torch.zeros(shape), torch.ones(shape)
    tl = torch.zeros(shape)
    tl[0, 0, :3] = 5.0
    tl[0, 3, 7] = -5.0  # an any-hit lane aimed up, past every sub
    dy[0, 3, 7], dz[0, 3, 7] = 1.0, 0.0
    tl[1] = 5.0  # lanes of the sentinel chunk need nothing
    return (torch.tensor([0, 1], dtype=torch.int32), geom, sbox, ox, oy, oz, dx, dy, dz, tl, False), {}


def test_count_of_a_hand_built_launch():
    mod = cells.rooflines()["wave2_mt"]
    ops, nbytes = mod.count(*launch())
    assert ops == 25 * (4 * 8) + 55 * (3 * 2)
    pair_slots = 2 * 8 * 128
    assert nbytes == 2 * 4 + pair_slots * 7 * 4 + (64 * 16 + 8 * 8) * 4 + pair_slots * 5 * 4


def test_least_time_names_its_bound():
    mod = cells.rooflines()["wave2_mt"]
    t, which = mod.least_seconds(67e12, 1.0)
    assert which == "operations" and t == pytest.approx(1.0)
    t, which = mod.least_seconds(1.0, 3.35e12)
    assert which == "bytes" and t == pytest.approx(1.0)
