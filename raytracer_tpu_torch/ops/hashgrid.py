"""Uniform hash grid for photon range queries (port of
``raytracer_tpu/ops/hashgrid.py``).

- cell id: a hash of floor(position / cell size), masked to a table of 2^20
  buckets;
- build: a stable argsort of the photons by cell id;
- query: for each of the 8 cells of the 2x2x2 block around a point, a
  binary search of the sorted ids and up to ``max_per_cell`` slots of that
  cell's run.

Everything here is integer work that must equal the reference's bit for
bit: the photons a query keeps are the first ``max_per_cell`` of a cell's
run, so another tie order would keep other photons.  Hashes are held as
int64 values in [0, 2^20), so their order is the reference's uint32 order,
and float-to-int conversions saturate as the reference's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math.vec import Vec3

HASH_BITS = 20  # 1M buckets
TABLE_SIZE = 1 << HASH_BITS
_M32 = 0xFFFFFFFF

# the 2x2x2 neighbourhood in the reference's order: cx, then cy, then cz
_CORNERS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


class HashGrid(NamedTuple):
    cell_ids: torch.Tensor  # (P,) int64 sorted cell hash per photon, in [0, 2^20)
    order: torch.Tensor  # (P,) int64 photon index in sort order
    inv_cell_size: torch.Tensor  # () f32
    counts_clipped: torch.Tensor  # () int32 diagnostics, always 0 as in the reference


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 values (held in int64) as the reference converts:
    saturating, NaN to 0.  A plain ``.to(torch.int32)`` is undefined out of
    range (the CPU gives INT_MIN), and parked photons sit far out of it."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), -2.0 ** 31, 2.0 ** 31)
    return x.to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1)


def _cell_hash(ix, iy, iz):
    """Integer cell hash of int32 cell coords: wrapping uint32 multiplies
    and XOR, masked to the table (products of two uint32 values fit int64)."""
    h = (ix & _M32) * 73856093 ^ (iy & _M32) * 19349663 ^ (iz & _M32) * 83492791
    return h & (TABLE_SIZE - 1)


def _cell_coords(pos: Vec3, inv_cell):
    return tuple(_to_i32(torch.floor(c * inv_cell)) for c in pos)


def build_hash_grid(positions: Vec3, radius) -> HashGrid:
    """Sort-based grid build over P photon positions.  The cell size is
    2 * radius, so a radius-r query sphere overlaps at most the 2x2x2 block
    of cells around its centre."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=positions.x.device)
    inv_cell = 1.0 / torch.clamp_min(2.0 * radius, 1e-8)
    ids = _cell_hash(*_cell_coords(positions, inv_cell))
    order = torch.argsort(ids, stable=True)
    return HashGrid(cell_ids=ids[order], order=order, inv_cell_size=inv_cell,
                    counts_clipped=torch.zeros((), dtype=torch.int32, device=ids.device))


def gather_candidates(grid: HashGrid, query_pos: Vec3, max_per_cell: int = 8):
    """Candidate photon indices near each query point: (idx (N, K),
    in_run (N, K)) with K = 8 * max_per_cell.  For each of the 8 cells of
    the 2x2x2 block picked by the sign of the in-cell offset, up to
    ``max_per_cell`` photons of that cell's sorted run; ``in_run`` masks
    slots past the run's end.  Callers radius-test the gathered positions
    (hash collisions and corner cells give false candidates); photons past
    ``max_per_cell`` in a cell are not seen, as in the reference."""
    inv_cell = grid.inv_cell_size
    p = grid.cell_ids.shape[0]
    base, side = [], []
    for c in query_pos:
        f = c * inv_cell
        b = torch.floor(f)
        side.append(torch.where(f - b > 0.5, 1, -1))
        base.append(_to_i32(b))
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=grid.cell_ids.device)  # (8, 3)
    h = _cell_hash(*(base[a][:, None] + corners[None, :, a] * side[a][:, None] for a in range(3)))  # (N, 8)
    start = torch.searchsorted(grid.cell_ids, h.contiguous())
    pos = start[:, :, None] + torch.arange(max_per_cell, device=h.device)  # (N, 8, M)
    slot = torch.clamp_max(pos, p - 1)
    ok = (pos < p) & (grid.cell_ids[slot] == h[:, :, None])
    n = h.shape[0]
    return grid.order[slot].reshape(n, -1), ok.reshape(n, -1)
