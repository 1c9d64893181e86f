"""The photon hash grid of the port against the JAX package's.

Integer work, held bit for bit: the cell hashes, the stable sort order, the
inverse cell size, and the candidate indices and run masks of queries.  The
photon sets hold cells with more than ``max_per_cell`` photons (where the
tie order decides which photons a query keeps), two cells whose hashes
collide, photons parked at 3e18 (as VCM parks its invalid ones), negative
coordinates, and query points out where the float-to-int conversion
saturates.  No tolerance: every compared field is equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.math.vec import Vec3 as RefVec3
from raytracer_tpu.ops import hashgrid as ref_hg
from raytracer_tpu_torch.math.vec import Vec3
from raytracer_tpu_torch.ops import hashgrid as hg

RADIUS = np.float32(0.05)


def _colliding_cells():
    """Two distinct cell coords (near the origin) with equal hashes."""
    rng = np.random.default_rng(5)
    coords = rng.integers(-400, 400, (200_000, 3)).astype(np.int64)
    h = hg._cell_hash(*(torch.as_tensor(coords[:, a]) for a in range(3))).numpy()
    order = np.argsort(h, kind="stable")
    same = np.nonzero(h[order][1:] == h[order][:-1])[0]
    for i in same:
        a, b = coords[order[i]], coords[order[i + 1]]
        if (a != b).any():
            return a, b
    raise AssertionError("no hash collision found")


def _photons(seed=0, n=6000):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 2.5, (n, 3)).astype(np.float32)
    cell = 2 * RADIUS
    pos[:40] = np.float32([0.31, 0.52, -0.77]) + rng.uniform(0, 0.02, (40, 3)).astype(np.float32)  # 40 in one cell
    pos[40:60] = np.float32([-1.23, 0.05, 0.4]) + rng.uniform(0, 0.01, (20, 3)).astype(np.float32)
    a, b = _colliding_cells()
    pos[60:72] = (a + 0.5).astype(np.float32) * cell  # two colliding cells, 12 photons each
    pos[72:84] = (b + 0.5).astype(np.float32) * cell
    pos[rng.random(n) < 0.25] = 3.0e18  # parked photons
    return pos, (a, b)


def _ref(p):
    return RefVec3(*(jnp.asarray(p[:, i]) for i in range(3)))


def _port(p):
    return Vec3(*(torch.as_tensor(p[:, i]) for i in range(3)))


def test_cell_hash_and_saturating_conversion_match_reference():
    vals = np.float32([0.0, -0.0, 0.4, -0.4, 1e12, -1e12, 3e19, -3e19, 2.0 ** 31, -(2.0 ** 31), 2147483520.0,
                       -2147483648.0, 7.5e5])
    want = np.asarray(jnp.floor(jnp.asarray(vals)).astype(jnp.int32)).astype(np.int64)
    got = hg._to_i32(torch.floor(torch.as_tensor(vals))).numpy()
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    ints = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, (3, 4000)),
                           np.int64([[2 ** 31 - 1, -2 ** 31, 0, -1]] * 3)], axis=1)
    want = np.asarray(ref_hg._cell_hash(*(jnp.asarray(x.astype(np.int32)) for x in ints))).astype(np.int64)
    got = hg._cell_hash(*(torch.as_tensor(x) for x in ints)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < hg.TABLE_SIZE


@pytest.mark.parametrize("seed", [0, 1])
def test_build_hash_grid_is_bit_equal(seed):
    pos, _ = _photons(seed)
    ref = ref_hg.build_hash_grid(_ref(pos), jnp.float32(RADIUS))
    got = hg.build_hash_grid(_port(pos), torch.tensor(RADIUS))
    np.testing.assert_array_equal(got.cell_ids.numpy(), np.asarray(ref.cell_ids).astype(np.int64))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref.order).astype(np.int64))
    assert got.inv_cell_size.dtype == torch.float32
    assert got.inv_cell_size.item() == float(ref.inv_cell_size)
    # the set holds overfull cells: the first max_per_cell of their runs are what queries keep
    _, counts = np.unique(got.cell_ids.numpy(), return_counts=True)
    assert counts.max() > 8


@pytest.mark.parametrize("max_per_cell", [8, 3])
def test_gather_candidates_is_bit_equal(max_per_cell):
    pos, (a, b) = _photons(0)
    rng = np.random.default_rng(2)
    q = rng.uniform(-1.5, 2.5, (3000, 3)).astype(np.float32)
    q[:84] = pos[:84] + rng.normal(0, 0.02, (84, 3)).astype(np.float32)  # near the full and colliding cells
    q[84:90] = np.float32(1e12)  # misses' positions: the conversion saturates
    q[90:96] = np.float32(-3e18)
    ref_grid = ref_hg.build_hash_grid(_ref(pos), jnp.float32(RADIUS))
    grid = hg.build_hash_grid(_port(pos), torch.tensor(RADIUS))
    ref_idx, ref_ok = ref_hg.gather_candidates(ref_grid, _ref(q), max_per_cell)
    idx, ok = hg.gather_candidates(grid, _port(q), max_per_cell)
    assert idx.shape == ok.shape == (q.shape[0], 8 * max_per_cell)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx).astype(np.int64))
    # the colliding cells share one run, cell a's photons first: a query in
    # cell b is handed cell a's photons (false candidates for the radius test)
    near_b = idx[72:84][ok[72:84]].numpy()
    assert ((near_b >= 60) & (near_b < 72)).any()
    # a full cell gives max_per_cell candidates of its own, no more
    assert int(ok[:40].sum(1).max()) <= 8 * max_per_cell
