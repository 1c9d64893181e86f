"""Piecewise-constant probability distributions, 1-D and 2-D (port of
``raytracer_tpu/math/distribution.py``).

A CDF is built from arbitrary non-negative values on the host with numpy in
float64, rounded once to float32 and stored on ``device``; sampling is one
vectorized binary search over the whole wavefront.  The 2-D product
distribution (row marginal x per-row conditional) serves lat-long
environment maps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Distribution(NamedTuple):
    """Discrete distribution over N bins of equal width on [0, 1)."""

    prob: torch.Tensor  # (N,) probability of each bin (sums to 1)
    cdf: torch.Tensor  # (N+1,) cdf[0]=0, cdf[N]=1


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def make_distribution(values: np.ndarray, *, device) -> Distribution:
    """Normalize non-negative ``values`` into a sampleable distribution.
    Zero-total input becomes uniform."""
    v = np.asarray(values, np.float64).reshape(-1)
    if (v < 0).any():
        raise ValueError("distribution values must be non-negative")
    total = v.sum()
    if total <= 0.0:
        v = np.ones_like(v)
        total = v.sum()
    prob = v / total
    cdf = np.concatenate([[0.0], np.cumsum(prob)])
    cdf[-1] = 1.0
    return Distribution(prob=_f32(prob, device), cdf=_f32(cdf, device))


def sample_discrete(dist: Distribution, u) -> tuple[torch.Tensor, torch.Tensor]:
    """u in [0,1) -> (bin index, bin probability)."""
    n = dist.prob.shape[0]
    idx = torch.clamp(torch.searchsorted(dist.cdf, u.contiguous(), right=True) - 1, 0, n - 1)
    return idx.to(torch.int32), dist.prob[idx]


def sample_continuous(dist: Distribution, u) -> tuple[torch.Tensor, torch.Tensor]:
    """u in [0,1) -> (x in [0,1), density at x): density = prob * N inside a bin."""
    n = dist.prob.shape[0]
    idx, prob = sample_discrete(dist, u)
    idx = idx.long()
    lo = dist.cdf[idx]
    hi = dist.cdf[idx + 1]
    frac = torch.clamp((u - lo) / torch.clamp_min(hi - lo, 1e-12), 0.0, 1.0)
    x = (idx.to(torch.float32) + frac) / n
    return x, prob * n


class Distribution2D(NamedTuple):
    """2-D piecewise-constant distribution over the unit square (H x W bins):
    marginal over rows (v axis) x conditional over columns (u axis)."""

    marginal_cdf: torch.Tensor  # (H+1,)
    cond_cdf: torch.Tensor  # (H, W+1)
    density: torch.Tensor  # (H, W) joint density over the unit square (integrates to 1)

    @property
    def height(self) -> int:
        return self.density.shape[0]

    @property
    def width(self) -> int:
        return self.density.shape[1]


def make_distribution_2d(values: np.ndarray, *, device) -> Distribution2D:
    """(H, W) non-negative weights -> samplable 2-D distribution."""
    v = np.asarray(values, np.float64)
    if v.ndim != 2:
        raise ValueError("expected a 2-D weight array")
    if (v < 0).any():
        raise ValueError("distribution values must be non-negative")
    h, w = v.shape
    total = v.sum()
    if total <= 0.0:
        v = np.ones_like(v)
        total = v.sum()
    row_sums = v.sum(axis=1)  # (H,)
    marg = row_sums / total
    marginal_cdf = np.concatenate([[0.0], np.cumsum(marg)])
    marginal_cdf[-1] = 1.0
    # conditional per row; uniform for empty rows (never sampled anyway)
    safe_rows = np.where(row_sums > 0.0, row_sums, 1.0)[:, None]
    cond = np.where(row_sums[:, None] > 0.0, v / safe_rows, 1.0 / w)
    cond_cdf = np.concatenate([np.zeros((h, 1)), np.cumsum(cond, axis=1)], axis=1)
    cond_cdf[:, -1] = 1.0
    density = (v / total) * (h * w)  # joint density on the unit square
    return Distribution2D(
        marginal_cdf=_f32(marginal_cdf, device),
        cond_cdf=_f32(cond_cdf, device),
        density=_f32(density, device),
    )


def sample_2d(dist: Distribution2D, u1, u2):
    """(u1, u2) -> (u, v, density) with (u, v) in [0,1)^2 distributed by the
    2-D density (u = column axis, v = row axis).  The per-row column search
    is a binary search over the (H, W+1) conditional CDF with one N-point
    2-D gather per step; it never materializes per-lane rows."""
    h, w = dist.density.shape
    # row from the marginal
    iy = torch.clamp(torch.searchsorted(dist.marginal_cdf, u2.contiguous(), right=True) - 1, 0, h - 1)
    lo_y = dist.marginal_cdf[iy]
    hi_y = dist.marginal_cdf[iy + 1]
    fy = torch.clamp((u2 - lo_y) / torch.clamp_min(hi_y - lo_y, 1e-12), 0.0, 1.0)
    v = (iy.to(torch.float32) + fy) / h
    # column: binary search of cond_cdf[iy, :] via point gathers
    lo = torch.zeros(u1.shape, dtype=torch.int64, device=u1.device)
    hi = torch.full(u1.shape, w + 1, dtype=torch.int64, device=u1.device)
    for _ in range(max(1, w.bit_length())):
        mid = (lo + hi) >> 1
        # once lo == hi == w + 1 (only for u1 >= 1) mid would leave the row
        go_right = dist.cond_cdf[iy, torch.clamp_max(mid, w)] <= u1
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    ix = torch.clamp(lo - 1, 0, w - 1)
    lo_x = dist.cond_cdf[iy, ix]
    hi_x = dist.cond_cdf[iy, ix + 1]
    fx = torch.clamp((u1 - lo_x) / torch.clamp_min(hi_x - lo_x, 1e-12), 0.0, 1.0)
    u = (ix.to(torch.float32) + fx) / w
    return u, v, dist.density[iy, ix]


def searchsorted_rows(cdf_rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-row search (the reference's ``jax_searchsorted_rows``):
    ``cdf_rows`` (..., K) sorted along the last axis, ``u`` (...) -> the
    rightmost insertion index, the count of entries <= u, as int32."""
    return torch.searchsorted(cdf_rows.contiguous(), u.contiguous()[..., None], right=True)[..., 0].to(torch.int32)


def pdf_2d(dist: Distribution2D, u, v) -> torch.Tensor:
    """Joint density at (u, v): the MIS counterpart of :func:`sample_2d`."""
    h, w = dist.density.shape
    ix = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    iy = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return dist.density[iy, ix]
