"""Texture evaluation: bitmap fetches and inline procedural kinds (port of
``raytracer_tpu/ops/textures.py``).

- bitmaps: nearest / bilinear / bilinear-smoothstep over wrapped UVs; all
  bitmaps live in one packed atlas so a per-ray fetch is one 2-D gather;
- checkerboard: (u > .5) xor (v > .5) selects color A, else B;
- noise: 2-D simplex-noise FBM with an arithmetic lattice hash;
- mix: lerp(texA, texB, weightTex.x) with one level of nesting.

Texture id INVALID_ID resolves to constant 1.0 (a parameter is
``constant * texture``).  ``sample_texture_many`` takes the plain twin,
``sample_texture_many_reference``, on CPU tensors: vectorized PyTorch that
evaluates every lane, whatever its id.  On CUDA tensors it launches
``csrc/textures.cu``, one thread a lane, which computes the same floats lane
by lane and evaluates only each lane's own kind, filter and octaves; where
autograd asks for gradients, its backward is the twin's.  Under tracing
each call is a ``textures`` span (``site``: ``material``, ``normal``,
``env`` or ``decal``) and counts, by site, its lanes
(``textures.lanes.<site>``) and, on the device, those with a texture
(``textures.lanes_textured.<site>``); the kernel's launches count as
``launches.textures``.
The twin's integer hash works on uint32 values held in int64 tensors, as
``sampler/sampler.py`` does, and is bit-equal to the reference's; the float
math follows the reference's order of operations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math.vec import Vec3
from ..sampler.sampler import _M32, _mul32
from ..scene.types import (
    INVALID_ID,
    TEX_BITMAP,
    TEX_CHECKERBOARD,
    TEX_CONST,
    TEX_MIX,
    TEX_NOISE,
    TextureAtlas,
)
from ..utils.profiler import count, count_device, span, tracing
from .cuda_build import launch

FILTER_NEAREST = 0
FILTER_BILINEAR = 1
FILTER_BILINEAR_SMOOTHSTEP = 2

MAX_NOISE_OCTAVES = 8


class AtlasBuilder:
    """Host-side accumulation of textures into one TextureAtlas."""

    def __init__(self):
        self.images: list[np.ndarray] = []  # per-BITMAP image
        self.rows = []  # per-texture dict of metadata

    def add_bitmap(self, image: np.ndarray, filter_mode: int = FILTER_BILINEAR) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_BITMAP, image=len(self.images), filter=filter_mode))
        self.images.append(np.asarray(image, np.float32)[..., :3])
        return tid

    def add_checkerboard(self, color_a, color_b) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_CHECKERBOARD, ca=color_a, cb=color_b))
        return tid

    def add_noise(self, color_a, color_b, octaves: int = 1) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_NOISE, ca=color_a, cb=color_b, octaves=octaves))
        return tid

    def add_mix(self, tex_a: int, tex_b: int, tex_w: int) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_MIX, sa=tex_a, sb=tex_b, sw=tex_w))
        return tid

    def add_const(self, color) -> int:
        tid = len(self.rows)
        self.rows.append(dict(kind=TEX_CONST, ca=color))
        return tid

    def build(self, device) -> TextureAtlas:
        rows = self.rows or [dict(kind=TEX_CONST, ca=(1.0, 1.0, 1.0))]
        images = self.images or [np.ones((1, 1, 3), np.float32)]
        w_atlas = max(im.shape[1] for im in images)
        total_rows = sum(im.shape[0] for im in images)
        data = np.zeros((total_rows, w_atlas, 3), np.float32)
        img_y0, img_h, img_w = [], [], []
        y = 0
        for im in images:
            h, w = im.shape[:2]
            data[y : y + h, :w] = im
            img_y0.append(y)
            img_h.append(h)
            img_w.append(w)
            y += h

        k = len(rows)
        y0 = np.zeros(k, np.int32)
        hh = np.ones(k, np.int32)
        ww = np.ones(k, np.int32)
        fm = np.full(k, FILTER_BILINEAR, np.int32)
        kind = np.zeros(k, np.int32)
        ca = np.ones((k, 3), np.float32)
        cb = np.zeros((k, 3), np.float32)
        octaves = np.ones(k, np.int32)
        sa = np.zeros(k, np.int32)
        sb = np.zeros(k, np.int32)
        sw = np.zeros(k, np.int32)
        for i, r in enumerate(rows):
            kind[i] = r["kind"]
            if r["kind"] == TEX_BITMAP:
                j = r["image"]
                y0[i], hh[i], ww[i], fm[i] = img_y0[j], img_h[j], img_w[j], r["filter"]
            if "ca" in r:
                ca[i] = r["ca"]
            if "cb" in r:
                cb[i] = r["cb"]
            if "octaves" in r:
                octaves[i] = min(r["octaves"], MAX_NOISE_OCTAVES)
            if r["kind"] == TEX_MIX:
                sa[i], sb[i], sw[i] = r["sa"], r["sb"], r["sw"]
        t = lambda a: torch.as_tensor(a, device=device)
        v3 = lambda a: Vec3(t(a[:, 0].copy()), t(a[:, 1].copy()), t(a[:, 2].copy()))
        return TextureAtlas(
            data=t(data),
            y0=t(y0), height=t(hh), width=t(ww),
            filter_mode=t(fm),
            kind=t(kind),
            color_a=v3(ca),
            color_b=v3(cb),
            octaves=t(octaves),
            sub_a=t(sa), sub_b=t(sb), sub_w=t(sw),
            **atlas_static(kind, octaves),
        )


def atlas_static(kind: np.ndarray, octaves: np.ndarray) -> dict:
    """The table's static facts (``TextureAtlas.kinds_present`` and
    ``max_octaves``) from its host arrays."""
    noise = octaves[kind == TEX_NOISE]
    return dict(kinds_present=tuple(sorted(int(k) for k in np.unique(kind))),
                max_octaves=int(noise.max()) if noise.size else 0)


def build_atlas(images: list[np.ndarray], filter_modes: list[int] | None = None, *, device) -> TextureAtlas:
    """Bitmap-only convenience constructor."""
    b = AtlasBuilder()
    for i, im in enumerate(images):
        b.add_bitmap(im, (filter_modes or [FILTER_BILINEAR] * len(images))[i])
    return b.build(device)


# --- bitmap fetch --------------------------------------------------------------
def _fetch(atlas: TextureAtlas, y0, h, w, ix, iy) -> Vec3:
    ix = torch.remainder(ix, w)
    iy = torch.remainder(iy, h)
    texel = atlas.data[(y0 + iy).long(), ix.long()]  # (N, 3) gather
    return Vec3(texel[..., 0], texel[..., 1], texel[..., 2])


def _clip_index(x, size):
    """``clip(x, 0, size - 1)`` for int32 tensors."""
    return torch.minimum(torch.clamp_min(x, 0), size - 1)


def _bitmap_eval(atlas: TextureAtlas, tid, u, v) -> Vec3:
    y0 = atlas.y0[tid]
    h = atlas.height[tid]
    w = atlas.width[tid]
    fmode = atlas.filter_mode[tid]
    uu = torch.remainder(u, 1.0) * w.to(torch.float32)
    vv = torch.remainder(v, 1.0) * h.to(torch.float32)
    n_ix = _clip_index(uu.to(torch.int32), w)
    n_iy = _clip_index(vv.to(torch.int32), h)
    # texel-CORNER convention, exactly as the reference: texel0 = floor(u*W),
    # texel1 = texel0 + 1 wrapped, weight = frac; no half-texel recentering
    fl_u = torch.floor(uu)
    fl_v = torch.floor(vv)
    ix0 = _clip_index(fl_u.to(torch.int32), w)
    iy0 = _clip_index(fl_v.to(torch.int32), h)
    fu = uu - fl_u
    fv = vv - fl_v
    smooth = fmode == FILTER_BILINEAR_SMOOTHSTEP
    fu = torch.where(smooth, fu * fu * (3.0 - 2.0 * fu), fu)
    fv = torch.where(smooth, fv * fv * (3.0 - 2.0 * fv), fv)
    ix1 = torch.where(ix0 + 1 >= w, 0, ix0 + 1)  # wrap secondary coords
    iy1 = torch.where(iy0 + 1 >= h, 0, iy0 + 1)
    c00 = _fetch(atlas, y0, h, w, ix0, iy0)
    c10 = _fetch(atlas, y0, h, w, ix1, iy0)
    c01 = _fetch(atlas, y0, h, w, ix0, iy1)
    c11 = _fetch(atlas, y0, h, w, ix1, iy1)
    bil = (
        c00 * ((1.0 - fu) * (1.0 - fv))
        + c10 * (fu * (1.0 - fv))
        + c01 * ((1.0 - fu) * fv)
        + c11 * (fu * fv)
    )
    nearest = _fetch(atlas, y0, h, w, n_ix, n_iy)
    is_nearest = fmode == FILTER_NEAREST
    return Vec3(
        torch.where(is_nearest, nearest.x, bil.x),
        torch.where(is_nearest, nearest.y, bil.y),
        torch.where(is_nearest, nearest.z, bil.z),
    )


# --- simplex noise -------------------------------------------------------------
def _hash2(ix, iy):
    """Integer lattice hash -> 8-bit gradient index (int32 lattice coords
    reinterpreted as uint32, wrapping multiplies)."""
    ux = ix.to(torch.int64) & _M32
    uy = iy.to(torch.int64) & _M32
    h = (_mul32(ux, 0x8DA6B343) + _mul32(uy, 0xD8163841)) & _M32
    h = h ^ (h >> 13)
    h = _mul32(h, 0x9E3779B1)
    return (h >> 24).to(torch.int32)


def _gradient_dot(hash8, x, y):
    """8 gradient directions."""
    h = hash8 & 0x3F
    u = torch.where(h < 4, x, y)
    v = torch.where(h < 4, y, x)
    return torch.where((h & 1) != 0, -u, u) + torch.where((h & 2) != 0, -2.0 * v, 2.0 * v)


def _simplex2(x, y):
    """2-D simplex noise in [-1, 1], vectorized."""
    f2 = 0.366025403
    g2 = 0.211324865
    s = (x + y) * f2
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    t = (i + j) * g2
    x0 = x - (i - t)
    y0 = y - (j - t)
    i1 = (x0 > y0).to(torch.float32)
    j1 = 1.0 - i1
    x1 = x0 - i1 + g2
    y1 = y0 - j1 + g2
    x2 = x0 - 1.0 + 2.0 * g2
    y2 = y0 - 1.0 + 2.0 * g2
    ii = i.to(torch.int32)
    jj = j.to(torch.int32)

    def corner(cx, cy, gi, gj):
        tt = 0.5 - cx * cx - cy * cy
        m = torch.clamp_min(tt, 0.0)
        m2 = m * m
        return m2 * m2 * _gradient_dot(_hash2(gi, gj), cx, cy)

    n = (
        corner(x0, y0, ii, jj)
        + corner(x1, y1, ii + i1.to(torch.int32), jj + j1.to(torch.int32))
        + corner(x2, y2, ii + 1, jj + 1)
    )
    return 45.23065 * n  # normalization to ~[-1, 1]


def _noise_fbm(u, v, n_octaves, max_octaves: int = MAX_NOISE_OCTAVES):
    """FBM over simplex octaves, masked by the per-ray count.  An octave
    beyond ``max_octaves`` (the most any row of the table asks for) would
    add exactly 0 to both sums, so it is left out."""
    total = torch.zeros_like(u)
    amp_sum = torch.zeros_like(u)
    for o in range(min(max_octaves, MAX_NOISE_OCTAVES)):
        active = (o < n_octaves).to(torch.float32)
        freq = float(2**o)
        amp = float(0.5**o)
        total = total + active * amp * _simplex2(u * freq, v * freq)
        amp_sum = amp_sum + active * amp
    val = 0.5 + 0.5 * total / torch.clamp_min(amp_sum, 1e-6)
    return torch.clamp(val, 0.0, 1.0)


def _gv(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _eval_non_mix(atlas: TextureAtlas, tid, u, v) -> Vec3:
    """Evaluate one texture id per ray, excluding TEX_MIX recursion.  A kind
    that no row of the table has is never selected and is not evaluated."""
    tid = tid.long()
    kind = atlas.kind[tid]
    ca = _gv(atlas.color_a, tid)
    cb = _gv(atlas.color_b, tid)
    out = _bitmap_eval(atlas, tid, u, v)
    vals = []
    if TEX_CHECKERBOARD in atlas.kinds_present:
        cu = torch.remainder(u, 1.0) > 0.5
        cv = torch.remainder(v, 1.0) > 0.5
        chk_a = cu ^ cv
        vals.append((TEX_CHECKERBOARD, Vec3(
            torch.where(chk_a, ca.x, cb.x),
            torch.where(chk_a, ca.y, cb.y),
            torch.where(chk_a, ca.z, cb.z),
        )))
    if TEX_NOISE in atlas.kinds_present:
        noise_w = _noise_fbm(u, v, atlas.octaves[tid], atlas.max_octaves)
        vals.append((TEX_NOISE, ca * noise_w + cb * (1.0 - noise_w)))
    vals.append((TEX_CONST, ca))
    for k_, val in vals:
        m = kind == k_
        out = Vec3(
            torch.where(m, val.x, out.x),
            torch.where(m, val.y, out.y),
            torch.where(m, val.z, out.z),
        )
    return out


def sample_texture_many_reference(atlas: TextureAtlas, tex_ids, u, v) -> Vec3:
    """Per-ray texture sample over mixed kinds; INVALID_ID lanes get 1.0.
    The plain twin of ``csrc/textures.cu``: every lane evaluates every kind
    the table has."""
    valid = tex_ids != INVALID_ID
    tid = torch.clamp_min(tex_ids, 0).long()
    out = _eval_non_mix(atlas, tid, u, v)
    if TEX_MIX in atlas.kinds_present:
        # one level of mix nesting
        is_mix = atlas.kind[tid] == TEX_MIX
        va = _eval_non_mix(atlas, atlas.sub_a[tid], u, v)
        vb = _eval_non_mix(atlas, atlas.sub_b[tid], u, v)
        vw = _eval_non_mix(atlas, atlas.sub_w[tid], u, v)
        mixed = va + (vb - va) * vw.x
        out = Vec3(
            torch.where(is_mix, mixed.x, out.x),
            torch.where(is_mix, mixed.y, out.y),
            torch.where(is_mix, mixed.z, out.z),
        )
    one = torch.ones_like(out.x)
    return Vec3(
        torch.where(valid, out.x, one),
        torch.where(valid, out.y, one),
        torch.where(valid, out.z, one),
    )


def _sample_kernel(atlas: TextureAtlas, tex_ids, u, v) -> torch.Tensor:
    """One launch of ``csrc/textures.cu``: the (3, *u.shape) float32 RGB of
    ``sample_texture_many_reference``.  Raises ValueError on inputs the
    kernel does not take."""
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"sample_texture_many: unsupported device {dev}")
    # the int32 columns, then the float32 colors, in the order textures_launch takes them
    table = (atlas.kind, atlas.y0, atlas.height, atlas.width, atlas.filter_mode, atlas.octaves,
             atlas.sub_a, atlas.sub_b, atlas.sub_w, *atlas.color_a, *atlas.color_b)
    k = atlas.kind.shape[0]
    data = atlas.data
    ok = (
        tex_ids.dtype == torch.int32 and u.dtype == torch.float32 and v.dtype == torch.float32
        and tex_ids.shape == u.shape == v.shape and 0 < k
        and data.dtype == torch.float32 and data.dim() == 3 and data.shape[2] == 3 and data.shape[1] > 0
        and all(t.dtype == torch.int32 for t in table[:9]) and all(t.dtype == torch.float32 for t in table[9:])
        and all(t.shape == (k,) for t in table)
        and all(t.device == dev and t.is_contiguous() for t in (tex_ids, u, v, data, *table))
    )
    if not ok:
        raise ValueError("sample_texture_many: inputs do not match the kernel's dtypes, shapes, device or layout")
    out = torch.empty((3, *u.shape), dtype=torch.float32, device=dev)
    kinds = sum(1 << kind for kind in atlas.kinds_present)
    launch("textures", "textures_launch", tex_ids, u, v, data, *table, out, u.numel(), k, data.shape[1], kinds,
           min(atlas.max_octaves, MAX_NOISE_OCTAVES), device=dev)
    return out


class _KernelWithTwinGrad(torch.autograd.Function):
    """The kernel forward; backward differentiates the twin, recomputed on
    detached inputs.  Inputs: the atlas, the ids, then the differentiable
    tensors ``u``, ``v``, ``atlas.data``, ``color_a`` and ``color_b``."""

    @staticmethod
    def forward(ctx, atlas, tex_ids, u, v, *atlas_floats):
        ctx.atlas = atlas
        ctx.save_for_backward(tex_ids, u, v, *atlas_floats)
        return _sample_kernel(atlas, tex_ids, u, v)

    @staticmethod
    def backward(ctx, grad):
        tex_ids, *floats = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need) for t, need in zip(floats, ctx.needs_input_grad[2:])]
        u, v, data, ax, ay, az, bx, by, bz = leaves
        atlas = ctx.atlas._replace(data=data, color_a=Vec3(ax, ay, az), color_b=Vec3(bx, by, bz))
        with torch.enable_grad():
            out = torch.stack(list(sample_texture_many_reference(atlas, tex_ids, u, v)))
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None, *[next(grads) if t.requires_grad else None for t in leaves])


def sample_texture_many(atlas: TextureAtlas, tex_ids, u, v, site: str = "material") -> Vec3:
    """Per-ray texture sample over mixed kinds; INVALID_ID lanes get 1.0.
    ``site`` names the caller in the ``textures`` span.  CPU tensors take
    the plain twin; CUDA tensors launch ``csrc/textures.cu`` or raise, through
    ``_KernelWithTwinGrad`` where grad mode is on and ``u``, ``v`` or a float
    tensor of the atlas requires grad."""
    with span("textures", site=site):
        if tracing():
            valid = tex_ids != INVALID_ID
            count(f"textures.lanes.{site}", valid.numel())
            count_device(f"textures.lanes_textured.{site}", valid.sum())
        if u.device.type == "cpu":
            return sample_texture_many_reference(atlas, tex_ids, u, v)
        floats = (u, v, atlas.data, *atlas.color_a, *atlas.color_b)
        if torch.is_grad_enabled() and any(t.requires_grad for t in floats):
            out = _KernelWithTwinGrad.apply(atlas, tex_ids, *floats)
        else:
            out = _sample_kernel(atlas, tex_ids, u, v)
        return Vec3(out[0], out[1], out[2])
