"""The texture kernel's per-lane algorithm (``csrc/textures.cu``) against the
plain twin ``ops/textures.py::sample_texture_many_reference``, bit for bit.

A CUDA kernel does not run on this host, so ``kernel_lane`` writes the
kernel's control flow out in numpy float32, one lane at a time: the early
exit for ``INVALID_ID``, one branch on the row's kind, the row's own filter,
noise over the row's own octaves (and the rest of the twin's octaves only
where the simplex value could be non-finite), one level of mix, the sub ids
counting from the table's end when negative.  Every float is rounded as the
kernel rounds it.  Each case holds it against the twin on the CPU with no
tolerance: every kind, the three filter modes, noise with 0, 1, 4 and 8
octaves, mixes over bitmap, noise and checkerboard subs (and a mix met as a
sub, a negative sub id), constants and ``INVALID_ID`` lanes, with ``u`` and
``v`` at texel edges, negative, above 1 and at ``0.99999994``.

Then the wrapper: CPU tensors take the twin and launch nothing
(``launches.textures`` stays 0 under tracing); the gradient route's
backward gives the twin's gradients; another device raises.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu_torch.ops import textures as tex
from raytracer_tpu_torch.ops.cuda_build import launch_counts
from raytracer_tpu_torch.scene.types import INVALID_ID, TEX_CHECKERBOARD, TEX_CONST, TEX_MIX, TEX_NOISE
from raytracer_tpu_torch.utils import profiler

F = np.float32
KERNEL = os.path.join(os.path.dirname(tex.__file__), os.pardir, "csrc", "textures.cu")
# the twin's float32 scalars, as np.float32 of its Python constants
F2, G2, G2X2, NORM, AMP_FLOOR = F(0.366025403), F(0.211324865), F(2.0 * 0.211324865), F(45.23065), F(1e-6)


# --- the kernel's per-lane algorithm, written out ------------------------------------
def rem1(a):
    """torch.remainder(a, 1.0): fmod, then + 1 where negative."""
    m = F(np.fmod(a, F(1.0)))
    if m != 0 and m < 0:
        m = F(m + F(1.0))
    return m


def to_i32(x):
    """Float to int32, truncating.  NaN and values out of range read what
    torch's cast gives on this host: the card's cast (the kernel's and the
    twin's there alike) saturates and reads NaN as 0, an x86 host's reads
    both as -2^31."""
    if -2.0**31 <= x < 2.0**31:
        return math.trunc(float(x))
    return int(torch.tensor([x], dtype=torch.float32).to(torch.int32))


def clamp_min(t, lo):
    return t if math.isnan(t) else max(t, lo)


def clip_index(x, size):
    return min(max(x, 0), size - 1)


def hash2(ix, iy):
    h = ((ix & 0xFFFFFFFF) * 0x8DA6B343 + (iy & 0xFFFFFFFF) * 0xD8163841) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0x9E3779B1) & 0xFFFFFFFF
    return h >> 24


def gradient_dot(hash8, x, y):
    h = hash8 & 0x3F
    u, v = (x, y) if h < 4 else (y, x)
    a = -u if h & 1 else u
    b = F(F(-2.0) * v) if h & 2 else F(F(2.0) * v)
    return F(a + b)


def corner(cx, cy, gi, gj):
    m = clamp_min(F(F(F(0.5) - F(cx * cx)) - F(cy * cy)), F(0.0))
    m2 = F(m * m)
    return F(F(m2 * m2) * gradient_dot(hash2(gi, gj), cx, cy))


def simplex2(x, y):
    s = F(F(x + y) * F2)
    i, j = F(np.floor(F(x + s))), F(np.floor(F(y + s)))
    t = F(F(i + j) * G2)
    x0, y0 = F(x - F(i - t)), F(y - F(j - t))
    i1 = F(1.0) if x0 > y0 else F(0.0)
    j1 = F(F(1.0) - i1)
    x1, y1 = F(F(x0 - i1) + G2), F(F(y0 - j1) + G2)
    x2, y2 = F(F(x0 - F(1.0)) + G2X2), F(F(y0 - F(1.0)) + G2X2)
    ii, jj = to_i32(i), to_i32(j)
    n = F(F(corner(x0, y0, ii, jj) + corner(x1, y1, ii + int(i1), jj + int(j1))) + corner(x2, y2, ii + 1, jj + 1))
    return F(NORM * n)


def noise_fbm(u, v, count, loop):
    active = min(max(count, 0), loop)
    total = amp_sum = F(0.0)
    for o in range(active):
        freq, amp = F(2.0 ** o), F(0.5 ** o)
        total = F(total + F(amp * simplex2(F(u * freq), F(v * freq))))
        amp_sum = F(amp_sum + amp)
    if active < loop and not (abs(u) < F(1e30) and abs(v) < F(1e30)):
        for o in range(active, loop):
            freq = F(2.0 ** o)
            total = F(total + F(F(0.0) * simplex2(F(u * freq), F(v * freq))))
    d = AMP_FLOOR if amp_sum < AMP_FLOOR else amp_sum
    val = F(F(0.5) + F(F(F(0.5) * total) / d))
    return val if math.isnan(val) else min(max(val, F(0.0)), F(1.0))


def texel(data, row, col):
    return tuple(F(c) for c in data[row, col])


def bitmap(t, r, data, u, v):
    y0, h, w, mode = t["y0"][r], t["height"][r], t["width"][r], t["filter_mode"][r]
    uu, vv = F(rem1(u) * F(w)), F(rem1(v) * F(h))
    if mode == tex.FILTER_NEAREST:
        return texel(data, y0 + clip_index(to_i32(vv), h), clip_index(to_i32(uu), w))
    fl_u, fl_v = F(np.floor(uu)), F(np.floor(vv))
    ix0, iy0 = clip_index(to_i32(fl_u), w), clip_index(to_i32(fl_v), h)
    fu, fv = F(uu - fl_u), F(vv - fl_v)
    if mode == tex.FILTER_BILINEAR_SMOOTHSTEP:
        fu = F(F(fu * fu) * F(F(3.0) - F(F(2.0) * fu)))
        fv = F(F(fv * fv) * F(F(3.0) - F(F(2.0) * fv)))
    ix1 = 0 if ix0 + 1 >= w else ix0 + 1
    iy1 = 0 if iy0 + 1 >= h else iy0 + 1
    taps = [texel(data, y0 + iy0, ix0), texel(data, y0 + iy0, ix1), texel(data, y0 + iy1, ix0),
            texel(data, y0 + iy1, ix1)]
    weights = [F(F(F(1.0) - fu) * F(F(1.0) - fv)), F(fu * F(F(1.0) - fv)), F(F(F(1.0) - fu) * fv), F(fu * fv)]
    out = []
    for c in range(3):
        acc = F(taps[0][c] * weights[0])
        for tap, wt in zip(taps[1:], weights[1:]):
            acc = F(acc + F(tap[c] * wt))
        out.append(acc)
    return tuple(out)


def non_mix(t, r, data, kinds, loop, u, v):
    kind = t["kind"][r]
    a, b = t["color_a"][r], t["color_b"][r]
    if kind == TEX_CHECKERBOARD and kinds & (1 << TEX_CHECKERBOARD):
        return a if (rem1(u) > F(0.5)) != (rem1(v) > F(0.5)) else b
    if kind == TEX_NOISE and kinds & (1 << TEX_NOISE):
        w = noise_fbm(u, v, t["octaves"][r], loop)
        q = F(F(1.0) - w)
        return tuple(F(F(ca * w) + F(cb * q)) for ca, cb in zip(a, b))
    if kind == TEX_CONST:
        return a
    return bitmap(t, r, data, u, v)


def kernel_lane(t, data, kinds, loop, tex_id, u, v):
    """One thread of ``textures_kernel``."""
    if tex_id == INVALID_ID:
        return (F(1.0),) * 3
    k = len(t["kind"])
    r = max(tex_id, 0)
    if r >= k:
        return (F(np.nan),) * 3
    if t["kind"][r] == TEX_MIX and kinds & (1 << TEX_MIX):
        subs = [s + k if s < 0 else s for s in (t["sub_a"][r], t["sub_b"][r], t["sub_w"][r])]
        if min(subs) < 0 or max(subs) >= k:
            return (F(np.nan),) * 3
        va, vb, vw = (non_mix(t, s, data, kinds, loop, u, v) for s in subs)
        return tuple(F(a + F(F(b - a) * vw[0])) for a, b in zip(va, vb))
    return non_mix(t, r, data, kinds, loop, u, v)


def kernel_model(atlas, tex_ids, u, v) -> np.ndarray:
    """(N, 3) float32: ``kernel_lane`` over every lane, with the launch's
    ``kinds`` and ``loop`` arguments as ``_sample_kernel`` computes them."""
    t = {f: getattr(atlas, f).tolist() for f in ("kind", "y0", "height", "width", "filter_mode", "octaves",
                                                  "sub_a", "sub_b", "sub_w")}
    for f in ("color_a", "color_b"):
        c = getattr(atlas, f)
        t[f] = [tuple(F(x) for x in row) for row in np.stack([c.x.numpy(), c.y.numpy(), c.z.numpy()], -1)]
    kinds = sum(1 << kind for kind in atlas.kinds_present)
    loop = min(atlas.max_octaves, tex.MAX_NOISE_OCTAVES)
    data = atlas.data.numpy()
    with np.errstate(all="ignore"):  # inf and NaN lanes, as on the card
        out = [kernel_lane(t, data, kinds, loop, int(i), F(a), F(b)) for i, a, b in zip(tex_ids, u, v)]
    return np.array(out, np.float32).reshape(-1, 3)


# --- the tables and the lanes ----------------------------------------------------------
def mixed_atlas():
    """Every kind and filter; bitmaps narrower than the atlas and not square;
    noise with 0, 1, 4 and 8 octaves; mixes over bitmap, noise and
    checkerboard subs, one with a mix as a sub and one with a negative sub
    id (the table's last row, a constant)."""
    rng = np.random.default_rng(21)
    b = tex.AtlasBuilder()
    ids = {
        "nearest": b.add_bitmap(rng.random((8, 8, 3), dtype=np.float32), tex.FILTER_NEAREST),
        "bilinear": b.add_bitmap(rng.random((5, 3, 3), dtype=np.float32), tex.FILTER_BILINEAR),
        "smooth": b.add_bitmap(rng.random((4, 16, 3), dtype=np.float32), tex.FILTER_BILINEAR_SMOOTHSTEP),
        "checker": b.add_checkerboard((0.9, 0.1, 0.2), (0.1, 0.8, 0.3)),
        "noise0": b.add_noise((0.3, 0.6, 0.9), (0.7, 0.2, 0.1), 0),
        "noise1": b.add_noise((1.0, 0.9, 0.8), (0.0, 0.1, 0.2), 1),
        "noise4": b.add_noise((0.5, 0.25, 0.125), (0.875, 0.75, 0.625), 4),
        "noise8": b.add_noise((0.2, 0.4, 0.6), (0.9, 0.7, 0.5), 8),
    }
    ids["mix_bitmap_noise_checker"] = b.add_mix(ids["bilinear"], ids["noise4"], ids["checker"])
    ids["mix_checker_smooth_noise"] = b.add_mix(ids["checker"], ids["smooth"], ids["noise1"])
    ids["mix_of_mix"] = b.add_mix(ids["mix_bitmap_noise_checker"], ids["nearest"], ids["noise8"])
    ids["mix_negative_sub"] = b.add_mix(-1, ids["nearest"], ids["noise1"])
    ids["const"] = b.add_const((0.25, 0.5, 0.75))  # the last row
    return b.build("cpu"), ids


def hall_like_atlas():
    """The textured hall's kinds (bitmaps, a checkerboard, a 4-octave noise,
    a mix of them): ``loop`` is 4 and the table holds no constant."""
    rng = np.random.default_rng(22)
    b = tex.AtlasBuilder()
    ids = {"tiles": b.add_bitmap(rng.random((16, 16, 3), dtype=np.float32), tex.FILTER_BILINEAR_SMOOTHSTEP),
           "check": b.add_checkerboard((0.9, 0.85, 0.8), (0.25, 0.22, 0.2)),
           "cloud": b.add_noise((1.0, 1.0, 1.0), (0.15, 0.15, 0.15), 4)}
    ids["veined"] = b.add_mix(ids["tiles"], ids["check"], ids["cloud"])
    return b.build("cpu"), ids


EDGES = np.array([0.0, 1.0, -1e-9, -0.25, 2.0, 1.0 / 3, 2.0 / 3, 0.2, 0.4, 0.6, 0.8, 0.125, 0.5, 0.0625, 0.9375,
                  0.99999994, -0.99999994, -1.0, 1.5, 3.75, -7.125, 100.03125], np.float32)


def lanes(n, seed):
    """``u`` and ``v``: every pair of EDGES (texel borders of the 3-, 4-, 5-,
    8- and 16-texel sides, 0, 1, below 0, above 1, 0.99999994), then random
    values over [-3, 4)."""
    rng = np.random.default_rng(seed)
    eu, ev = np.meshgrid(EDGES, EDGES)
    u = np.concatenate([eu.ravel(), rng.uniform(-3.0, 4.0, n).astype(np.float32)])
    v = np.concatenate([ev.ravel(), rng.uniform(-3.0, 4.0, n).astype(np.float32)])
    return u, v


def assert_bit_equal(got, want):
    """Equal bit patterns, NaN lanes NaN on both sides."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    bad = (got.view(np.int32) != want.view(np.int32)) & ~nan
    assert not bad.any(), f"{int(bad.any(-1).sum())} lanes differ, first at {np.argwhere(bad.any(-1))[:5].ravel()}"


def twin(atlas, tex_ids, u, v) -> np.ndarray:
    out = tex.sample_texture_many_reference(atlas, torch.from_numpy(tex_ids), torch.from_numpy(u),
                                            torch.from_numpy(v))
    return torch.stack(list(out), -1).numpy()


MIXED = ["nearest", "bilinear", "smooth", "checker", "noise0", "noise1", "noise4", "noise8",
         "mix_bitmap_noise_checker", "mix_checker_smooth_noise", "mix_of_mix", "mix_negative_sub", "const", "invalid"]


@pytest.mark.parametrize("name", MIXED)
def test_kernel_lane_equals_the_twin_per_kind(name):
    atlas, ids = mixed_atlas()
    u, v = lanes(64, 31)
    tex_ids = np.full(u.shape, ids.get(name, INVALID_ID), np.int32)
    assert_bit_equal(kernel_model(atlas, tex_ids, u, v), twin(atlas, tex_ids, u, v))


@pytest.mark.parametrize("name", ["tiles", "check", "cloud", "veined"])
def test_kernel_lane_equals_the_twin_on_the_hall_kinds(name):
    atlas, ids = hall_like_atlas()
    assert atlas.kinds_present == (0, 1, 2, 3) and atlas.max_octaves == 4
    u, v = lanes(64, 32)
    tex_ids = np.full(u.shape, ids[name], np.int32)
    assert_bit_equal(kernel_model(atlas, tex_ids, u, v), twin(atlas, tex_ids, u, v))


def test_kernel_lane_equals_the_twin_on_mixed_ids():
    """Random ids over the whole table, INVALID_ID and other negative ids
    (which read row 0) among them."""
    atlas, ids = mixed_atlas()
    u, v = lanes(1500, 33)
    rng = np.random.default_rng(34)
    tex_ids = rng.integers(-3, len(ids) - 1, u.shape[0]).astype(np.int32)
    assert (tex_ids == INVALID_ID).any() and (tex_ids < INVALID_ID).any()
    assert_bit_equal(kernel_model(atlas, tex_ids, u, v), twin(atlas, tex_ids, u, v))


def test_kernel_lane_equals_the_twin_where_the_noise_is_not_finite():
    """u or v infinite, NaN or huge: past a row's own octaves the twin adds
    0 * simplex, NaN where simplex is; the kernel's guard runs those octaves
    there (a 0-octave row reads NaN, not 0.5)."""
    atlas, ids = mixed_atlas()
    special = np.array([np.inf, -np.inf, np.nan, 3e38, -1e31, 1e29, 0.5], np.float32)
    eu, ev = np.meshgrid(special, special)
    u, v = eu.ravel(), ev.ravel()
    for name in ("noise0", "noise1", "noise4", "mix_bitmap_noise_checker", "nearest", "bilinear", "checker"):
        tex_ids = np.full(u.shape, ids[name], np.int32)
        want = twin(atlas, tex_ids, u, v)
        assert_bit_equal(kernel_model(atlas, tex_ids, u, v), want)
        if name == "noise0":
            assert np.isnan(want[np.isnan(u) | np.isinf(u)]).all()


def test_a_kind_the_table_does_not_list_reads_its_row_as_a_bitmap():
    """The twin evaluates only the kinds of ``kinds_present`` (a constant
    always); the kernel takes the same list as a bit mask."""
    atlas, ids = mixed_atlas()
    narrowed = atlas._replace(kinds_present=(0, TEX_CONST))
    u, v = lanes(16, 35)
    for name in ("checker", "noise4", "mix_bitmap_noise_checker", "const"):
        tex_ids = np.full(u.shape, ids[name], np.int32)
        assert_bit_equal(kernel_model(narrowed, tex_ids, u, v), twin(narrowed, tex_ids, u, v))


def test_the_kernel_constants_are_the_twins():
    """The hex float literals of ``csrc/textures.cu`` are np.float32 of the
    twin's Python constants."""
    with open(KERNEL) as f:
        src = f.read()
    lit = {name: float.fromhex(value) for name, value in
           re.findall(r"constexpr float (k\w+) = (0x[0-9a-fA-Fp.+-]+)f;", src)}
    assert lit == {"kF2": F2, "kG2": G2, "kG2x2": G2X2, "kNorm": NORM, "kAmpFloor": AMP_FLOOR}
    assert re.search(r"kInvalidId = (-?\d+);", src).group(1) == str(INVALID_ID)
    assert re.search(r"kMaxOctaves = (\d+);", src).group(1) == str(tex.MAX_NOISE_OCTAVES)


# --- the wrapper -------------------------------------------------------------------------
def test_cpu_tensors_take_the_twin_and_launch_nothing():
    atlas, ids = mixed_atlas()
    u, v = lanes(200, 36)
    tex_ids = np.random.default_rng(37).integers(-1, len(ids) - 1, u.shape[0]).astype(np.int32)
    before = launch_counts()
    profiler.reset()
    with profiler.enable():
        out = tex.sample_texture_many(atlas, torch.from_numpy(tex_ids), torch.from_numpy(u), torch.from_numpy(v),
                                      site="decal")
        counters = profiler.counters()
    profiler.reset()
    assert_bit_equal(torch.stack(list(out), -1).numpy(), twin(atlas, tex_ids, u, v))
    assert launch_counts() == before
    assert counters.get("launches.textures", 0) == 0
    assert counters["textures.lanes.decal"] == u.shape[0]
    assert counters["textures.lanes_textured.decal"] == int((tex_ids != INVALID_ID).sum())


def test_other_devices_raise():
    atlas, ids = mixed_atlas()
    meta = lambda a: torch.from_numpy(a).to("meta")
    u, v = lanes(4, 38)
    with pytest.raises(ValueError, match="unsupported device"):
        tex.sample_texture_many(atlas, meta(np.zeros(u.shape, np.int32)), meta(u), meta(v))


@pytest.mark.parametrize("wrt", ["uv", "atlas"])
def test_the_gradient_route_gives_the_twins_gradients(monkeypatch, wrt):
    """``_KernelWithTwinGrad`` with its forward standing in for the kernel
    (the twin's values): its backward gives the gradients autograd takes
    through the twin itself, of ``u`` and ``v`` or of the atlas's texels
    and colors."""
    atlas, ids = mixed_atlas()
    monkeypatch.setattr(tex, "_sample_kernel", lambda a, i, uu, vv: torch.stack(
        list(tex.sample_texture_many_reference(a, i, uu, vv))).detach())
    u, v = lanes(40, 39)
    tex_ids = torch.from_numpy(np.random.default_rng(40).integers(-1, len(ids) - 1, u.shape[0]).astype(np.int32))
    weights = torch.from_numpy(np.random.default_rng(41).random((3, u.shape[0]), dtype=np.float32))

    def leaves():
        uu, vv = torch.from_numpy(u).requires_grad_(wrt == "uv"), torch.from_numpy(v).requires_grad_(wrt == "uv")
        a = atlas
        if wrt == "atlas":
            a = atlas._replace(data=atlas.data.clone().requires_grad_(),
                               color_a=tex.Vec3(*(c.clone().requires_grad_() for c in atlas.color_a)),
                               color_b=tex.Vec3(*(c.clone().requires_grad_() for c in atlas.color_b)))
        return a, uu, vv, [t for t in (uu, vv, a.data, *a.color_a, *a.color_b) if t.requires_grad]

    a, uu, vv, wanted = leaves()
    want = torch.autograd.grad((torch.stack(list(tex.sample_texture_many_reference(a, tex_ids, uu, vv))) * weights)
                               .sum(), wanted)
    a, uu, vv, wanted = leaves()
    out = tex._KernelWithTwinGrad.apply(a, tex_ids, uu, vv, a.data, *a.color_a, *a.color_b)
    got = torch.autograd.grad((out * weights).sum(), wanted)
    assert len(got) == len(want) == (2 if wrt == "uv" else 7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert any(bool(g.abs().sum() > 0) for g in got)
