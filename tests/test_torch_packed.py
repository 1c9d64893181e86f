"""Packed codecs of the port (``math/packed.py``) against the JAX package's.

The same seeded numpy inputs (plus hand-picked edges: axes, zeros,
negatives, values below the small floats' smallest normal and above their
largest exponent) go through both packages' encoders: the codes must be
bit-equal, but for one pinned edge lane of RGBE, where XLA:CPU flushes a
denormal scale to zero.  The decoders, given the reference's codes, agree within rtol
1e-6: XLA:CPU's ``exp2`` of an integer is off by an ulp where torch's is
exact.  The octahedral decoder, fp16 and YCoCg are bit-equal (the
octahedral one since it takes a correctly rounded square root: torch's
float32 ``sqrt`` on the CPU is an ulp off in ~0.6% of lanes).  Then the
reference's error budgets (``tests/test_packed.py``) on the port alone.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.math import packed as R
from raytracer_tpu.math.vec import Vec3 as RVec3
from raytracer_tpu_torch.math import packed as P
from raytracer_tpu_torch.math.vec import Vec3

N = 1 << 16
DECODE_RTOL = 1e-6


def _unit(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float64)
    return np.concatenate([axes, v]).astype(np.float32)


def _hdr(n, seed, lo=-3, hi=3):
    rng = np.random.default_rng(seed)
    c = (rng.uniform(0, 1, (n, 3)) * 10.0 ** rng.uniform(lo, hi, (n, 3))).astype(np.float32)
    edges = np.array([[0, 0, 0], [1, 1, 1], [2, 4, 1024], [-1, 0.5, 2], [1e-6, 3e-5, 6.1e-5],
                      [70000, 1e5, 3e38], [2.0 ** -14, 2.0 ** -15, 0.25], [1e-31, 0, 0]], np.float32)
    return np.concatenate([edges, c])


def _both(a: np.ndarray):
    """(reference Vec3, port Vec3) of an (n, 3) array."""
    return RVec3(*(jnp.asarray(a[:, i]) for i in range(3))), Vec3(*(torch.as_tensor(a[:, i]) for i in range(3)))


def _np(v):
    return np.stack([np.asarray(c) for c in v], -1)


INPUTS = {"oct": lambda: _unit(N, 0), "rgbe": lambda: _hdr(N, 2), "r11g11b10": lambda: _hdr(N, 4, -2, 2)}
CODECS = {"oct": ("oct_encode", "oct_decode"), "rgbe": ("rgbe_encode", "rgbe_decode"),
          "r11g11b10": ("r11g11b10_encode", "r11g11b10_decode")}


@pytest.mark.parametrize("codec", list(CODECS))
def test_codes_are_the_reference_bits(codec):
    x = INPUTS[codec]()
    ref_in, port_in = _both(x)
    enc = CODECS[codec][0]
    want = np.asarray(getattr(R, enc)(ref_in))
    got = getattr(P, enc)(port_in)
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    apart = np.nonzero(got.numpy() != want)[0]
    if codec == "rgbe":
        # a colour whose largest channel is 2^127 or more: the shared scale
        # exp2(-128) * 255 is a denormal, which XLA:CPU flushes to zero (the
        # reference packs 0, 0, 0) and the port keeps (the edge lane 3e38)
        assert apart.tolist() == [5] and x[5].max() >= 2.0 ** 127
        assert want[5] == 0xFF000000 and got[5] == 0xFFE10000
    else:
        assert apart.tolist() == []


@pytest.mark.parametrize("codec", list(CODECS))
def test_decodes_match_the_reference(codec):
    enc, dec = CODECS[codec]
    codes = np.asarray(getattr(R, enc)(_both(INPUTS[codec]())[0]))
    want = _np(getattr(R, dec)(jnp.asarray(codes)))
    for given in (torch.as_tensor(codes.copy()), torch.as_tensor(codes.astype(np.int64))):
        np.testing.assert_allclose(_np(getattr(P, dec)(given)), want, rtol=DECODE_RTOL, atol=0)


def test_oct_decode_is_the_reference_bit_for_bit():
    codes = np.asarray(R.oct_encode(_both(INPUTS["oct"]())[0]))
    want = _np(R.oct_decode(jnp.asarray(codes)))
    np.testing.assert_array_equal(_np(P.oct_decode(torch.as_tensor(codes.copy()))).view(np.uint32),
                                  want.view(np.uint32))


def test_half_bits_and_values_are_the_reference():
    x = np.concatenate([np.random.default_rng(1).uniform(-1000, 1000, N),
                        [0.0, -0.0, 65504.0, 1e5, -1e5, 6e-8, 1e-9, 0.1]]).astype(np.float32)
    want = np.asarray(R.half_encode(jnp.asarray(x)))
    got = P.half_encode(torch.as_tensor(x))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P.half_decode(got).numpy(), np.asarray(R.half_decode(jnp.asarray(want))))


def test_ycocg_is_the_reference():
    ref_in, port_in = _both(_hdr(N, 3, -1, 1))
    for f in ("rgb_to_ycocg", "ycocg_to_rgb"):
        np.testing.assert_array_equal(_np(getattr(P, f)(port_in)), _np(getattr(R, f)(ref_in)))


# --- the reference's error budgets, on the port ------------------------------------


def test_octahedral_roundtrip_error_budget():
    v = _both(_unit(20_000, 0))[1]
    d = P.oct_decode(P.oct_encode(v))
    dots = (v.x * d.x + v.y * d.y + v.z * d.z).numpy()
    assert np.degrees(np.arccos(np.clip(dots, -1, 1))).max() < 0.05  # 16-bit octahedral


def test_octahedral_axes_exact_directions():
    axes = _unit(0, 0)
    d = _np(P.oct_decode(P.oct_encode(_both(axes)[1])))
    np.testing.assert_allclose(d, axes, atol=1e-3)


def test_half_roundtrip():
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1000, 1000, 4096).astype(np.float32))
    np.testing.assert_allclose(P.half_decode(P.half_encode(x)).numpy(), x.numpy(), rtol=1e-3)


def test_rgbe_hdr_roundtrip_relative_error():
    c = _hdr(8192, 2)[8:]
    d = _np(P.rgbe_decode(P.rgbe_encode(_both(c)[1])))
    m = np.maximum(c.max(-1, keepdims=True), 1e-30)
    assert (np.abs(c - d) / m).max() < 0.01  # 8-bit mantissa against the largest channel


def test_rgbe_zero_is_exact():
    z = Vec3(torch.zeros(4), torch.zeros(4), torch.zeros(4))
    assert P.rgbe_encode(z).to(torch.int64).eq(0).all()
    np.testing.assert_array_equal(_np(P.rgbe_decode(P.rgbe_encode(z))), 0.0)


def test_ycocg_exact_roundtrip():
    c = np.random.default_rng(3).uniform(0, 4, (4096, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(P.ycocg_to_rgb(P.rgb_to_ycocg(_both(c)[1]))), c, atol=1e-5)


def test_r11g11b10_roundtrip_error_budget():
    c = _hdr(8192, 4, -2, 2)[8:]
    d = _np(P.r11g11b10_decode(P.r11g11b10_encode(_both(c)[1])))
    # 6-bit mantissa: ~1.6% relative; blue's 5 bits ~3.2%; below 2^-14 flushes to zero
    for ch, tol in ((0, 0.017), (1, 0.017), (2, 0.033)):
        a, b = c[:, ch], d[:, ch]
        normal = a >= 2.0 ** -14
        assert (np.abs(a[normal] - b[normal]) / np.maximum(a[normal], 1e-20)).max() < tol
        assert (b[~normal] == 0.0).all()
