"""Port parity: color helpers, the postprocess pipeline and
``Viewport.image()`` of raytracer_tpu_torch against the JAX package.

Tolerances: color helpers atol 1e-6; ``gaussian_blur`` and ``postprocess``
atol 2e-6 (a blur is a sum of up to 61 products per pixel, summed in
another order by each convolution); ``to_u8`` within +-1 (a value that lands
on x.5 may round either way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.color import colorhelpers as ref_color
from raytracer_tpu.render import postprocess as ref_post
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import cornell_box as ref_cornell_box
from raytracer_tpu_torch.color import colorhelpers as color
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.math.transform import RigidTransform
from raytracer_tpu_torch.render import postprocess as post
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.camera import make_camera
from raytracer_tpu_torch.scene.presets import cornell_box, cornell_camera_kw

J, T_ = jnp.asarray, torch.as_tensor
TONEMAPPERS = sorted(color.TONEMAPPER_NAMES.values())


def _hdr(h=40, w=56, seed=0):
    """An HDR image with dark, mid and blown-out pixels, some negative noise."""
    rng = np.random.default_rng(seed)
    img = rng.gamma(0.7, 0.8, (h, w, 3)).astype(np.float32)
    img[5:8, 10:14] = 60.0
    img[20, 30] = [0.0, 0.0, 0.0]
    img[21, 30] = [-0.01, 0.2, 0.1]
    return img


def _close(want, got, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_srgb_round_trip_and_luminance():
    x = np.linspace(-0.1, 1.2, 1001).astype(np.float32)
    _close(ref_color.linear_to_srgb(J(x)), color.linear_to_srgb(T_(x)), 1e-6)
    _close(ref_color.srgb_to_linear(J(x)), color.srgb_to_linear(T_(x)), 1e-6)
    assert color.TONEMAPPER_NAMES == ref_color.TONEMAPPER_NAMES
    r, g, b = (np.random.default_rng(i).random(64).astype(np.float32) for i in range(3))
    _close(ref_color.luminance(J(r), J(g), J(b)), color.luminance(T_(r), T_(g), T_(b)), 1e-6)


def test_srgb_decode_of_8bit_values_within_one_ulp():
    """The 256 values a bitmap decode can see.  XLA's float32 ``pow`` and
    torch's are each within an ulp of the true value but not of each other:
    a handful of the 256 codes differ by one ulp (6e-8), never more."""
    x = (np.arange(256, dtype=np.float32) / np.float32(255.0))
    a, b = np.asarray(ref_color.srgb_to_linear(J(x))), color.srgb_to_linear(T_(x)).numpy()
    assert np.abs(a - b).max() <= 6e-8
    assert (a != b).sum() <= 16


@pytest.mark.parametrize("tonemapper", TONEMAPPERS)
def test_tonemap(tonemapper):
    x = _hdr().reshape(-1)
    _close(ref_color.tonemap(J(x), tonemapper), color.tonemap(T_(x), tonemapper), 1e-6)


def test_tonemap_refuses_an_unknown_curve():
    with pytest.raises(ValueError, match="invalid tonemapper"):
        color.tonemap(torch.ones(3), 9)


def test_hsv_to_rgb():
    rng = np.random.default_rng(3)
    h = rng.uniform(-1.0, 2.0, 512).astype(np.float32)
    h[:7] = [0.0, 1.0 / 6, 2.0 / 6, 0.5, 4.0 / 6, 5.0 / 6, 1.0]
    s, v = rng.random(512).astype(np.float32), rng.random(512).astype(np.float32)
    for a, b in zip(ref_color.hsv_to_rgb(J(h), J(s), J(v)), color.hsv_to_rgb(T_(h), T_(s), T_(v))):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("sigma", [1.0, 2.0, 10.0])
def test_gaussian_blur_zero_padding(sigma):
    img = _hdr()
    want = ref_post.gaussian_blur(J(img), sigma)
    got = post.gaussian_blur(T_(img), sigma)
    assert got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=2e-6)
    # zero padding darkens the border of a constant image
    flat = post.gaussian_blur(torch.ones(16, 16, 3), 2.0)
    assert flat[0, 0, 0] < 0.5 and abs(float(flat[8, 8, 0]) - 1.0) < 1e-3


@pytest.mark.parametrize("blue_noise", [True, False], ids=["blue-noise", "hashed"])
@pytest.mark.parametrize("tonemapper", TONEMAPPERS)
def test_postprocess_with_bloom_and_dither(tonemapper, blue_noise):
    img = _hdr(seed=tonemapper)
    kw = dict(color_filter=(1.0, 0.9, 0.8), exposure=0.5, contrast=0.8, saturation=0.9, bloom_factor=0.3,
              blue_noise_dither=blue_noise, tonemapper=tonemapper)
    want = ref_post.postprocess(J(img), ref_post.PostprocessParams(**kw), dither_seed=5)
    got = post.postprocess(T_(img), post.PostprocessParams(**kw), dither_seed=5)
    _close(want, got, 2e-6)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    a, b = np.asarray(ref_post.to_u8(want)).astype(np.int32), post.to_u8(got).numpy().astype(np.int32)
    assert post.to_u8(got).dtype == torch.uint8
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() < 1e-3


def test_postprocess_defaults_and_switches():
    img = _hdr(seed=9)
    assert post.PostprocessParams() == post.PostprocessParams(**ref_post.PostprocessParams().__dict__)
    for kw in (dict(), dict(dithering_strength=0.0), dict(contrast=1.0, saturation=1.0),
               dict(bloom_factor=0.5, bloom_levels=2)):
        want = ref_post.postprocess(J(img), ref_post.PostprocessParams(**kw), dither_seed=2)
        got = post.postprocess(T_(img), post.PostprocessParams(**kw), dither_seed=2)
        _close(want, got, 2e-6)
    assert post.apply_bloom(T_(img), post.PostprocessParams()) is not None
    same = T_(img)
    assert post.apply_bloom(same, post.PostprocessParams(bloom_factor=0.0)) is same


def test_viewport_image_matches_reference():
    """``Viewport.image()``: uint8 sRGB on the host, within +-1 of the JAX
    package's on the same 16^2 Cornell render (the radiance agrees to 1e-4)."""
    t_kw, c_kw = cornell_camera_kw()
    pp = dict(bloom_factor=0.2, exposure=1.0)
    rv = RefViewport(*ref_cornell_box(), ref_make_camera(RefRigidTransform(**t_kw), **c_kw),
                     RefViewportParams(16, 16, seed=0), RefRenderParams(max_depth=3, mis=True),
                     ref_post.PostprocessParams(**pp))
    pv = Viewport(*cornell_box(device="cpu"), make_camera(RigidTransform(**t_kw), **c_kw, device="cpu"),
                  ViewportParams(16, 16, seed=0), RenderParams(max_depth=3, mis=True),
                  post.PostprocessParams(**pp), device="cpu")
    a, b = rv.render(2).image(), pv.render(2).image()
    assert b.dtype == np.uint8 and b.shape == (16, 16, 3) and isinstance(b, np.ndarray)
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    assert b.min() < b.max()
