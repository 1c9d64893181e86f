"""The texture stack, the env-map distribution and the postprocess pipeline
on one device against the CPU.

    python tools/torch_check_textures.py [cuda|cpu]

(cuda by default; it exits when there is no card.)

None of this is a hand-written kernel: it is plain PyTorch, and the check is
that the device computes what the CPU computes.  ``check_textures`` samples
2^20 lanes of mixed texture ids (three bitmaps in the three filters, a
checkerboard, noise with 1 and 8 octaves, a mix, a constant and INVALID_ID):
nearest texel fetches, the checkerboard, constants and invalid lanes must be
bit-equal, everything else within ``ATOL``.  ``check_env`` holds ``sample_2d``
/ ``pdf_2d`` (the picked texel equal in every lane)
and ``env_sample_direction``; ``check_postprocess`` runs each tonemapper with
bloom on and asks ``to_u8`` within one step.  Each logs the time the device
took; a failed check raises SystemExit through ``check``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_check_traverse import check  # noqa: E402

from raytracer_tpu_torch.color.colorhelpers import TONEMAPPER_NAMES  # noqa: E402
from raytracer_tpu_torch.math.distribution import make_distribution_2d, pdf_2d, sample_2d  # noqa: E402
from raytracer_tpu_torch.ops import textures as tex  # noqa: E402
from raytracer_tpu_torch.ops.lights import env_direction_pdf, env_sample_direction  # noqa: E402
from raytracer_tpu_torch.render.postprocess import PostprocessParams, postprocess, to_u8  # noqa: E402

ATOL = 1e-6  # filtered bitmaps, noise, mix, sampled positions and directions
LANES = 1 << 20
BIT_EQUAL = ("nearest", "checker", "const", "invalid")


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def mixed_atlas(device):
    """(atlas, name -> id) with every kind and filter; the second bitmap is
    non-square and narrower than the atlas."""
    rng = np.random.default_rng(5)
    b = tex.AtlasBuilder()
    ids = {
        "nearest": b.add_bitmap(rng.random((64, 64, 3), dtype=np.float32), tex.FILTER_NEAREST),
        "bilinear": b.add_bitmap(rng.random((37, 21, 3), dtype=np.float32), tex.FILTER_BILINEAR),
        "smooth": b.add_bitmap(rng.random((16, 128, 3), dtype=np.float32), tex.FILTER_BILINEAR_SMOOTHSTEP),
        "checker": b.add_checkerboard((0.9, 0.1, 0.2), (0.1, 0.8, 0.3)),
        "noise1": b.add_noise((1.0, 0.9, 0.8), (0.0, 0.1, 0.2), 1),
        "noise8": b.add_noise((0.2, 0.4, 0.6), (0.9, 0.7, 0.5), 8),
    }
    ids["mix"] = b.add_mix(ids["bilinear"], ids["checker"], ids["noise1"])
    ids["const"] = b.add_const((0.25, 0.5, 0.75))
    ids["invalid"] = -1
    return b.build(device), ids


def check_textures(dev, log=print, lanes=LANES):
    rng = np.random.default_rng(6)
    cpu_atlas, ids = mixed_atlas("cpu")
    dev_atlas, _ = mixed_atlas(dev)
    names = list(ids)
    tid = rng.integers(0, len(names), lanes)
    tid_np = np.asarray([ids[n] for n in names], np.int32)[tid]
    u = rng.uniform(-2.0, 3.0, lanes).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, lanes).astype(np.float32)
    edges = np.array([0.0, 1.0, -1e-9, -0.25, 2.0, 1.0 / 21, 20.0 / 21, 1.0 / 37, 0.5, 1.0 / 64, 63.0 / 64,
                      0.99999994, -1.0, 1.5], np.float32)
    u[:len(edges)], v[:len(edges)] = edges, edges[::-1]
    want = tex.sample_texture_many(cpu_atlas, torch.from_numpy(tid_np), torch.from_numpy(u), torch.from_numpy(v))
    args = [torch.from_numpy(a).to(dev) for a in (tid_np, u, v)]
    tex.sample_texture_many(dev_atlas, *args)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    got = tex.sample_texture_many(dev_atlas, *args)
    _sync(dev)
    dt = time.perf_counter() - t0
    want = torch.stack(list(want), -1)
    got = torch.stack([c.cpu() for c in got], -1)
    for name in names:
        lanes_of = torch.from_numpy(tid == names.index(name))
        a, b = want[lanes_of], got[lanes_of]
        err = float((a - b).abs().max())
        exact = name in BIT_EQUAL
        log(f"textures [{name}] {int(lanes_of.sum())} lanes: max |device - cpu| {err:.3g}"
            f"{' (bit-equal asked)' if exact else f' (atol {ATOL:g})'}, "
            f"{float((a != b).any(-1).float().mean()):.2e} of lanes differ at all")
        check(torch.equal(a, b) if exact else err <= ATOL,
              f"sample_texture_many [{name}] on {dev} agrees with the CPU", log)
    check(bool((got[torch.from_numpy(tid_np == -1)] == 1.0).all()), "INVALID_ID lanes give 1.0", log)
    hx = rng.integers(-2**31, 2**31, 1 << 16).astype(np.int32)
    hy = rng.integers(-2**31, 2**31, 1 << 16).astype(np.int32)
    check(torch.equal(tex._hash2(torch.from_numpy(hx).to(dev), torch.from_numpy(hy).to(dev)).cpu(),
                      tex._hash2(torch.from_numpy(hx), torch.from_numpy(hy))),
          f"_hash2 on {dev} bit-equal to the CPU", log)
    log(f"textures: sample_texture_many over {lanes} mixed lanes on {dev}: {dt * 1e3:.2f} ms")
    # what the table's static facts save: a table of bitmaps and one 4-octave noise, as the
    # textured interior's, against the same table with the defaults (every kind, 8 octaves)
    b = tex.AtlasBuilder()
    b.add_bitmap(rng.random((64, 64, 3), dtype=np.float32), tex.FILTER_BILINEAR_SMOOTHSTEP)
    b.add_noise((1.0, 1.0, 1.0), (0.0, 0.0, 0.0), 4)
    narrow = b.build(dev)
    full = narrow._replace(**{f: type(narrow)._field_defaults[f] for f in ("kinds_present", "max_octaves")})
    ids2 = torch.from_numpy(rng.integers(-1, 2, lanes).astype(np.int32)).to(dev)
    times = {}
    for label, atlas in (("narrowed", narrow), ("defaults", full), ("narrowed again", narrow)):
        _sync(dev)
        t0 = time.perf_counter()
        out = tex.sample_texture_many(atlas, ids2, args[1], args[2])
        _sync(dev)
        times[label] = (time.perf_counter() - t0, out)
    check(all(torch.equal(p, q) for p, q in zip(times["narrowed"][1], times["defaults"][1])),
          "the table's static facts leave out nothing that a lane selects (bit-equal to the defaults)", log)
    log("textures: bitmap + 4-octave noise table, " + ", ".join(f"{k} {v[0] * 1e3:.2f} ms" for k, v in times.items()))


def env_image(h=256, w=512):
    rng = np.random.default_rng(7)
    img = rng.random((h, w)) ** 4
    img[40:44, 100:104] = 500.0  # a sun
    img[200] = 0.0  # an empty row
    theta = (np.arange(h) + 0.5) / h * np.pi
    return img * np.sin(theta)[:, None]


def check_env(dev, log=print, lanes=LANES):
    rng = np.random.default_rng(8)
    cpu_d, dev_d = make_distribution_2d(env_image(), device="cpu"), make_distribution_2d(env_image(), device=dev)
    u1, u2 = (rng.random(lanes).astype(np.float32) for _ in range(2))
    u1[:4], u2[:4] = [0.0, 0.99999994, 0.5, 0.25], [0.99999994, 0.0, 0.25, 0.5]
    cu, cv, cd = sample_2d(cpu_d, torch.from_numpy(u1), torch.from_numpy(u2))
    a1, a2 = torch.from_numpy(u1).to(dev), torch.from_numpy(u2).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    du, dv, dd = sample_2d(dev_d, a1, a2)
    _sync(dev)
    dt = time.perf_counter() - t0
    same = dd.cpu() == cd
    log(f"env: sample_2d over {lanes} lanes on {dev}: {dt * 1e3:.2f} ms; same texel in "
        f"{float(same.float().mean()):.6f} of lanes; max |u|, |v| difference there "
        f"{float((du.cpu() - cu)[same].abs().max()):.3g}, {float((dv.cpu() - cv)[same].abs().max()):.3g}")
    check(bool(same.all()), "sample_2d picks the same texel as the CPU in every lane", log)
    check(float((du.cpu() - cu).abs().max()) <= ATOL and float((dv.cpu() - cv).abs().max()) <= ATOL,
          f"sample_2d positions within {ATOL:g} of the CPU's", log)
    check(torch.equal(pdf_2d(dev_d, a1, a2).cpu(), pdf_2d(cpu_d, torch.from_numpy(u1), torch.from_numpy(u2))),
          "pdf_2d equal to the CPU's", log)
    (cdir, cpdf), (ddir, dpdf) = env_sample_direction(cpu_d, torch.from_numpy(u1), torch.from_numpy(u2)), \
        env_sample_direction(dev_d, a1, a2)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(ddir, cdir))
    rel = float(((dpdf.cpu() - cpdf).abs() / cpdf.clamp_min(1e-20)).max())
    log(f"env: env_sample_direction max |direction difference| {err:.3g}, max relative pdf difference {rel:.3g}")
    check(err <= 1e-6 and rel <= 1e-5,
          "env_sample_direction within 1e-6 (direction) and rtol 1e-5 (pdf) of the CPU's", log)
    # the pdf a direction is weighed with is the pdf it was sampled with (same texel: away from texel borders)
    back = env_direction_pdf(dev_d, ddir)
    agree = float(torch.isclose(back, dpdf, rtol=1e-3).float().mean())
    log(f"env: env_direction_pdf(sampled direction) equals the sampling pdf in {agree:.4f} of lanes")
    check(agree >= 0.97, "the NEE pdf and the miss-branch pdf are one function", log)


def check_postprocess(dev, log=print, size=512):
    rng = np.random.default_rng(9)
    img = rng.gamma(0.7, 0.8, (size, size, 3)).astype(np.float32)
    img[100:110, 200:220] = 60.0
    for name, tm in sorted(TONEMAPPER_NAMES.items(), key=lambda kv: kv[1]):
        for blue in (True, False):
            params = PostprocessParams(tonemapper=tm, bloom_factor=0.3, exposure=0.5, blue_noise_dither=blue)
            want = postprocess(torch.from_numpy(img), params, dither_seed=3)
            x = torch.from_numpy(img).to(dev)
            _sync(dev)
            t0 = time.perf_counter()
            got = postprocess(x, params, dither_seed=3)
            got8 = to_u8(got)
            _sync(dev)
            dt = time.perf_counter() - t0
            err = float((got.cpu() - want).abs().max())
            step = int((got8.cpu().to(torch.int32) - to_u8(want).to(torch.int32)).abs().max())
            log(f"postprocess [{name}, {'blue-noise' if blue else 'hashed'} dither, bloom] {size}^2 on {dev}: "
                f"{dt * 1e3:.2f} ms, max |device - cpu| {err:.3g}, to_u8 differs by at most {step}")
            check(err <= 1e-5 and step <= 1,
                  f"postprocess [{name}] on {dev} within 1e-5 of the CPU, to_u8 within 1", log)


def check_all(dev, log=print, lanes=LANES):
    check_textures(dev, log, lanes)
    check_env(dev, log, lanes)
    check_postprocess(dev, log)


if __name__ == "__main__":
    where = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if torch.device(where).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to run the checks on the CPU")
    check_all(where, lanes=LANES if where != "cpu" else 1 << 14)
