"""The texture stack, the env-map distribution and the postprocess pipeline
on one device against the CPU, and the texture kernel against its plain twin.

    python tools/torch_check_textures.py [cuda|cpu]

(cuda by default; it exits when there is no card.)

On CUDA tensors ``sample_texture_many`` launches the hand-written kernel
``csrc/textures.cu``; the env map and the postprocess pipeline are plain
PyTorch.  ``check_texture_kernel`` (card only) holds the kernel against the
plain twin ``sample_texture_many_reference`` on the same card, bit for bit,
at 2,073,600 lanes (a 1080p call) over two tables: the mixed one of
``mixed_atlas`` and the textured hall's (``hall_atlas``: the 1024^2 bitmaps
of ``benchmark/generators/hall_tex.py``), logging the lanes that differ if
any do; checks one launch a call and the gradient route (``u`` and ``v``
requiring grad give the twin's gradients); and times the kernel and the
twin.  ``check_textures`` samples 2^20 lanes of mixed texture ids (three
bitmaps in the three filters, a checkerboard, noise with 1 and 8 octaves, a
mix, a constant and INVALID_ID) on the device and on the CPU: nearest texel
fetches, the checkerboard, constants and invalid lanes must be bit-equal,
everything else within ``ATOL``.  ``check_env`` holds ``sample_2d`` /
``pdf_2d`` (the picked texel equal in every lane)
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

from torch_check_traverse import bound_ms, check, cuda_ms, kernel_ms  # noqa: E402

from raytracer_tpu_torch.color.colorhelpers import TONEMAPPER_NAMES  # noqa: E402
from raytracer_tpu_torch.io.scene_loader import load_scene  # noqa: E402
from raytracer_tpu_torch.math.vec import Vec3  # noqa: E402
from raytracer_tpu_torch.ops import cuda_build  # noqa: E402
from raytracer_tpu_torch.math.distribution import make_distribution_2d, pdf_2d, sample_2d  # noqa: E402
from raytracer_tpu_torch.ops import textures as tex  # noqa: E402
from raytracer_tpu_torch.ops.lights import env_direction_pdf, env_sample_direction  # noqa: E402
from raytracer_tpu_torch.render.postprocess import PostprocessParams, postprocess, to_u8  # noqa: E402
from raytracer_tpu_torch.scene.types import INVALID_ID, TEX_CHECKERBOARD, TEX_CONST, TEX_MIX, TEX_NOISE  # noqa: E402

ATOL = 1e-6  # filtered bitmaps, noise, mix, sampled positions and directions
LANES = 1 << 20
CALL_LANES = 1920 * 1080  # one of the textured hall's calls at 1080p
GRAD_LANES = 1 << 16  # the twin's autograd graph holds ~3,800 tensors of the lanes
HALL_TEX = os.path.join(ROOT, "benchmark", "generators", "hall_tex.py")
HALL_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "hall_tex_atlas")
HALL_INVALID_SHARE = 0.556  # the hall's surface lanes without a texture (texture_lane_fill_pct 44.46)
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


def hall_atlas(device):
    """(atlas, name -> id) of the textured hall: ``hall_tex.write_small``
    writes the hall's textures (1024^2 bitmaps, a 1024 x 512 sky, the
    checkerboard, the 4-octave noise and the mix) over two small meshes,
    and the port's loader builds the atlas from them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("hall_tex_for_texture_check", HALL_TEX)
    hall_tex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hall_tex)
    scene, _, _ = load_scene(hall_tex.write_small(HALL_DIR), strict=True, device=device)
    return scene.textures, {f"row{i}": i for i in range(scene.textures.kind.shape[0])}


def lane_ops(atlas, tex_ids: np.ndarray) -> float:
    """Float operations the lanes' own kinds need (the kernel's arithmetic,
    counted from its source): 0 for an INVALID_ID lane or a constant, ~6 a
    checkerboard or nearest lane, 40 / 46 a bilinear / smoothstep lane, 60
    an octave of noise plus 15, a mix its three subs plus 9."""
    kind, fm, octv = (t.cpu().numpy() for t in (atlas.kind, atlas.filter_mode, atlas.octaves))
    subs = [t.cpu().numpy() for t in (atlas.sub_a, atlas.sub_b, atlas.sub_w)]
    loop = min(atlas.max_octaves, tex.MAX_NOISE_OCTAVES)

    def non_mix(r):
        if kind[r] == TEX_CHECKERBOARD and TEX_CHECKERBOARD in atlas.kinds_present:
            return 6.0
        if kind[r] == TEX_NOISE and TEX_NOISE in atlas.kinds_present:
            return 60.0 * min(max(int(octv[r]), 0), loop) + 15.0
        if kind[r] == TEX_CONST:
            return 0.0
        return 6.0 if fm[r] == tex.FILTER_NEAREST else (46.0 if fm[r] == tex.FILTER_BILINEAR_SMOOTHSTEP else 40.0)

    per_row = [sum(non_mix(int(s[r])) for s in subs) + 9.0 if kind[r] == TEX_MIX and TEX_MIX in atlas.kinds_present
               else non_mix(r) for r in range(kind.shape[0])]
    rows, counts = np.unique(tex_ids[tex_ids != INVALID_ID], return_counts=True)
    return float(sum(per_row[max(int(r), 0)] * c for r, c in zip(rows, counts)))


def check_texture_kernel(dev, log=print, lanes=CALL_LANES):
    """``csrc/textures.cu`` against ``sample_texture_many_reference`` on the
    same card, on the mixed table and on the textured hall's: every output
    bit-equal (or the differing lanes logged by id, and FAIL), one launch a
    call, the gradient route's gradients equal to the twin's; the kernel's
    and the twin's device times beside the kernel's bound.  Returns the
    kernel's row of ``chip_smoke.py``'s table (its time on the hall's
    table)."""
    rng = np.random.default_rng(60)
    row = {}
    for label, (atlas, ids) in (("mixed", mixed_atlas(dev)), ("hall", hall_atlas(dev))):
        rows = sorted(set(ids.values()) - {INVALID_ID})
        tid_np = np.asarray(rows, np.int32)[rng.integers(0, len(rows), lanes)]
        tid_np[rng.random(lanes) < (HALL_INVALID_SHARE if label == "hall" else 0.1)] = INVALID_ID
        u = rng.uniform(-2.0, 3.0, lanes).astype(np.float32)
        v = rng.uniform(-2.0, 3.0, lanes).astype(np.float32)
        edges = np.array([0.0, 1.0, -1e-9, -0.25, 2.0, 1.0 / 1024, 1023.0 / 1024, 0.5, 1.0 / 21, 20.0 / 21,
                          1.0 / 37, 0.99999994, -0.99999994, -1.0, 1.5], np.float32)
        eu, ev = np.meshgrid(edges, edges)
        k = eu.size
        for j, r in enumerate(rows):  # every pair of edges on every row
            u[j * k:(j + 1) * k], v[j * k:(j + 1) * k], tid_np[j * k:(j + 1) * k] = eu.ravel(), ev.ravel(), r
        tid, du, dv = (torch.from_numpy(a).to(dev) for a in (tid_np, u, v))
        before = cuda_build.launch_counts()
        got = torch.stack(list(tex.sample_texture_many(atlas, tid, du, dv)))
        torch.cuda.synchronize()
        launched = (cuda_build.launch_counts() - before)["textures"]
        if label == "mixed":
            log(f"textures kernel build: {cuda_build.BUILD_INFO['textures']['log']}")
        want = torch.stack(list(tex.sample_texture_many_reference(atlas, tid, du, dv)))
        differ = (got.view(torch.int32) != want.view(torch.int32)).any(0).cpu().numpy()
        log(f"textures kernel [{label}] {lanes} lanes, kinds {atlas.kinds_present}, {atlas.kind.shape[0]} rows, "
            f"atlas {tuple(atlas.data.shape)}: {int(differ.sum())} lanes differ from the twin on {dev}"
            + "".join(f"; id {i}: {int((differ & (tid_np == i)).sum())} of {int((tid_np == i).sum())}"
                      for i in sorted(set(tid_np[differ].tolist()))))
        if differ.any():
            j = int(np.argmax(differ))
            log(f"  first: lane {j}, id {tid_np[j]}, u {u[j]!r}, v {v[j]!r}: kernel {got[:, j].tolist()}, "
                f"twin {want[:, j].tolist()}")
        check(not differ.any(), f"textures kernel [{label}] bit-equal to its twin on {dev}", log)
        check(launched == 1, f"textures kernel [{label}]: one launch a call ({launched})", log)
        ms = kernel_ms(lambda: tex.sample_texture_many(atlas, tid, du, dv), "textures_kernel")
        plain = cuda_ms(lambda: tex.sample_texture_many_reference(atlas, tid, du, dv), reps=3, warmup=1)
        ops = lane_ops(atlas, tid_np)
        b_ms, b_by = bound_ms(24.0 * lanes, ops)
        log(f"textures kernel [{label}]: {ms:.4f} ms a call (device duration, median of 20), twin {plain:.3f} ms "
            f"(events, median of 3); bound {b_ms:.4f} ms by {b_by} (24 B a lane in and out, texel reads left "
            f"out; {ops:.3e} operations): {100.0 * b_ms / ms:.1f}% of it")
        row = {"name": "textures", "route": "cuda", "source": "raytracer_tpu_torch/csrc/textures.cu",
               "replaces": "none (raytracer_tpu/ops/textures.py::sample_texture_many, left to XLA)",
               "launches": launched, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
    check_texture_grad(dev, log)
    return row


def check_texture_grad(dev, log=print, lanes=GRAD_LANES):
    """The gradient route: ``u`` and ``v`` requiring grad take
    ``_KernelWithTwinGrad`` (the kernel forward, one launch), and the
    gradients of a weighted sum are bit-equal to those autograd takes
    through the twin.  Then the atlas's texels and colors requiring grad:
    their gradients are scatter-adds over the lanes (the gathers'
    backward), summed in no fixed order, so they are held within 1e-5 of
    the twin's largest of each leaf."""
    rng = np.random.default_rng(61)
    atlas, ids = mixed_atlas(dev)
    tid = torch.from_numpy(rng.integers(-1, len(ids) - 1, lanes).astype(np.int32)).to(dev)
    u0, v0 = (torch.from_numpy(rng.uniform(-2.0, 3.0, lanes).astype(np.float32)).to(dev) for _ in range(2))
    w = torch.from_numpy(rng.random((3, lanes), dtype=np.float32)).to(dev)

    def grads(fn, wrt):
        u, v = u0.clone().requires_grad_(wrt == "uv"), v0.clone().requires_grad_(wrt == "uv")
        a = atlas
        if wrt == "atlas":
            a = atlas._replace(data=atlas.data.clone().requires_grad_(),
                               color_a=Vec3(*(c.clone().requires_grad_() for c in atlas.color_a)),
                               color_b=Vec3(*(c.clone().requires_grad_() for c in atlas.color_b)))
        leaves = [t for t in (u, v, a.data, *a.color_a, *a.color_b) if t.requires_grad]
        out = torch.stack(list(fn(a, tid, u, v)))
        return out.detach(), torch.autograd.grad((out * w).sum(), leaves)

    for wrt in ("uv", "atlas"):
        before = cuda_build.launch_counts()
        out, got = grads(tex.sample_texture_many, wrt)
        launched = (cuda_build.launch_counts() - before)["textures"]
        ref, want = grads(tex.sample_texture_many_reference, wrt)
        exact = all(torch.equal(g, r) for g, r in zip(got, want))
        rel = max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30)) for g, r in zip(got, want))
        log(f"textures gradient route [{wrt}] {lanes} lanes: kernel launches {launched}, gradients bit-equal "
            f"{exact}, max |gradient - twin's| over the twin's largest {rel:.3g}, nonzero "
            f"{[int((g != 0).sum()) for g in got]}")
        check(launched == 1 and torch.equal(out, ref) and (exact if wrt == "uv" else rel <= 1e-5),
              f"textures gradient route [{wrt}]: the kernel forward, the twin's gradients "
              f"({'bit-equal' if wrt == 'uv' else 'within 1e-5'})", log)


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
    """Every check of this file; returns the texture kernel's row on the
    card, None on the CPU."""
    row = check_texture_kernel(dev, log) if torch.device(dev).type == "cuda" else None
    check_textures(dev, log, lanes)
    check_env(dev, log, lanes)
    check_postprocess(dev, log)
    return row


if __name__ == "__main__":
    where = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if torch.device(where).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to run the checks on the CPU")
    check_all(where, lanes=LANES if where != "cpu" else 1 << 14)
