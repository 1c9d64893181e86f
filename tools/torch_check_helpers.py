"""The port's small public helpers and its materials-test scene on the card
against the CPU: ``chip_smoke.py`` phase 23.

    python tools/torch_check_helpers.py [cuda|cpu]

- ``helper_outputs(inputs, dev)``: every helper of ``math/vec.py``
  (``length``, ``rsqrt_normalize``, ``reflect``, ``refract``, ``lerp``,
  ``vmin``, ``vmax``, ``vabs``, ``min_component``, ``is_finite``),
  ``math/sampling.py`` (``cos_hemisphere_pdf``,
  ``sample_triangle_barycentric``, ``spherical_to_cartesian``),
  ``math/distribution.py::searchsorted_rows``, ``ops/intersect.py::
  gather_prim`` and ``render/film.py::error_estimate`` on ``helper_inputs``
  (seeded numpy lanes, edges included), as numpy arrays.
  ``tests/test_torch_helpers.py`` holds them against the JAX package on the
  CPU.
- ``helpers_against_cpu`` (23 a): the same inputs over 2^20 lanes on the
  card and on the CPU: bit-equal, but where ``BOUNDS`` names the op that
  rounds otherwise and the largest absolute difference it lets through.
- ``sphere_grid_against_cpu`` (23 b): ``scene/presets.py::sphere_grid``
  (64 spheres, 8 BSDFs, a background light) at 32^2, depth 6, MIS, one
  pass, card against CPU, as ``chip_smoke.small_render_agrees`` compares.

A failed check raises SystemExit through ``check``.  With ``cpu`` the
checks run on the CPU against itself (a rehearsal, at 2^12 lanes); with no
argument and no card the script exits.
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

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.math import distribution, sampling  # noqa: E402
from raytracer_tpu_torch.math import vec as V  # noqa: E402
from raytracer_tpu_torch.math.transform import RigidTransform  # noqa: E402
from raytracer_tpu_torch.ops.intersect import gather_prim  # noqa: E402
from raytracer_tpu_torch.render.film import Film, error_estimate  # noqa: E402
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams  # noqa: E402
from raytracer_tpu_torch.scene.camera import make_camera  # noqa: E402
from raytracer_tpu_torch.scene.presets import sphere_grid  # noqa: E402

LANES = 1 << 20
HELPERS = ("length", "rsqrt_normalize", "reflect", "refract", "lerp", "vmin", "vmax", "vabs", "min_component",
           "is_finite", "cos_hemisphere_pdf", "sample_triangle_barycentric", "spherical_to_cartesian",
           "searchsorted_rows", "gather_prim", "error_estimate")
# entries of a searchsorted_rows row: not a power of two, where the
# reference's search is one step short (tests/test_torch_helpers.py)
ROWS_K = 15
# the whole 8 x 8 grid (spheres at z = 6, x and y in -4.8 .. 3.6) in view
SPHERE_GRID_CAMERA = (dict(translation=(-0.6, -0.6, -4.0)), dict(fov_deg=55.0))
# card against CPU: the helpers that go through an op the two devices round
# differently, with that op and the largest absolute difference let through
# (their outputs are at most 1 in magnitude: 4 ulps at 1)
BOUNDS = {
    "rsqrt_normalize": ("CUDA's rsqrtf (2 ulp) against the CPU's 1 / sqrt", 4.8e-7),
    "spherical_to_cartesian": ("CUDA's sinf / cosf", 4.8e-7),
}


def helper_inputs(n: int, seed: int = 0) -> dict:
    """Seeded float32 / int inputs of every helper, ``n`` lanes (a few
    edges at the front)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    unit = lambda m: f32(m / np.linalg.norm(m, axis=1, keepdims=True))
    a = f32(rng.normal(size=(n, 3)) * rng.uniform(0.1, 10.0, (n, 1)))
    b = f32(rng.normal(size=(n, 3)))
    a[:3] = [[0.0, 0.0, 0.0], [-0.0, 1.0, -1.0], [3e38, -3e38, 1e-30]]
    odd = a.copy()
    odd[3:9] = [[np.inf, 0, 0], [0, -np.inf, 0], [0, 0, np.nan], [np.nan, np.inf, 1], [1, 2, 3], [-1, -2, -3]]
    nrm = unit(rng.normal(size=(n, 3)))
    i = unit(rng.normal(size=(n, 3)))
    cos_theta = f32(rng.uniform(-1.0, 1.0, n))
    cos_theta[:4] = [1.0, -1.0, 0.0, -0.0]
    u1, u2 = f32(rng.random(n)), f32(rng.random(n))
    u1[:2] = [0.0, 1.0 - 2.0 ** -24]
    # sorted rows with ties (a few distinct steps a row), u at the entries
    # themselves in a quarter of the lanes
    rows = f32(np.cumsum(rng.integers(0, 3, (n, ROWS_K)), axis=1) / (2.0 * ROWS_K))
    u_rows = f32(rng.uniform(-0.1, 1.2, n))
    at = rng.random(n) < 0.25
    u_rows[at] = rows[at, rng.integers(0, ROWS_K, int(at.sum()))]
    side = max(1, int(np.sqrt(n)))
    film = f32(rng.random((2, side, side, 3)) * 10.0 ** rng.uniform(-3, 2, (2, side, side, 1)))
    return dict(a=a, b=b, odd=odd, nrm=nrm, i=i, eta=f32(rng.uniform(1.0, 2.5, n)), t=f32(rng.uniform(-0.5, 1.5, n)),
                cos_theta=cos_theta, phi=f32(rng.uniform(0.0, 2.0 * np.pi, n)), u1=u1, u2=u2, rows=rows,
                u_rows=u_rows, prim_idx=rng.integers(-1, 64, n).astype(np.int32), film=film, passes=(5, 3))


def _v(a, dev) -> V.Vec3:
    t = torch.as_tensor(a, device=dev)
    return V.Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(), t[:, 2].contiguous())


def _np(x):
    if isinstance(x, V.Vec3) or isinstance(x, tuple):
        return np.stack([_np(c) for c in x], -1) if isinstance(x, V.Vec3) else tuple(_np(c) for c in x)
    return x.cpu().numpy()


def helper_outputs(inputs: dict, dev, prims=None) -> dict:
    """{helper name: numpy output(s)} of every helper on ``dev``.
    ``prims``: the ``Primitives`` ``gather_prim`` reads (default: the
    ``sphere_grid`` scene's, built on ``dev``)."""
    t = lambda k: torch.as_tensor(inputs[k], device=dev)
    a, b, nrm, i = (_v(inputs[k], dev) for k in ("a", "b", "nrm", "i"))
    if prims is None:
        prims = sphere_grid(device=dev)[0].prims
    kind, rot, trans, param, mat, light = gather_prim(prims, t("prim_idx"))
    n, m = inputs["passes"]
    film = Film(sum=t("film")[0], secondary_sum=t("film")[1], num_passes=n, num_secondary_passes=m)
    out = {
        "length": V.length(a),
        "rsqrt_normalize": V.rsqrt_normalize(b),
        "reflect": V.reflect(i, nrm),
        "refract": V.refract(i, nrm, t("eta")),
        "lerp": V.lerp(a, b, t("t")),
        "vmin": V.vmin(a, b),
        "vmax": V.vmax(a, b),
        "vabs": V.vabs(a),
        "min_component": V.min_component(a),
        "is_finite": V.is_finite(_v(inputs["odd"], dev)),
        "cos_hemisphere_pdf": sampling.cos_hemisphere_pdf(t("cos_theta")),
        "sample_triangle_barycentric": sampling.sample_triangle_barycentric(t("u1"), t("u2")),
        "spherical_to_cartesian": sampling.spherical_to_cartesian(t("phi"), t("cos_theta")),
        "searchsorted_rows": distribution.searchsorted_rows(t("rows"), t("u_rows")),
        "gather_prim": (kind, *rot.r0, *rot.r1, *rot.r2, *trans, *param, mat, light),
        "error_estimate": error_estimate(film),
    }
    assert tuple(out) == HELPERS
    return {k: _np(v) for k, v in out.items()}


def _flat(x):
    return np.concatenate([np.asarray(c).reshape(-1) for c in x]) if isinstance(x, tuple) else np.asarray(x).reshape(-1)


def helpers_against_cpu(dev, log=print, n=LANES):
    """Phase 23 a.  Returns {helper: (lanes apart, largest absolute
    difference)}."""
    inputs = helper_inputs(n)
    t0 = time.perf_counter()
    got = helper_outputs(inputs, dev)
    log(f"helpers over {n} lanes on {dev} in {time.perf_counter() - t0:.2f} s (host copies included)")
    want = helper_outputs(inputs, "cpu")
    out = {}
    for name in want:
        g, w = _flat(got[name]), _flat(want[name])
        same = np.array_equal(g.view(np.uint32), w.view(np.uint32)) if g.dtype == np.float32 else np.array_equal(g, w)
        if g.dtype == np.float32:
            both = np.isfinite(g) & np.isfinite(w)
            apart = int((g.view(np.uint32) != w.view(np.uint32)).sum())
            err = float(np.abs(g[both] - w[both]).max()) if both.any() else 0.0
            same_specials = np.array_equal(np.isnan(g), np.isnan(w)) and np.array_equal(g[np.isinf(g)], w[np.isinf(w)])
        else:
            apart, err, same_specials = int((g != w).sum()), float(np.abs(g.astype(np.int64) - w).max()), True
        out[name] = (apart, err)
        if name in BOUNDS:
            op, bound = BOUNDS[name]
            log(f"helper {name}: {apart} of {g.size} values apart, largest difference {err:.3e} (bound {bound:.1e}: "
                f"{op})")
            check(same_specials and err <= bound, f"helper {name}: card within {bound:.1e} of the CPU ({op})", log)
        else:
            log(f"helper {name}: {'bit-equal' if same else f'{apart} values apart, largest difference {err:.3e}'}")
            check(same, f"helper {name}: the card's values are the CPU's, bit for bit", log)
    return out


def sphere_grid_scene(dev):
    """(scene, meta, cam): ``sphere_grid()`` and the camera that sees all of it."""
    scene, meta = sphere_grid(device=dev)
    t_kw, c_kw = SPHERE_GRID_CAMERA
    return scene, meta, make_camera(RigidTransform(**t_kw), **c_kw, device=dev)


def sphere_grid_against_cpu(dev, log=print, size=32):
    """Phase 23 b: one pass at ``size``^2, depth 6, MIS on ``dev`` and on the
    CPU: >= 98% of pixels within atol 1e-4 / rtol 1e-3 and the means within
    1%.  Returns the share of pixels within."""
    views = []
    for where in ("cpu", dev):
        views.append(Viewport(*sphere_grid_scene(where), ViewportParams(size, size, seed=0),
                              RenderParams(max_depth=6, mis=True), device=where).render(1))
    a, b = (v.radiance() for v in views)
    close = float(np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1).mean())
    log(f"sphere_grid {size}^2 depth 6 MIS, {dev} against cpu: {close:.4f} of pixels within atol 1e-4 rtol 1e-3; "
        f"means {a.mean():.6f} / {b.mean():.6f}; rays {views[0].progress()['total_rays']:.0f} / "
        f"{views[1].progress()['total_rays']:.0f}")
    check(close >= 0.98 and abs(a.mean() - b.mean()) <= 0.01 * abs(a.mean()) and np.isfinite(b).all(),
          f"sphere_grid at {size}^2 on {dev} agrees with the CPU render", log)
    return close


def main():
    arg = sys.argv[1] if len(sys.argv) > 1 else None
    if arg != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to rehearse on the CPU")
    dev = "cpu" if arg == "cpu" else "cuda"
    helpers_against_cpu(dev, n=LANES if dev == "cuda" else 1 << 12)
    sphere_grid_against_cpu(dev, size=32 if dev == "cuda" else 8)
    print("helper checks passed")


if __name__ == "__main__":
    main()
