"""Reverse-mode gradients of the PyTorch port on one device: the
forward+backward step, its checks, and the ``wave`` engine against wave2.

    python tools/torch_check_gradients.py [cuda|cpu]

Gradients are autograd of ``render/renderer.py::trace_rows``; no hand
kernel has a backward (traversal is detached, as in the reference), so the
step's kernels are the forward's: ``wave2_mt`` under wave2, ``bvh_walk``
under ``bvh``.  ``chip_smoke.py`` phase 16 calls:

- ``time_fwd_bwd``: the port's counterpart of ``bench.py::bench_backward``
  (the loss ``mean(r + g + b)`` of ``trace_rows`` at pass 0 without a
  Halton vector, the gradients of ``base_color``, ``emission`` and
  ``roughness``; one warm-up call, then timed calls that end on a host copy
  of one gradient entry; rays = camera + bounce + shadow rays of one
  forward), with the forward alone timed with and without the graph, the
  peak device memory and the bytes autograd saves;
- ``check_against_cpu`` (a): the gradients of ``test_scene`` (the scene of
  ``tests/test_gradients.py``, built with the port) on the device against
  the CPU, with respect to the material tables, the light colours, the
  camera origin and a yaw of the camera basis (the camera's per pixel);
- ``check_finite_differences`` (b): central differences of one emission
  entry and one light-colour entry, in which radiance is linear;
- ``check_finite`` (c): every gradient finite, some base colour's non-zero;
- ``descend`` (d): plain gradient descent with ``parallel.mesh.train_step``
  on ``base_color`` toward a target rendered with the true tables;
- ``wave_against_wave2``: the ``wave`` engine against wave2 on one window
  of rays: tri ids equal but on exact ties, t bit-equal where they agree,
  occlusion equal; both timed.

A failed check raises SystemExit through ``check``.  ``main`` runs (a), (b)
and (d) on the small test scenes, on the card, or at a small size on the
CPU when given ``cpu`` (a rehearsal of the phase); with no argument and no
card it exits without running anything.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_check_traverse import check, vec  # noqa: E402

from raytracer_tpu_torch.integrators.path_tracer import RenderParams  # noqa: E402
from raytracer_tpu_torch.math.transform import RigidTransform  # noqa: E402
from raytracer_tpu_torch.math.vec import Vec3  # noqa: E402
from raytracer_tpu_torch.ops import wave2_traverse as w2  # noqa: E402
from raytracer_tpu_torch.ops import wave_traverse as wv  # noqa: E402
from raytracer_tpu_torch.ops.cuda_build import launch_counts  # noqa: E402
from raytracer_tpu_torch.parallel.mesh import material_leaves, train_step  # noqa: E402
from raytracer_tpu_torch.render.renderer import ViewportParams, trace_rows  # noqa: E402
from raytracer_tpu_torch.scene import types as T  # noqa: E402
from raytracer_tpu_torch.scene.build import LightDesc, MaterialDesc, SceneBuilder  # noqa: E402
from raytracer_tpu_torch.scene.camera import make_camera  # noqa: E402

BIGF = 3.0e38
RTOL, ATOL = 2e-4, 1e-6  # two computations of the same gradients (tests/test_parallel.py)
FD_RTOL = 0.05  # tests/test_gradients.py


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def test_scene(device):
    """``tests/test_gradients.py::_scene`` built with the port: a big rect and
    a sphere of one diffuse material, a background and a point light."""
    b = SceneBuilder()
    m = b.add_material(MaterialDesc(bsdf="diffuse", base_color=(0.6, 0.5, 0.4)))
    b.add_rect(RigidTransform(translation=(0, 0, 3), euler_deg=(180, 0, 0)), (20, 20), m)
    b.add_sphere(RigidTransform(translation=(0.5, 0, 2)), 0.4, m)
    b.add_light(LightDesc(kind=T.LIGHT_BACKGROUND, color=(0.5, 0.5, 0.5)))
    b.add_light(LightDesc(kind=T.LIGHT_POINT, color=(5.0, 4.0, 3.0), transform=RigidTransform(translation=(0, 1, 1))))
    scene, meta = b.build(device)
    return scene, meta, make_camera(RigidTransform(), fov_deg=40.0, device=device)


def fwd_bwd(scene, meta, cam, vp, params):
    """One step of ``bench.py::bench_backward``: the loss mean(r + g + b) of
    ``trace_rows`` at pass 0 and its gradients with respect to the three
    material tables (7 tensors).  Returns (loss, grads, counters)."""
    s, flat = material_leaves(scene)
    r, counters = trace_rows(s, meta, cam, 0, None, vp, params)
    loss = (r.x + r.y + r.z).mean()
    return loss.detach(), torch.autograd.grad(loss, flat, materialize_grads=True), counters


def saved_tensor_bytes(run):
    """Runs ``run()`` with autograd's saved tensors counted: (result, bytes
    of the distinct storages saved for backward, tensors saved)."""
    storages, count = {}, [0]

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        count[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = run()
    return out, sum(storages.values()), count[0]


def check_finite(grads, label, log=print):
    """(c): every gradient finite; some material's base colour gradient
    non-zero."""
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"every gradient is finite ({label})", log)
    check(any(bool((g != 0).any()) for g in grads[0:3]),
          f"some visible material's base_color gradient is non-zero ({label})", log)


def time_fwd_bwd(scene, meta, cam, dev, log, label, size=256, depth=4, reps=3):
    """The step at ``size``^2, depth ``depth``, MIS: one warm-up call, then
    ``reps`` timed calls that end on a host copy of one gradient entry, with
    the peak memory of a call.  Then one call in two halves, each ended by a
    synchronise: the forward that records the graph (with the bytes it
    saves) and the backward; and the forward alone under
    ``torch.no_grad()``.  Returns (numbers, the last timed call's grads)."""
    vp, params = ViewportParams(size, size, seed=0), RenderParams(max_depth=depth, mis=True)
    on_card = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    _, first, counters = fwd_bwd(scene, meta, cam, vp, params)
    first[0][:1].cpu()
    warm = time.perf_counter() - t0
    rays = float(counters.num_rays) + float(counters.num_shadow_rays)
    check_finite(first, f"{label} warm-up", log)
    counts0 = launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        loss, grads, _ = fwd_bwd(scene, meta, cam, vp, params)
    grads[0][:1].cpu()
    dt = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else float("nan")
    per_call = (launch_counts() - counts0)["wave2_mt"] / reps
    check_finite(grads, label, log)
    repeat = all(torch.equal(a, b) for a, b in zip(first, grads))

    def timed(run):
        _sync(dev)
        t0 = time.perf_counter()
        out = run()
        _sync(dev)
        return time.perf_counter() - t0, out

    def forward():
        s, flat = material_leaves(scene)
        r, _ = trace_rows(s, meta, cam, 0, None, vp, params)
        return (r.x + r.y + r.z).mean(), flat

    fwd_graph, ((f_loss, flat), saved, n_saved) = timed(lambda: saved_tensor_bytes(forward))
    bwd, _ = timed(lambda: torch.autograd.grad(f_loss, flat, materialize_grads=True))
    with torch.no_grad():
        fwd_plain, _ = timed(forward)
    out = {"size": size, "depth": depth, "rays": rays, "s_per_call": dt, "warm_up_s": warm,
           "mrays_per_sec": rays / dt / 1e6, "forward_s": fwd_plain, "forward_with_graph_s": fwd_graph,
           "backward_s": bwd, "peak_gib": peak, "saved_gib": saved / 2**30, "saved_tensors": n_saved,
           "wave2_mt_per_call": per_call, "loss": float(loss), "forwards": reps + 3, "bit_repeatable": repeat}
    log(f"fwd_bwd [{label}] {size}^2 depth {depth}: {dt:.4f} s a call ({reps} calls; warm-up {warm:.2f} s), "
        f"{rays:.0f} rays a forward, {out['mrays_per_sec']:.4f} Mray/s; forward alone {fwd_plain:.4f} s; a call in "
        f"halves: forward with the graph {fwd_graph:.4f} s, backward {bwd:.4f} s; peak {peak:.2f} GiB; saved for "
        f"backward {out['saved_gib']:.3f} GiB in {n_saved} tensors; wave2_mt launches a call {per_call:.1f}; loss "
        f"{out['loss']:.6f}; the last call's gradients bit-equal to the first's: {repeat}")
    return out, grads


def gradients_agree(a, b, label, log=print, names=None):
    """Each pair of gradient tensors within RTOL / ATOL, or exit."""
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        ok = torch.allclose(x, y, rtol=RTOL, atol=ATOL)
        err = float(((x - y).abs() / (ATOL + RTOL * y.abs())).max()) if x.numel() else 0.0
        worst = max(worst, err)
        check(ok, f"{names[i] if names else i}: gradients agree within rtol {RTOL} / atol {ATOL} ({label}; "
                  f"worst |a - b| / (atol + rtol |b|) = {err:.3f})", log)
    return worst


def yawed(cam, c, s, offset):
    """``cam`` with its basis turned about +Y by the angle whose cosine and
    sine are ``c`` and ``s``, and its origin moved by the 3 components of
    ``offset``, as ``tests/test_gradients.py::TestCameraGradients`` does.
    Plain arithmetic on the camera's own vector type, so that the tests can
    turn the reference's camera with it too."""
    r, f, o, V = cam.right, cam.forward, cam.origin, type(cam.right)
    return dataclasses.replace(
        cam, right=V(r.x * c - f.x * s, r.y * c - f.y * s, r.z * c - f.z * s),
        forward=V(r.x * s + f.x * c, r.y * s + f.y * c, r.z * s + f.z * c),
        origin=V(o.x + offset[0], o.y + offset[1], o.z + offset[2]))


SCENE_PARAMS = ("base_color.x", "base_color.y", "base_color.z", "emission.x", "emission.y", "emission.z",
                "roughness", "light color.x", "light color.y", "light color.z", "camera origin.x",
                "camera origin.y", "camera origin.z", "camera yaw")
POSE = 10  # SCENE_PARAMS[POSE:] are the camera's, given per pixel


def scene_gradients(scene, meta, cam, vp, params):
    """Loss mean(r + 2 g + 0.5 b) and its gradients (``SCENE_PARAMS``) with
    respect to the material tables, the light colours, an offset of the
    camera origin and a yaw of the camera basis.  The camera's four are
    leaves of one entry per pixel, all zero: each pixel's gradient, whose
    sum is the gradient of the one camera parameter."""
    s, flat = material_leaves(scene)
    dev = cam.tan_half_fov.device
    light = [c.detach().requires_grad_() for c in scene.lights.color]
    pose = [torch.zeros(vp.width * vp.height, dtype=cam.tan_half_fov.dtype, device=dev, requires_grad=True)
            for _ in range(4)]
    s = s._replace(lights=s.lights._replace(color=Vec3(*light)))
    r, _ = trace_rows(s, meta, yawed(cam, torch.cos(pose[3]), torch.sin(pose[3]), pose[:3]), 0, None, vp, params)
    loss = torch.mean(r.x + 2.0 * r.y + 0.5 * r.z)
    leaves = flat + light + pose
    return loss.detach(), torch.autograd.grad(loss, leaves, materialize_grads=True)


def as_float64(x):
    """``x`` (a tensor, or named tuples and dataclasses of them: a scene, a
    camera) with every float32 tensor in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.dtype == torch.float32 else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(as_float64(v) for v in x))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: as_float64(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def check_against_cpu(dev, log=print, size=32, depth=4):
    """(a): the test scene's gradients on ``dev`` against the CPU port's,
    element by element (the tables per entry, the camera's per pixel; a
    camera parameter's gradient is the sum of its pixels', logged), within
    rtol 2e-4 / atol 1e-6: every parameter against the CPU's float64 run,
    and the tables and light colours against its float32 run.  The camera's
    pixels against the CPU's float32 run are logged beside that run's own
    miss of the float64 one: on the few pixels whose terms dominate a camera
    gradient, float32 resolves it to about 2e-4 relative, on the CPU as on
    the card (``PERF.md`` §6).  Returns the worst ratio of a
    difference to its bound against the float64 run."""
    vp, params = ViewportParams(size, size, seed=1), RenderParams(max_depth=depth, mis=True)
    out = []
    for where, dtype in (("cpu", "float32"), ("cpu", "float64"), (dev, "float32")):
        _sync(where)
        t0 = time.perf_counter()
        scene, meta, cam = test_scene(where)
        if dtype == "float64":
            scene, cam = as_float64(scene), as_float64(cam)
        out.append(scene_gradients(scene, meta, cam, vp, params))
        _sync(where)
        log(f"test scene {size}^2 depth {depth} on {where} in {dtype}: loss {float(out[-1][0]):.9f}, "
            f"{time.perf_counter() - t0:.2f} s")
    (l_cpu, g_cpu), (l_64, g_64), (l_dev, g_dev) = out
    check_finite(g_dev, f"test scene on {dev}", log)
    check(all(bool((g != 0).any()) for g in g_cpu[7:]), "the light colour and camera gradients are non-zero", log)
    check(abs(float(l_dev) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu)), "the loss on the device equals the CPU's", log)
    for name, a, b, c in zip(SCENE_PARAMS[POSE:], g_dev[POSE:], g_cpu[POSE:], g_64[POSE:]):
        a, b = a.cpu().double(), b.double()
        miss = lambda x: float(((x - c).abs() / (ATOL + RTOL * c.abs())).max())
        log(f"{name}: gradient {float(a.sum()):.6e} on {dev}, {float(b.sum()):.6e} on the cpu, {float(c.sum()):.6e} "
            f"in float64, the sum over {b.numel()} pixels; per pixel the largest |difference| {dev} - cpu is "
            f"{float((a - b).abs().max()):.3e}, the mean {float((a - b).abs().mean()):.3e}, against the largest "
            f"term {float(b.abs().max()):.3e}; worst |x - float64| / (atol + rtol |float64|): {dev} {miss(a):.3f}, "
            f"cpu {miss(b):.3f}; {dev} against cpu {float(((a - b).abs() / (ATOL + RTOL * b.abs())).max()):.3f}")
    gradients_agree(g_dev[:POSE], g_cpu[:POSE], f"test scene, {dev} against cpu", log, SCENE_PARAMS)
    return gradients_agree(g_dev, g_64, f"test scene, {dev} against cpu in float64", log, SCENE_PARAMS)


def check_finite_differences(scene, meta, cam, log=print, size=64, depth=4):
    """(b): central differences of one emission entry (the material whose
    emission moves the loss most) and of light 0's red colour, in which
    radiance is linear, so the difference is exact up to float32 rounding;
    step 1e-2 of the entry's magnitude (at least 1e-2).  Tolerances of
    tests/test_gradients.py: rtol 0.05, atol 1e-4 (emission) and 1e-3
    (light colour)."""
    vp, params = ViewportParams(size, size, seed=0), RenderParams(max_depth=depth, mis=True)
    dev = cam.tan_half_fov.device
    _, g = scene_gradients(scene, meta, cam, vp, params)
    check_finite(g[:POSE], f"{size}^2 on {dev}", log)
    check(all(bool(torch.isfinite(x).all()) for x in g[POSE:]), f"the camera gradients are finite ({size}^2)", log)
    m = int(torch.argmax(g[3].abs()))
    cases = (("emission.x", m, g[3][m], 1e-4), ("light color.x", 0, g[7][0], 1e-3))

    def loss_with(field, i, value):
        with torch.no_grad():
            if field.startswith("emission"):
                em = scene.materials.emission
                x = em.x.clone()
                x[i] = value
                s = scene._replace(materials=scene.materials._replace(emission=Vec3(x, em.y, em.z)))
            else:
                lc = scene.lights.color
                x = lc.x.clone()
                x[i] = value
                s = scene._replace(lights=scene.lights._replace(color=Vec3(x, lc.y, lc.z)))
            r, _ = trace_rows(s, meta, cam, 0, None, vp, params)
            return float(torch.mean(r.x + 2.0 * r.y + 0.5 * r.z))

    for field, i, ad, atol in cases:
        table = scene.materials.emission.x if field.startswith("emission") else scene.lights.color.x
        x0 = float(table[i])
        h = 1e-2 * max(abs(x0), 1.0)
        fd = (loss_with(field, i, x0 + h) - loss_with(field, i, x0 - h)) / (2 * h)
        log(f"finite differences [{size}^2 on {dev}] {field}[{i}] = {x0:.4f}, h {h:.4g}: autograd {float(ad):.6e}, "
            f"central difference {fd:.6e}")
        check(bool(torch.isfinite(ad)) and float(ad) != 0.0, f"{field}[{i}]: autograd gradient finite, non-zero", log)
        check(abs(float(ad) - fd) <= atol + FD_RTOL * abs(fd),
              f"{field}[{i}]: autograd within rtol {FD_RTOL} / atol {atol} of the central difference", log)


def descend(scene, meta, cam, log=print, size=128, depth=4, steps=4, move=0.05):
    """(d): ``steps`` plain gradient-descent steps of ``train_step`` on
    ``base_color``, from the true table halved, toward a target rendered
    with the true tables at the same pass.  The step size is fixed from the
    first gradient so that no entry moves by more than ``move``.  Returns
    the losses."""
    vp, params = ViewportParams(size, size, seed=0), RenderParams(max_depth=depth, mis=True)
    with torch.no_grad():
        r, _ = trace_rows(scene, meta, cam, 0, None, vp, params)
    target = torch.stack([c.reshape(size, size) for c in r], -1)
    m = scene.materials
    bc = Vec3(*(c * 0.5 for c in m.base_color))
    losses, lr = [], None
    for _ in range(steps):
        loss, (g_bc, g_em, g_ro) = train_step(scene._replace(materials=m._replace(base_color=bc)), meta, cam,
                                              target, 0, vp, params)
        check_finite((*g_bc, *g_em, g_ro), "train_step", log)
        losses.append(float(loss))
        if lr is None:
            lr = move / max(float(g.abs().max()) for g in g_bc)
        bc = Vec3(*(c - lr * g for c, g in zip(bc, g_bc)))
    log(f"train_step descent [{size}^2 depth {depth}, base_color from half, step {lr:.4g}]: losses "
        f"{', '.join(f'{x:.6e}' for x in losses)}")
    check(losses[-1] < losses[0], "gradient descent with train_step lowered the loss", log)
    return losses


def _bits(x):
    return x.contiguous().view(torch.int32)


def wave_against_wave2(cs, o, d, reach, dev, log=print, label="window"):
    """The ``wave`` engine against wave2 on the (n, 3) rays ``o``, ``d``:
    tri ids equal but on exact ties (both t bit-equal), t bit-equal where
    the ids agree, occlusion of rays ``reach`` long equal; each engine's
    closest-hit and any-hit timed once (host clock around a synchronised
    call).  Returns the counts and times."""
    ro, rd = vec(o, dev), vec(d, dev)

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3, out

    ms = {}
    ms["wave closest"], (t, tri, _, _, ovf) = timed(lambda: wv.wave_closest_hit(cs, ro, rd, BIGF))
    ms["wave any-hit"], (occ, occ_ovf) = timed(lambda: wv.wave_any_hit(cs, ro, rd, reach))
    ms["wave2 closest"], (t2, tri2) = timed(lambda: w2.wave2_closest_hit(cs, ro, rd, BIGF)[:2])
    ms["wave2 any-hit"], occ2 = timed(lambda: w2.wave2_any_hit(cs, ro, rd, reach)[0])
    differ = tri != tri2
    ties = differ & (_bits(t) == _bits(t2)) & (tri >= 0) & (tri2 >= 0)
    agree = ~differ & (tri >= 0)
    counts = {"rays": o.shape[0], "hits": int((tri >= 0).sum()), "tri_differ": int(differ.sum()),
              "exact_ties": int(ties.sum()), "occluded": int(occ.sum()), "overflow": int(ovf.sum() + occ_ovf.sum()),
              "ms": {k: round(v, 3) for k, v in ms.items()}}
    log(f"wave vs wave2 [{label}]: {counts}")
    check(torch.equal(differ, ties), f"wave and wave2 tri ids equal but on exact ties ({label})", log)
    check(torch.equal(_bits(t)[agree], _bits(t2)[agree]), f"wave and wave2 t bit-equal where the ids agree ({label})",
          log)
    check(torch.equal(occ, occ2), f"wave and wave2 occlusion equal ({label})", log)
    check(counts["overflow"] == 0, f"wave: no overflow ({label})", log)
    return counts


def main():
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to rehearse on the CPU")
    check_against_cpu(dev, size=8 if dev == "cpu" else 32)
    scene, meta, cam = test_scene(dev)
    check_finite_differences(scene, meta, cam, size=8 if dev == "cpu" else 64)
    descend(scene, meta, cam, size=8 if dev == "cpu" else 64)


if __name__ == "__main__":
    main()
