"""Correctness and timing of the block-candidate engines
(``pallas_cluster_closest_hit`` / ``pallas_cluster_any_hit``, the
``phase2_grid`` kernel on the card) against the dense ``cluster`` path
(counterpart of ``tools/check_pallas.py``).

    python tools/torch_check_pallas.py [cuda|cpu]

On the reference's two random triangle soups and ray sets (seed 7): 500
triangles with 4,096 rays and 20,000 with 65,536.  Closest-hit, the
reference's bars (``check_pallas.py:64-67``): tri ids agree on more than
99.9% of the rays that neither flags as overflow, and where they agree on a
hit t within rtol 2e-4 / atol 1e-4 and u within rtol 1e-2 / atol 2e-3; and
on every ray, flagged or not, no hit nearer than the oracle's (its t at
least the oracle's, within the same t tolerance).  Any-hit (rays 5.0 long): no false occlusion (every ray the engine occludes,
the oracle occludes), and the agreement printed beside the reference's bar
of 99.9% (``check_pallas.py:73``), which the reference's own engine misses
on the 20k soup: a block of 1,024 incoherent rays keeps kb = 48 candidate
clusters, the any-hit query carries no overflow flag, and the truncated
rays miss occluders (0.817 on the first 4,096 rays, the JAX package on the
CPU with its kernel in interpret mode; the port's answers are the
reference's there, bit for bit).  Each engine's ms a call
(``torch_traversal_bench._time``: CUDA events on the card).  Exits 1 below
a bar.  The reference's 200k-triangle timing at 2^20 rays is
``tools/torch_traversal_bench.py``'s ``cluster`` and ``pallas`` rows.
``chip_smoke.py`` phase 24 calls ``check``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_check_traverse import vec  # noqa: E402
from torch_traversal_bench import _time  # noqa: E402

from raytracer_tpu_torch.ops.cluster_traverse import cluster_any_hit, cluster_closest_hit  # noqa: E402
from raytracer_tpu_torch.ops.pallas_traverse import pallas_cluster_any_hit, pallas_cluster_closest_hit  # noqa: E402
from raytracer_tpu_torch.scene.clusters import build_clusters  # noqa: E402

CASES = ((500, 4096), (20_000, 65_536))


def random_mesh(t, rng, spread=2.0, size=0.3):
    c = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    a = c + rng.uniform(-size, size, (t, 3)).astype(np.float32)
    b = c + rng.uniform(-size, size, (t, 3)).astype(np.float32)
    return c, a - c, b - c


def random_rays(n, rng, spread=4.0):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def check(dev, log=print, cases=CASES) -> bool:
    """The check (module docstring).  Returns whether every bar held."""
    dev = torch.device(dev)
    rng = np.random.default_rng(7)
    ok = True
    for t, n in cases:
        v0, e1, e2 = random_mesh(t, rng)
        cs = build_clusters(v0, e1, e2, device=dev)
        o_np, d_np = random_rays(n, rng)
        o, d = vec(o_np, dev), vec(d_np, dev)
        (rt, rtri, ru, _, rovf), ref_ms = _time(lambda: cluster_closest_hit(cs, o, d, 3.0e38), dev)
        (pt_, ptri, pu, _, povf), pal_ms = _time(lambda: pallas_cluster_closest_hit(cs, o, d, 3.0e38), dev)
        rt, rtri, ru, rovf, pt_, ptri, pu, povf = (x.cpu().numpy() for x in (rt, rtri, ru, rovf, pt_, ptri, pu, povf))
        both_valid = ~rovf & ~povf
        agree = rtri == ptri
        frac = float((agree | ~both_valid).mean())
        m = both_valid & agree & (rtri >= 0)
        nearer = int((pt_ < rt - (1e-4 + 2e-4 * np.abs(rt))).sum())
        t_ok = bool(np.allclose(pt_[m], rt[m], rtol=2e-4, atol=1e-4))
        u_ok = bool(np.allclose(pu[m], ru[m], rtol=1e-2, atol=2e-3))
        log(f"T={t} N={n}: tri agree {frac:.6f}  ref hits {(rtri >= 0).mean():.3f} pal hits {(ptri >= 0).mean():.3f} "
            f"ovf ref {rovf.mean():.4f} pal {povf.mean():.4f}; t {'within' if t_ok else 'NOT within'} rtol 2e-4 / "
            f"atol 1e-4, u {'within' if u_ok else 'NOT within'} rtol 1e-2 / atol 2e-3 on {int(m.sum())} hits; "
            f"hits nearer than the oracle's {nearer}; "
            f"ms cluster {ref_ms:.3f}, pallas {pal_ms:.3f}")
        ra, ref_any_ms = _time(lambda: cluster_any_hit(cs, o, d, 5.0)[0], dev)
        pa, pal_any_ms = _time(lambda: pallas_cluster_any_hit(cs, o, d, 5.0), dev)
        aa = float((ra == pa).float().mean())
        false_occ = int((pa & ~ra).sum())
        log(f"  any-hit agree {aa:.6f} (the reference's bar 0.999), false occlusions {false_occ}, missed occluders "
            f"{int((ra & ~pa).sum())}; ms cluster {ref_any_ms:.3f}, pallas {pal_any_ms:.3f}")
        ok = ok and frac > 0.999 and t_ok and u_ok and nearer == 0 and false_occ == 0
    log("PASS" if ok else "FAIL")
    return ok


def main():
    on_card = (sys.argv[1] if len(sys.argv) > 1 else "cuda") == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to run the plain versions on the CPU")
    sys.exit(0 if check("cuda" if on_card else "cpu") else 1)


if __name__ == "__main__":
    main()
