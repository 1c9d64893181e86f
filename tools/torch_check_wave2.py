"""Correctness check of the wave2 engine against the dense ``cluster``
oracle (counterpart of ``tools/check_wave2.py``).

    python tools/torch_check_wave2.py [cuda|cpu] [n_tris] [n_rays]

Defaults: the card, 20,000 triangles (``torch_traversal_bench.make_mesh``),
8,192 rays of each set (coherent, incoherent; seed 7).  Closest-hit: wave2's
tri ids equal the oracle's on every ray the oracle does not flag as overflow
(it stops at kmax = 32 clusters and says so, and the reference excludes
those rays too); any-hit (rays 4.0 long): occlusion equal on every ray the
oracle does not flag.  Prints each agreement, t agreement within 1e-3 and
the first disagreeing rays; exits 1 on any disagreement.  ``chip_smoke.py``
phase 24 calls ``check``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_check_traverse import coherent_rays, incoherent_rays, vec  # noqa: E402
from torch_traversal_bench import make_mesh  # noqa: E402

from raytracer_tpu_torch.ops.cluster_traverse import cluster_any_hit, cluster_closest_hit  # noqa: E402
from raytracer_tpu_torch.ops.wave2_traverse import wave2_any_hit, wave2_closest_hit  # noqa: E402
from raytracer_tpu_torch.scene.clusters import build_clusters  # noqa: E402


def check(dev, n_tris=20_000, n_rays=8192, log=print) -> bool:
    """The check (module docstring).  Returns whether wave2 agreed
    everywhere; logs every figure."""
    rng = np.random.default_rng(7)
    v0, e1, e2 = make_mesh(n_tris, rng)
    cs = build_clusters(v0, e1, e2, device=dev)
    log(f"tris={v0.shape[0]} clusters={cs.num_clusters} supers={cs.num_supers}")
    ok = True
    for label, mk in (("coherent", lambda n: coherent_rays(n)), ("incoherent", lambda n: incoherent_rays(n, rng))):
        o_np, d_np = mk(n_rays)
        o, d = vec(o_np, dev), vec(d_np, dev)
        ct, ctri, _, _, covf = cluster_closest_hit(cs, o, d, 3.0e38)
        wt, wtri, _, _, wovf = wave2_closest_hit(cs, o, d, 3.0e38)
        cmp = (wtri == ctri) | covf
        agree = float(cmp.float().mean())
        t_close = float((torch.abs(torch.where(ctri >= 0, wt - ct, 0.0)) < 1e-3).float().mean())
        log(f"[{label}] closest: tri-agree={agree:.5f} t-agree={t_close:.5f} hits={float((ctri >= 0).float().mean()):.3f} "
            f"oracle ovf={float(covf.float().mean()):.4f} wave2 ovf={float(wovf.float().mean()):.4f}")
        if agree < 1.0:
            for i in torch.nonzero(~cmp).flatten()[:5].tolist():
                log(f"  ray {i}: oracle tri={int(ctri[i])} t={float(ct[i]):.5f} wave2 tri={int(wtri[i])} "
                    f"t={float(wt[i]):.5f}")
            ok = False
        cocc, cao = cluster_any_hit(cs, o, d, 4.0)
        wocc, _ = wave2_any_hit(cs, o, d, 4.0)
        aagree = float(((wocc == cocc) | cao).float().mean())
        log(f"[{label}] any-hit: agree={aagree:.5f} occl={float(cocc.float().mean()):.3f}")
        ok = ok and aagree == 1.0
    log("PASS" if ok else "FAIL")
    return ok


def main():
    args = sys.argv[1:]
    on_card = (args.pop(0) if args and args[0] in ("cuda", "cpu") else "cuda") == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: give 'cpu' to run on the CPU")
    n_tris = int(args[0]) if len(args) > 0 else 20_000
    n_rays = int(args[1]) if len(args) > 1 else 8192
    sys.exit(0 if check("cuda" if on_card else "cpu", n_tris, n_rays) else 1)


if __name__ == "__main__":
    main()
