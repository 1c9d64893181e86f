"""The port's counterparts of the reference's traversal, oracle, micro-bench,
render-probe and scaling tools, run on the CPU at small sizes.

- ``tools/torch_traversal_bench.py``: ``make_mesh`` and both ray sets
  bit-equal to ``tools/traversal_bench.py``'s at the same seed; every
  engine, closest-hit and any-hit, at 2,000 triangles and 1,024 rays, the
  exact engines (``cluster``, ``bvh``, ``wave``) agreeing with wave2 on
  every ray neither flags.
- ``tools/torch_check_wave2.py`` and ``tools/torch_check_pallas.py`` pass at
  2,000 triangles and 1,024 rays.
- ``tools/torch_microbench.py --cpu --n 4096``: eight JSON lines, the
  reference's names and units.
- ``tools/torch_probe_render.py``: one pass of the 2k mesh.
- ``tools/torch_scaling_bench.py`` at 1 and 2 gloo CPU ranks: an
  ``overhead_n`` line each and the summary (the ranks are spawned with a
  timeout; every band bit-equal to the one-process render's rows).
"""

import json
import os
import sys

import numpy as np

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import bench_mesh  # noqa: E402
import torch_check_pallas  # noqa: E402
import torch_check_traverse  # noqa: E402
import torch_check_wave2  # noqa: E402
import torch_microbench  # noqa: E402
import torch_probe_render  # noqa: E402
import torch_scaling_bench  # noqa: E402
import torch_traversal_bench as ttb  # noqa: E402
import traversal_bench as ref_tb  # noqa: E402

N_TRIS, N_RAYS = 2000, 1024


def test_mesh_and_rays_are_the_reference_bench_s():
    ref_rng, rng = np.random.default_rng(7), np.random.default_rng(7)
    for a, b in zip(ref_tb.make_mesh(N_TRIS, ref_rng), ttb.make_mesh(N_TRIS, rng)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for ref_mk, mk in ((ref_tb.coherent_rays, lambda n, g: torch_check_traverse.coherent_rays(n)),
                       (ref_tb.incoherent_rays, torch_check_traverse.incoherent_rays)):
        ref_o, ref_d = ref_mk(N_RAYS, ref_rng)
        o, d = mk(N_RAYS, rng)
        np.testing.assert_array_equal(np.stack([np.asarray(c) for c in ref_o], 1), o)
        np.testing.assert_array_equal(np.stack([np.asarray(c) for c in ref_d], 1), d)


def test_traversal_bench_runs_every_engine():
    bench, results = ttb.run(N_TRIS, N_RAYS, dev="cpu", log=lambda *_: None)
    assert bench.n_tris == ref_tb.make_mesh(N_TRIS, np.random.default_rng(7))[0].shape[0]
    for label in ("coherent", "incoherent"):
        assert set(results[label]) == set(ttb.ENGINES)
        for engine, fig in results[label].items():
            for query in ("closest", "any"):
                f = fig[query]
                assert np.isfinite(f["ms"]) and f["ms"] > 0
                if engine in ("cluster", "bvh", "wave"):
                    assert f["compared"] == N_RAYS and f["agree_vs_wave2"] == 1.0, (label, engine, query)
    assert results["incoherent"]["wave2"]["closest"]["hit_share"] > 0.2


def test_wave2_oracle_passes():
    lines = []
    assert torch_check_wave2.check("cpu", N_TRIS, N_RAYS, log=lines.append)
    assert lines[-1] == "PASS" and sum("tri-agree=1.00000" in ln for ln in lines) == 2


def test_pallas_oracle_passes():
    lines = []
    assert torch_check_pallas.check("cpu", log=lines.append, cases=((500, N_RAYS), (N_TRIS, N_RAYS)))
    assert lines[-1] == "PASS" and sum("any-hit agree" in ln for ln in lines) == 2


def test_microbench_prints_the_reference_benches():
    lines = []
    torch_microbench.main(["--cpu", "--n", "4096", "--iters", "1"], out=lines.append)
    rows = [json.loads(ln) for ln in lines]
    assert [r["bench"] for r in rows] == list(torch_microbench.BENCHES)
    ref_src = open(os.path.join(ROOT, "tools", "microbench.py")).read()
    for r in rows:
        assert f'"{r["bench"]}"' in ref_src and f'"{r["unit"]}"' in ref_src
        assert r["time_us"] > 0 and r["device"] == "cpu"


def test_probe_render_one_pass(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_mesh, "BENCH_DIR", str(tmp_path))
    from raytracer_tpu_torch.io.scene_loader import load_scene

    scene, meta, cam = load_scene(bench_mesh.ensure_scene(N_TRIS), device="cpu")
    got = torch_probe_render.probe(scene, meta, cam, "cpu", n_passes=1, size=16, log=lambda *_: None)
    assert got["rays_a_pass"] >= 256 and got["ms_a_pass"] > 0


def test_scaling_bench_at_one_and_two_cpu_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    lines = []
    per, summary = torch_scaling_bench.run("cpu", (1, 2), size=16, passes=2, log=lambda *_: None, out=lines.append)
    assert len(lines) == 3
    for n in (1, 2):
        line = json.loads(lines[n - 1])
        assert line == per[n] and line["metric"] == f"scaling_rays_per_sec_{n}dev" and line["backend"] == "gloo"
        assert line["overhead_n"] > 0 and "efficiency_n" not in line
    assert per[1]["overhead_n"] == 1.0
    assert summary["metric"] == "scaling_overhead" and summary["value"] == per[2]["overhead_n"]
