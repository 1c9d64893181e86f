"""``raytracer_tpu_torch/entry.py``, the port's counterpart of
``__graft_entry__.py``, on the CPU.

- ``entry(device="cpu")``'s step renders the film of the reference's
  ``entry()`` step, jitted on JAX's CPU: the Cornell box at 64^2, depth 6,
  MIS, pass 0, at the port's render tolerance (>= 99.5% of pixels within
  atol 1e-4 / rtol 1e-3, the means within 0.1%: ``tests/test_torch_render.py``).
- ``dryrun_multichip(2, device="cpu")`` over two gloo CPU ranks (spawned
  with a timeout): the loss equal to the one the JAX package's
  ``dryrun_multichip(2)`` prints on the 8-device CPU mesh of
  ``tests/conftest.py`` within the gradient tests' rtol 2e-4 / atol 1e-6
  (and the 5e-7 of its six printed decimals); the forward film the one
  process ``render_pass`` film bit for bit, the VCM film finite.
- ``dryrun_multichip(1)`` likewise, and ``python -m raytracer_tpu_torch.entry
  --cpu`` prints ``entry() run ok``.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu_torch import entry as E
from raytracer_tpu_torch.render.film import make_film
from raytracer_tpu_torch.render.renderer import render_pass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import __graft_entry__ as ref_entry  # noqa: E402


def test_entry_renders_the_reference_film():
    fn, args = E.entry(device="cpu")
    film, counters = fn(*args)
    ref_fn, ref_args = ref_entry.entry()
    ref_film, ref_counters = jax.jit(ref_fn)(*ref_args)
    a, b = np.asarray(ref_film.sum), film.sum.numpy()
    assert b.shape == a.shape == (64, 64, 3) and np.isfinite(b).all()
    assert abs(float(counters.num_rays) - float(ref_counters.num_rays)) <= 1e-3 * float(ref_counters.num_rays)
    close = np.isclose(b, a, atol=1e-4, rtol=1e-3).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(b.mean() - a.mean()) <= 1e-3 * abs(a.mean())


def _one_process(world):
    scene, meta, cam = E.flagship_scene("cpu")
    vp, params = E.dryrun_params(world)
    return render_pass(scene, meta, cam, make_film(vp.width, vp.height, "cpu"), 0, None, vp, params)[0].sum.numpy()


@pytest.mark.parametrize("world", [1, 2])
def test_dryrun_multichip_over_gloo_cpu_ranks(world, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = E.dryrun_multichip(world, device="cpu", work_dir=str(tmp_path))
    assert got["backend"] == "gloo" and np.isfinite(got["loss"]) and np.isfinite(got["vcm"]).all()
    assert got["film"].shape == (8 * world, 16, 3) and got["vcm"].shape == got["film"].shape
    assert np.array_equal(got["film"], _one_process(world))
    assert f"dryrun_multichip({world}) [gloo]: loss=" in capsys.readouterr().out
    if world == 2:
        ref_entry.dryrun_multichip(2)
        printed = float(re.search(r"loss=([0-9.]+)", capsys.readouterr().out).group(1))
        assert abs(got["loss"] - printed) <= 1e-6 + 2e-4 * abs(printed) + 5e-7, (got["loss"], printed)


def test_entry_module_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "raytracer_tpu_torch.entry", "--cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("entry() run ok"), res.stderr[-2000:]
