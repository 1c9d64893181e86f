"""The port's utils layer (``utils/``) and checkpoint / resume
(``render/checkpoint.py``, ``Viewport.save_checkpoint`` /
``load_checkpoint``).

- the profiler's spans (``scoped_timer``), the report, a span recorded
  under a ``torch.profiler`` capture without a range of its own, a device
  profile written as a Chrome trace with the spans, and the logger's levels
  (the port of ``tests/test_utils.py``; ``tests/test_torch_trace.py`` holds
  the rest of the spans' tests);
- a checkpoint resumes bit-exactly in the port, with the reference's two
  refusals (another seed, another film shape);
- the file is the reference's format: a checkpoint of the JAX package
  resumes in the port and one of the port resumes in the JAX package, each
  equal to the other package's straight 4-pass render within the render
  tolerance of ``tests/test_torch_render.py`` (rtol 1e-3 / atol 1e-4) on
  the Cornell box at 16^2, depth 3, with equal pass counters.
"""

import json
import logging
import sys

import jax
import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu.integrators.path_tracer import RenderParams as RefRenderParams
from raytracer_tpu.math.transform import RigidTransform as RefRigidTransform
from raytracer_tpu.render.renderer import Viewport as RefViewport, ViewportParams as RefViewportParams
from raytracer_tpu.scene.camera import make_camera as ref_make_camera
from raytracer_tpu.scene.presets import cornell_box as ref_cornell_box, cornell_camera_kw
from raytracer_tpu_torch.integrators.path_tracer import RenderParams
from raytracer_tpu_torch.render.renderer import Viewport, ViewportParams
from raytracer_tpu_torch.scene.convert import scene_from_numpy

SIZE, DEPTH = 16, 3
RTOL, ATOL = 1e-3, 1e-4


class TestProfiler:
    def test_scoped_timer_collects(self):
        """``scoped_timer`` is the reference's name for a span: it records
        only while tracing is on, and ``collect`` aggregates the buffer."""
        from raytracer_tpu_torch.utils import collect, enable, reset, scoped_timer

        reset()
        with scoped_timer("unit.region"):
            pass
        assert collect() == {}
        with enable():
            for _ in range(3):
                with scoped_timer("unit.region"):
                    pass
        stats = collect()
        assert stats["unit.region"]["count"] == 3
        assert 0.0 <= stats["unit.region"]["self"] <= stats["unit.region"]["total"]
        assert stats["unit.region"]["min"] <= stats["unit.region"]["avg"] <= stats["unit.region"]["max"]
        reset()
        assert collect() == {}

    def test_profiled_decorator_and_report(self):
        """The decorator is gone (nothing called it); ``report`` prints the
        spans by self time, the syncs by site and the counters."""
        import raytracer_tpu_torch.utils.profiler as prof
        from raytracer_tpu_torch.utils import count, enable, host_sync, report, reset, span

        reset()
        assert report() == "(no spans recorded)"
        assert not hasattr(prof, "profiled")
        with enable():
            with span("unit.fn"):
                with host_sync("unit.read"):
                    float(torch.ones(2).sum())
            count("unit.items", 3)
        text = report()
        assert "unit.fn" in text and "unit.read" in text and "unit.items" in text
        reset()

    def test_device_trace_is_a_profiler_range(self):
        """``device_trace`` is gone: a span records while a ``torch.profiler``
        capture runs, and opens no ``record_function`` range, so the trace's
        device timeline holds no event of the program's."""
        from torch.profiler import ProfilerActivity, profile

        import raytracer_tpu_torch.utils.profiler as prof
        from raytracer_tpu_torch.utils import collect, reset, span

        reset()
        assert not hasattr(prof, "device_trace")
        with profile(activities=[ProfilerActivity.CPU]) as p:
            with span("unit.traced"):
                torch.ones(8).sum()
        assert "unit.traced" not in {e.key for e in p.key_averages()}
        assert collect()["unit.traced"]["count"] == 1
        reset()

    def test_device_profile_writes_a_chrome_trace(self, tmp_path):
        from raytracer_tpu_torch.utils.profiler import reset, span, start_device_profile, stop_device_profile

        reset()
        start_device_profile(str(tmp_path / "trace"))
        with pytest.raises(RuntimeError, match="already running"):
            start_device_profile(str(tmp_path / "other"))
        with span("unit.in_file"):
            torch.ones(8).sum()
        path, ops = stop_device_profile()
        assert path.startswith(str(tmp_path / "trace")) and ops == []  # no device on the CPU
        events = json.load(open(path))["traceEvents"]
        assert any(e.get("name") == "unit.in_file" and e.get("cat") == "program_span" for e in events)
        assert any(e.get("cat") == "cpu_op" for e in events)
        reset()

    def test_logger_levels(self, capsys):
        from raytracer_tpu_torch.utils import log_debug, log_error, log_info, log_warning, set_level
        from raytracer_tpu_torch.utils.logger import _configure

        handler = _configure().handlers[0]
        handler.setStream(sys.stderr)  # capsys's stream, whichever test configured the logger first
        set_level("INFO")
        log_debug("dbg %d", 0)
        log_info("info %d", 1)
        log_warning("warn")
        log_error("err")
        err = capsys.readouterr().err
        assert "info 1" in err and "warn" in err and "err" in err and "dbg" not in err
        assert "[rank" not in err  # no process group: no rank prefix
        set_level("DEBUG")
        log_debug("dbg %d", 2)
        assert "dbg 2" in capsys.readouterr().err
        set_level("INFO")
        assert _configure().level == logging.INFO and not _configure().propagate


def _scenes(seed=0):
    scene, meta = ref_cornell_box()
    t_kw, c_kw = cornell_camera_kw()
    cam = ref_make_camera(RefRigidTransform(**t_kw), **c_kw)
    carry = lambda x: scene_from_numpy(jax.tree_util.tree_map(np.asarray, x), "cpu")
    return (scene, meta, cam), (carry(scene), meta, carry(cam))


def _port_viewport(seed=0, size=SIZE):
    _, (scene, meta, cam) = _scenes()
    return Viewport(scene, meta, cam, ViewportParams(size, size, seed=seed), RenderParams(max_depth=DEPTH, mis=True),
                    device="cpu")


class TestCheckpoint:
    def test_resume_is_bit_exact(self, tmp_path):
        path = str(tmp_path / "ckpt.npz")
        straight = _port_viewport().render(4)
        _port_viewport().render(2).save_checkpoint(path)
        assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt.npz"]  # the temporary file was renamed
        resumed = _port_viewport().load_checkpoint(path).render(2)
        assert torch.equal(straight.film.sum, resumed.film.sum)
        assert torch.equal(straight.film.secondary_sum, resumed.film.secondary_sum)
        assert resumed.film.num_passes == 4 and resumed.film.num_secondary_passes == 2
        assert resumed.total_rays == straight.total_rays

    def test_file_is_the_reference_format(self, tmp_path):
        path = str(tmp_path / "ckpt")
        _port_viewport().render(1).save_checkpoint(path)
        with np.load(path) as z:  # no .npz appended to the name asked for
            assert sorted(z.files) == ["meta", "num_passes", "num_secondary_passes", "secondary_sum", "sum"]
            assert z["num_passes"].dtype == np.int32 and z["num_passes"].shape == ()
            meta = json.loads(str(z["meta"]))
        assert meta["version"] == 1 and meta["seed"] == 0 and meta["total_rays"] > 0

    def test_mismatched_seed_rejected(self, tmp_path):
        path = str(tmp_path / "ckpt.npz")
        _port_viewport(seed=0).render(1).save_checkpoint(path)
        with pytest.raises(ValueError, match="seed"):
            _port_viewport(seed=1).load_checkpoint(path)

    def test_mismatched_shape_rejected(self, tmp_path):
        path = str(tmp_path / "ckpt.npz")
        _port_viewport().render(1).save_checkpoint(path)
        with pytest.raises(ValueError, match="film"):
            _port_viewport(size=8).load_checkpoint(path)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's 2-pass checkpoint and its straight 4-pass film (one
    compile: 2 + 2 passes of one scan are 4 passes bit for bit)."""
    (scene, meta, cam), _ = _scenes()
    path = str(tmp_path_factory.mktemp("jax") / "ckpt.npz")
    vp = RefViewport(scene, meta, cam, RefViewportParams(width=SIZE, height=SIZE, seed=0),
                     RefRenderParams(max_depth=DEPTH, mis=True))
    vp.render(2).save_checkpoint(path)
    straight = vp.render(2)
    return path, np.asarray(straight.film.sum), straight.total_rays, vp


def test_a_jax_checkpoint_resumes_in_the_port(jax_runs):
    path, jax_sum, jax_rays, _ = jax_runs
    resumed = _port_viewport().load_checkpoint(path)
    assert resumed.film.num_passes == 2 and resumed.total_rays > 0
    resumed.render(2)
    assert resumed.film.num_passes == 4
    np.testing.assert_allclose(resumed.film.sum.numpy(), jax_sum, rtol=RTOL, atol=ATOL)
    assert resumed.total_rays == jax_rays


def test_a_port_checkpoint_resumes_in_the_jax_package(jax_runs, tmp_path):
    _, _, _, ref_vp = jax_runs
    path = str(tmp_path / "port.npz")
    port = _port_viewport().render(2).save_checkpoint(path)
    straight = port.render(2)
    (scene, meta, cam), _ = _scenes()
    resumed = RefViewport(scene, meta, cam, ref_vp.vp_params, ref_vp.render_params)
    resumed.load_checkpoint(path).render(2)
    assert int(resumed.film.num_passes) == 4
    np.testing.assert_allclose(np.asarray(resumed.film.sum), straight.film.sum.numpy(), rtol=RTOL, atol=ATOL)
    assert resumed.total_rays == straight.total_rays
