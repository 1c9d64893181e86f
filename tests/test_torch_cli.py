"""The port's command-line entry point (``raytracer_tpu_torch/cli.py``,
``python -m raytracer_tpu_torch``) against the JAX package's.

Each renderer name renders the Cornell box on the CPU (``--cpu``) at 16^2,
one pass.  Held: the stats line has the reference CLI's keys and, for the
four renderers, its pass and ray counts exactly; "Debug" (listed in
``--help``) and an unknown name exit 2, as in the reference; without a card
and without ``--cpu`` the CLI refuses to render (exit 1); PNG and BMP
outputs decode, with the port's readers and with PIL, to the pixels of
``Viewport.image()``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_one_thread  # noqa: F401  (one torch thread for this process)
from raytracer_tpu import cli as ref_cli
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.io.bmp import read_bmp
from raytracer_tpu_torch.io.exr import read_exr
from raytracer_tpu_torch.io.png import read_png, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_check_integrators as tci  # noqa: E402

NAMES = {"Path Tracer": "pt", "pathtracer": "pt", "pt": "pt", "Path Tracer MIS": "mis", "pt-mis": "mis",
         "mis": "mis", "Light Tracer": "lt", "lighttracer": "lt", "lt": "lt", "VCM": "vcm", "vcm": "vcm"}


def _argv(name, out, size=16, depth=6):
    return ["--cpu", "--renderer", name, "--width", str(size), "--height", str(size), "--passes", "1",
            "--max-depth", str(depth), "--output", out]


def _ref_stats(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_cli.main(argv + ["--stats-json"]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_stats(tmp_path_factory):
    """The reference CLI's stats line for each of the four renderers."""
    d = tmp_path_factory.mktemp("ref")
    return {kind: _ref_stats(_argv(name, str(d / f"{kind}.png")))
            for kind, name in (("pt", "pt"), ("mis", "mis"), ("lt", "lt"), ("vcm", "vcm"))}


@pytest.mark.parametrize("name", list(NAMES))
def test_each_renderer_name_renders_like_the_reference(ref_stats, tmp_path, name):
    out = str(tmp_path / "out.png")
    rc, stats, vp, img = tci.run_cli(_argv(name, out), print)
    assert rc == 0
    want = ref_stats[NAMES[name]]
    assert list(stats) == list(want)
    for key in ("passes_finished", "total_rays", "total_shadow_rays", "total_traversal_overflow",
                "total_box_tests", "total_tri_tests"):
        assert stats[key] == want[key], (key, stats[key], want[key])
    assert stats["output"] == out and stats["seconds"] > 0
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8 and img.max() > 0
    assert np.array_equal(read_png(out), img)


@pytest.mark.parametrize("name", ["Debug", "debug", "bidirectional"])
def test_debug_and_unknown_renderers_exit_2(tmp_path, name, capsys):
    out = str(tmp_path / "x.png")
    assert cli.main(_argv(name, out)) == 2
    assert "unknown renderer" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_outputs_decode_to_the_viewport_image(tmp_path):
    from PIL import Image

    images = {}
    for ext in (".png", ".bmp"):
        out = str(tmp_path / f"img{ext}")
        rc, _, _, img = tci.run_cli(_argv("mis", out, size=24) + ["--hdr-output", str(tmp_path / "img.exr")], print)
        assert rc == 0
        mine = read_png(out) if ext == ".png" else read_bmp(out)
        assert np.array_equal(mine, img) and np.array_equal(np.asarray(Image.open(out).convert("RGB")), img)
        images[ext] = img
    assert np.array_equal(images[".png"], images[".bmp"])
    assert read_exr(str(tmp_path / "img.exr")).shape == (24, 24, 3)
    assert cli.main(_argv("mis", str(tmp_path / "img.jpg"))) == 2  # only PNG and BMP are written


def test_png_writer_round_trips_odd_shapes(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((1, 1, 3), (7, 13, 3), (64, 3, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(str(tmp_path / "t.png"), img)
        assert np.array_equal(read_png(str(tmp_path / "t.png")), img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "t.png"), np.zeros((4, 4), np.uint8))


def test_no_card_and_no_cpu_flag_refuses(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv("mis", str(tmp_path / "x.png"))[1:]  # without --cpu
    assert cli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.png")


def test_python_dash_m_lists_the_reference_renderers():
    res = subprocess.run([sys.executable, "-m", "raytracer_tpu_torch", "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0
    assert "Path Tracer | Path Tracer MIS | Light Tracer | Debug" in " ".join(res.stdout.split())
    flags = lambda p: [(a.option_strings, a.dest, a.default, a.type, a.nargs) for a in p._actions]
    port = flags(cli.build_arg_parser())
    # the same flags and defaults, and the port's own --trace (its spans in a Chrome trace) last
    assert port[-1] == (["--trace"], "trace", None, None, None)
    assert port[:-1] == flags(ref_cli.build_arg_parser())
