"""The port's kernel launch plumbing, as far as a host without a card can
show it: the C launch functions are resolved and typed once, ``launch``
passes, checks and counts each call on a fake library, CPU tensors take the
plain versions, other devices raise."""

import ctypes
import os
import sys
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.ops import cuda_build
from raytracer_tpu_torch.ops import wave2_traverse as w2
from raytracer_tpu_torch.ops.launch_probe import add_one, add_one_reference, empty_launch
from raytracer_tpu_torch.utils import profiler

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import torch_tune_wave2 as tune  # noqa: E402

CUDA = torch.device("cuda")  # no index: the current device


def test_kernel_function_is_resolved_and_typed_once(monkeypatch):
    class Fn:
        argtypes = restype = None

    class Lib:
        some_launch = Fn()

    loads = []
    monkeypatch.setattr(cuda_build, "load_kernel_library", lambda name: loads.append(name) or Lib)
    monkeypatch.setattr(cuda_build, "_FUNCS", {})
    types = [ctypes.c_void_p, ctypes.c_int]
    first = cuda_build.kernel_function("some", "some_launch", types)
    second = cuda_build.kernel_function("some", "some_launch", types)
    assert first is second is Lib.some_launch and loads == ["some"]
    assert first.argtypes == types and first.restype is ctypes.c_int


class FakeLaunch:
    """A C launch function of a fake library: records its arguments and
    returns ``rc``."""

    argtypes = restype = None

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake(monkeypatch):
    """``launch`` against a fake library ``some`` (``some_launch`` succeeds,
    ``refused_launch`` returns cudaError 700) on a fake current stream."""
    lib = SimpleNamespace(some_launch=FakeLaunch(), refused_launch=FakeLaunch(700), wave2_mt_launch=FakeLaunch())
    loads = []
    monkeypatch.setattr(cuda_build, "load_kernel_library", lambda name: loads.append(name) or lib)
    for table in ("_FUNCS", "_CHECKED"):
        monkeypatch.setattr(cuda_build, table, {})
    monkeypatch.setattr(cuda_build, "_LAUNCHES", Counter())
    streams = []
    monkeypatch.setattr(cuda_build, "_raw_stream", lambda index: streams.append(index) or 0x5EED)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    return SimpleNamespace(lib=lib, loads=loads, streams=streams)


def _resolved_and_typed_once(fake):
    x = torch.zeros(4)
    for _ in range(3):
        cuda_build.launch("some", "some_launch", x, 3, device=torch.device("cuda", 1))
    fn = fake.lib.some_launch
    assert fake.loads == ["some"] and len(fn.calls) == 3
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] and fn.restype is ctypes.c_int
    assert fake.streams == [1] * 3  # the stream of device 1


def _arguments_in_order_with_the_stream_last(fake):
    x, y = torch.zeros(4), torch.ones(2, dtype=torch.int32)
    cuda_build.launch("some", "some_launch", x, None, y, 7, True, False, device=CUDA)
    assert fake.lib.some_launch.calls == [(x.data_ptr(), None, y.data_ptr(), 7, True, False, 0x5EED)]
    assert fake.lib.some_launch.argtypes == [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    # None and a tensor are both pointers, a bool and an int both C ints: the same kinds
    cuda_build.launch("some", "some_launch", None, x, None, False, 2, 1, device=CUDA)
    assert fake.lib.some_launch.calls[1] == (None, x.data_ptr(), None, False, 2, 1, 0x5EED)
    assert fake.streams == [2, 2]  # a device without an index: the current device's stream


def _a_kind_change_raises(fake):
    x = torch.zeros(4)
    cuda_build.launch("some", "some_launch", x, 3, device=CUDA)
    for args in ((3, x), (x, x), (x, None), (x,), (x, 3, 4), (x, 3.0)):
        with pytest.raises(TypeError, match="some_launch"):
            cuda_build.launch("some", "some_launch", *args, device=CUDA)
    assert len(fake.lib.some_launch.calls) == 1 and cuda_build.launch_counts() == Counter(some=1)


def _a_refused_launch_raises(fake):
    with pytest.raises(RuntimeError, match="refused_launch.*cudaError 700"):
        cuda_build.launch("some", "refused_launch", torch.zeros(4), 1, device=CUDA)
    assert cuda_build.launch_counts() == Counter()


def _one_count_a_call(fake):
    before = cuda_build.launch_counts()
    cuda_build.launch("some", "some_launch", device=CUDA)
    assert cuda_build.launch_counts() - before == Counter(some=1)
    profiler.reset()
    try:
        cuda_build.launch("some", "some_launch", device=CUDA)
        assert "launches.some" not in profiler.counters()  # counted only while tracing
        with profiler.enable():
            cuda_build.launch("some", "some_launch", device=CUDA)
            cuda_build.launch("some", "some_launch", device=CUDA)
        assert profiler.counters()["launches.some"] == 2
    finally:
        profiler.reset()
    assert cuda_build.launch_counts() - before == Counter(some=4)
    counts = cuda_build.launch_counts()
    counts["some"] += 10  # a copy: the reader's changes do not reach the count
    assert cuda_build.launch_counts() - before == Counter(some=4)


def _tuning_variants_swapped_in_are_launched(fake):
    # tools/torch_tune_wave2.py puts each variant in the kernel's place: the next launch calls it, typed alike
    x = torch.zeros(4)
    cuda_build.launch("wave2_mt", "wave2_mt_launch", x, 3, device=CUDA)
    variants = [FakeLaunch(), FakeLaunch()]
    for variant in variants:
        tune.install("wave2_mt", variant)
        cuda_build.launch("wave2_mt", "wave2_mt_launch", x, 3, device=CUDA)
    assert [len(fn.calls) for fn in (fake.lib.wave2_mt_launch, *variants)] == [1, 1, 1]
    for variant in variants:
        assert variant.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        assert variant.restype is ctypes.c_int
    with pytest.raises(TypeError, match="wave2_mt_launch"):  # the variant is held to the kernel's kinds
        cuda_build.launch("wave2_mt", "wave2_mt_launch", x, x, device=CUDA)
    assert cuda_build.launch_counts() == Counter(wave2_mt=3)


@pytest.mark.parametrize("case", [_resolved_and_typed_once, _arguments_in_order_with_the_stream_last,
                                  _a_kind_change_raises, _a_refused_launch_raises, _one_count_a_call,
                                  _tuning_variants_swapped_in_are_launched],
                         ids=lambda f: f.__name__.strip("_"))
def test_launch(fake, case):
    case(fake)


@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 4099])
@pytest.mark.parametrize("grid", [False, True])
def test_add_one_on_the_cpu_is_the_plain_version(n, grid):
    x = torch.as_tensor(np.random.default_rng(n).normal(size=n).astype(np.float32))
    before = cuda_build.launch_counts()
    assert torch.equal(add_one(x, grid=grid), add_one_reference(x))
    assert cuda_build.launch_counts() == before  # only a launch on the card counts


def test_other_devices_raise():
    meta = torch.zeros((1, w2.ROWS, 128), device="meta")
    with pytest.raises(ValueError):
        add_one(meta)
    with pytest.raises(ValueError):
        empty_launch("cpu")
    with pytest.raises(ValueError):
        w2.mt_chunks(torch.zeros(1, dtype=torch.int32, device="meta"), torch.zeros((1, 64, 16), device="meta"),
                     torch.zeros((1, 8, 8), device="meta"), *([meta] * 7), any_hit=False)
