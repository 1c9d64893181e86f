"""The port's kernel launch plumbing, as far as a host without a card can
show it: the C launch functions are resolved and typed once, CPU tensors take
the plain versions, other devices raise."""

import ctypes

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.ops import cuda_build
from raytracer_tpu_torch.ops import wave2_traverse as w2
from raytracer_tpu_torch.ops.launch_probe import add_one, add_one_reference, empty_launch


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


@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 4099])
@pytest.mark.parametrize("grid", [False, True])
def test_add_one_on_the_cpu_is_the_plain_version(n, grid):
    x = torch.as_tensor(np.random.default_rng(n).normal(size=n).astype(np.float32))
    assert add_one.launches == 0
    assert torch.equal(add_one(x, grid=grid), add_one_reference(x))
    assert add_one.launches == 0  # only a launch on the card counts


def test_other_devices_raise():
    meta = torch.zeros((1, w2.ROWS, 128), device="meta")
    with pytest.raises(ValueError):
        add_one(meta)
    with pytest.raises(ValueError):
        empty_launch("cpu")
    with pytest.raises(ValueError):
        w2.mt_chunks(torch.zeros(1, dtype=torch.int32, device="meta"), torch.zeros((1, 64, 16), device="meta"),
                     torch.zeros((1, 8, 8), device="meta"), *([meta] * 7), any_hit=False)
