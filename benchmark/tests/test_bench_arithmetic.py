"""The metric arithmetic: window rates, the p90 and its count, spreads,
the idle share, and the reading of a trace into layers and gaps."""

import statistics

import pytest

from harness import cells, stats, tracing


def test_percentile_nearest_rank_and_count():
    xs = list(range(1, 101))  # 100 samples: 10 lie beyond the p90
    assert stats.percentile(xs, 90) == 90
    assert sum(1 for x in xs if x > stats.percentile(xs, 90)) == 10
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_spread_is_python_quartiles_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_union_counts_overlaps_once():
    assert stats.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert stats.union_seconds([(0, 4), (1, 2)]) == pytest.approx(4.0)
    assert stats.union_seconds([]) == 0.0


class Ev:
    """A stand-in for a kineto event of the given activity."""

    def __init__(self, kind, name, start, dur, corr=0):
        self.k, self.n, self.s, self.d, self.c = kind, name, start, dur, corr

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.k in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation") else \
            DeviceType.CPU

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c


def trace():
    """Host: frame_loop [0, 100] holds integrator [10, 90], which holds
    traversal [20, 40].  Launches at 5, 15, 25, 95; the device runs them at
    [50, 60], [60, 70], [80, 100], [120, 130]."""
    return [
        Ev("user_annotation", "bench::frame_loop", 0, 100),
        Ev("user_annotation", "bench::integrator", 10, 80),
        Ev("user_annotation", "bench::traversal", 20, 20),
        Ev("user_annotation", "other", 0, 1000),
        Ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        Ev("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=2),
        Ev("cuda_driver", "cuLaunchKernel", 25, 1, corr=3),
        Ev("cuda_runtime", "cudaMemcpyAsync", 95, 1, corr=4),
        Ev("kernel", "setup_kernel", 50, 10, corr=1),
        Ev("kernel", "shade_kernel", 60, 10, corr=2),
        Ev("kernel", "wave2_mt_kernel", 80, 20, corr=3),
        Ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 120, 10, corr=4),
        Ev("cpu_op", "aten::mul", 16, 3, corr=2),
        Ev("gpu_user_annotation", "bench::traversal", 80, 20),
        Ev("kernel", "orphan", 140, 5, corr=99),
    ]


def test_trace_is_read_into_layers():
    got = tracing.read_events(trace())
    assert [s[0] for s in got["spans"]] == ["frame_loop", "integrator", "traversal"]
    assert len(got["ops"]) == 5  # the device annotation is no operation
    layers = tracing.attribute(got["spans"], got["ops"])
    assert layers["traversal"] == pytest.approx(20e-9)
    assert layers["integrator"] == pytest.approx(30e-9)
    assert layers["frame_loop"] == pytest.approx(50e-9)  # the memcpy was launched after it closed
    assert sum(1 for op in got["ops"] if op[3] is None) == 1
    assert tracing.top_ops(got["ops"])[0] == ["wave2_mt_kernel", pytest.approx(20e-9)]


def test_idle_gaps_by_host_activity():
    got = tracing.read_events(trace())
    gaps = dict((k, v) for k, v in tracing.idle_gaps(got["spans"], got["ops"]))
    # the device waits over [70, 80] from inside the integrator, over
    # [100, 120] from the frame loop's last instant, over [130, 140] past it
    assert gaps["host in integrator"] == pytest.approx(10e-9)
    assert gaps["host in frame_loop"] == pytest.approx(20e-9)
    assert gaps["host outside the spans"] == pytest.approx(10e-9)


def window(units=10, wall=5.0, **kw):
    return dict({"units": units, "wall_s": wall, "counters": {}, "rays": 0.0}, **kw)


def profile(units=2, busy=0.2, layers=None, n_ops=100):
    return {"units": units, "busy_s": busy, "layers_s": layers or {}, "n_ops": n_ops}


def read(metric, **ctx):
    return cells.load_module("metrics", metric).read(ctx)


def test_idle_share_is_busy_over_unprofiled_wall():
    # 0.1 s busy a pass against 0.5 s a pass of the window: 80% idle
    assert read("device_idle_pct.render", loop="render", window=window(), profile=profile()) == pytest.approx(80.0)
    assert read("device_idle_pct.train", loop="grad", window=window(), profile=profile()) == pytest.approx(80.0)
    assert read("device_idle_pct.render", loop="grad", window=window(), profile=profile()) is None


def test_per_unit_readers():
    p = profile(layers={"integrator": 0.5, "traversal": 0.3, "backward": 0.2, "display": 0.01})
    w = window(rays=2.0e7, counters={"host_syncs": 40})
    assert read("traversal_ms_per_pass.render", loop="render", window=w, profile=p) == pytest.approx(150.0)
    assert read("shading_ms_per_pass.render", loop="render", window=w, profile=p) == pytest.approx(100.0)
    assert read("launches_per_pass.render", loop="render", window=w, profile=p) == pytest.approx(50.0)
    assert read("rays_per_pass.render", loop="render", window=w, profile=p) == pytest.approx(2.0)
    assert read("wave2_syncs_per_pass", loop="render", window=w, profile=p) == pytest.approx(4.0)
    assert read("wave2_syncs_per_pass", loop="render", window=window(), profile=p) is None
    assert read("backward_ms_per_step", loop="grad", window=w, profile=p) == pytest.approx(100.0)
    assert read("display_ms_per_frame", loop="viewer", window=w, profile=p) == pytest.approx(5.0)
    assert read("saved_mib_per_step", loop="grad", window=w, saved_bytes=3 * 2**20) == pytest.approx(3.0)
    assert read("traversal_ms_per_pass.render", loop="render", window=w, profile=profile()) is None


def test_roofline_reader_needs_launches_and_time():
    r = {"launches": 4, "least_s": 0.001, "kernel_s": 0.004}
    assert read("wave2_mt_roofline", loop="render", window=window(), rooflines={"wave2_mt": r}) == pytest.approx(25.0)
    assert read("wave2_mt_roofline", loop="render", window=window(), rooflines={}) is None
    assert read("wave2_mt_roofline", loop="render", window=window(),
                rooflines={"wave2_mt": dict(r, launches=0)}) is None

