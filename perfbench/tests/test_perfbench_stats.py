"""The benchmark's arithmetic on synthetic call lists, interval lists and
profiler events: fps, the 90th percentile, the idle share (with a stall
in the window), the reduction of a trace to layer times, and the readers
of the per-layer metrics."""

import statistics

import pytest
from torch.autograd import DeviceType

from perfbench.harness import spec, stats, trace
from perfbench.traffic import generator


def test_fps_takes_all_work_over_all_time():
    # 10 calls of 5 frames in a window that ends with the last call
    assert stats.fps(50, 7.5) == pytest.approx(50 / 7.5)
    with pytest.raises(ValueError):
        stats.fps(5, 0.0)


def test_p90_of_calls():
    lat = [0.70 + 0.001 * i for i in range(60)]
    got = stats.percentile(lat, 90)
    assert got == statistics.quantiles(lat, n=100, method="inclusive")[89]
    assert lat[53] <= got <= lat[54]
    # a stall: one slow call moves the tail, not the median
    stalled = lat[:-1] + [5.0]
    assert stats.percentile(stalled, 50) == stats.percentile(lat, 50)
    assert stats.percentile([0.7], 90) == 0.7


def test_union_and_idle_with_a_stall():
    kernels = [(0, 10), (5, 20), (20, 30), (60, 70), (95, 120)]
    assert stats.union(kernels, 0, 100) == [(0, 30), (60, 70), (95, 100)]
    assert stats.busy(kernels, 0, 100) == 45
    assert stats.gaps(kernels, 0, 100) == [(30, 60), (70, 95)]
    assert stats.busy([], 0, 10) == 0
    idle = spec.metric_reader("device.idle_pct")
    rec = reduce_fake()._replace(window_s=100.0,
                                 busy_s=stats.busy(kernels, 0, 100))
    assert idle(rec) == pytest.approx(55.0)
    # nothing ran on the device: no reading, not 100
    assert idle(rec._replace(busy_s=0.0)) is None


class Ev:
    """A stand-in of the profiler's raw event."""

    def __init__(self, name, dev, s, e, corr=0, linked=0, user=False):
        self._v = (name, dev, s, e, corr, linked, user)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def fake_trace():
    """A window of 1 ms: a dense search whose K1 launches one kernel (40
    us) and an aten op launching a sort (10 us); a filter whose K2 launches
    an econ kernel (100 us); then a stall of 500 us in which the host is in
    the fold with nothing on the device, and the fold's kernel (50 us)."""
    us = 1000
    return [
        Ev(trace.WINDOW, CPU, 0, 1000 * us),
        Ev(trace.CALL, CPU, 0, 1000 * us),
        Ev("ops.search_dense", CPU, 10 * us, 100 * us),
        Ev("kernel.patch_dist", CPU, 20 * us, 30 * us),
        Ev("cudaLaunchKernel", CPU, 21 * us, 22 * us, corr=7),
        Ev("void patch_dist_kernel<7>(float const*)", CUDA, 25 * us,
           65 * us, corr=7),
        Ev("aten::sort", CPU, 40 * us, 50 * us, corr=900),
        Ev("cudaLaunchKernel", CPU, 41 * us, 42 * us, corr=8),
        Ev("void radix_sort(int)", CUDA, 65 * us, 75 * us, corr=8,
           linked=900),
        Ev("ops.search_dense", CUDA, 25 * us, 75 * us, user=True),
        Ev("ops.bayes", CPU, 100 * us, 300 * us),
        Ev("kernel.econ_filter", CPU, 110 * us, 120 * us),
        Ev("cuLaunchKernel", CPU, 111 * us, 112 * us, corr=9),
        Ev("void econ_tc_kernel<64>(float const*)", CUDA, 120 * us,
           220 * us, corr=9),
        Ev("ops.agg.fold", CPU, 300 * us, 950 * us),
        Ev("cudaLaunchKernel", CPU, 800 * us, 801 * us, corr=10),
        Ev("void fold_kernel()", CUDA, 805 * us, 855 * us, corr=10),
        # launched by an op whose runtime event was not recorded
        Ev("void memset()", CUDA, 960 * us, 970 * us, corr=11, linked=0),
    ]


def k1_call(starts: bool):
    """The log of one ``patch_dist`` call as the traced run keeps it: 4096
    sites of a (5, 1, 480, 854) video, 9 planes, pt 1, ps 7, w_s 15."""
    vid = trace.Tensor((5, 1, 480, 854), "float32", 4)
    site = trace.Tensor((4096,), "int32", 4)
    start = trace.Tensor((9, 4096), "int32", 4)
    args = (vid, site, site, site, 0, 9, 1, 7, 15)
    kwargs = dict(sy=start, sx=start) if starts else {}
    return dict(args=args, kwargs=kwargs, launched=True)


def reduce_fake():
    calls = {"kernel.patch_dist": [k1_call(False), k1_call(True)],
             "kernel.econ_filter": []}
    ranges = ["ops.search_dense", "ops.bayes", "ops.agg.fold",
              "kernel.patch_dist", "kernel.econ_filter"]
    return trace.reduce_events(fake_trace(), ranges, frames=5,
                               kernel_calls=calls)


def test_reduce_events():
    rec = reduce_fake()
    assert rec.window_s == pytest.approx(1e-3)
    assert rec.busy_s == pytest.approx(210e-6)
    assert rec.n_device_ops == 5
    assert rec.in_range["ops.search_dense"] == pytest.approx(50e-6)
    assert rec.in_range["kernel.patch_dist"] == pytest.approx(40e-6)
    assert rec.in_range["ops.bayes"] == pytest.approx(100e-6)
    assert rec.in_range["ops.agg.fold"] == pytest.approx(50e-6)
    assert rec.unattributed_s == pytest.approx(10e-6)
    assert rec.op_seconds("kernel.patch_dist", "patch_dist_kernel") == \
        pytest.approx(40e-6)
    assert rec.op_seconds("kernel.dense_dist", "x") is None
    # the stall: the host in the fold (300-950 us) while the device idles
    # from the econ kernel's end to the fold kernel's start and after it
    assert rec.idle_by_label["ops.agg.fold"] == pytest.approx(
        (805 - 220 + 960 - 855) * 1e-6)
    assert rec.idle_by_label["ops.search_dense"] == pytest.approx(70e-6)
    assert rec.idle_by_label[trace.CALL] == pytest.approx(30e-6)
    bd = trace.breakdown(rec)
    assert bd["device_ops"][0][0] == "void econ_tc_kernel<64>"
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_one_window_range_required():
    evs = [e for e in fake_trace() if e.name() != trace.WINDOW]
    with pytest.raises(RuntimeError):
        trace.reduce_events(evs, [], 5, {})


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_readers_on_a_record():
    rec = reduce_fake()
    assert read("device.idle_pct", rec) == pytest.approx(79.0)
    assert read("search_dense.ms_per_frame", rec) == pytest.approx(0.01)
    assert read("filter.ms_per_frame", rec) == pytest.approx(0.02)
    assert read("agg.ms_per_frame", rec) == pytest.approx(0.01)
    # an entry that did not run: the metric is absent, not 0
    assert read("search_gather.ms_per_frame", rec) is None
    from perfbench.work.models import k1_work
    want = sum(k1_work(4096, 4096 * 12, 5 * 480 * 854, 1, 1, 7, 15,
                       starts=starts, planes=9)[0] for starts in (0, 2))
    assert read("k1.roofline_pct", rec) == pytest.approx(
        100 * want / 0.040)
    # K2 ran but no call was logged as launched: nothing to read
    assert read("k2.roofline_pct", rec) is None


def test_readers_silent_without_device_ops():
    rec = reduce_fake()._replace(busy_s=0.0, in_range_op={})
    for m in spec.benchmark()["per_layer"]:
        assert read(m["name"], rec) is None


MIX = dict(frames=3, content="synthetic_video", motion=1.5, flow="drift",
           entry="denoise", pool=2, check_calls=2)


def test_pool_is_the_seeds():
    a = generator.make_pool(MIX, 24, 32, 20.0, 2 ** 31 + 5)
    b = generator.make_pool(MIX, 24, 32, 20.0, 2 ** 31 + 5)
    c = generator.make_pool(MIX, 24, 32, 20.0, -(2 ** 31 + 5))
    assert all((x.noisy == y.noisy).all() for x, y in zip(a, b))
    assert not (a[0].noisy == c[0].noisy).all()
    assert not (a[0].noisy == a[1].noisy).all()
    assert a[0].flows[0].shape == (2, 2, 24, 32)
    assert generator.make_pool(dict(MIX, flow="zero"), 24, 32, 20.0,
                               5)[0].flows is None


def draw(k, seed, calls):
    s = generator.Sample(k, seed)
    for i in range(calls):
        s.offer(i, ("outputs", i))
    assert all(v == ("outputs", i) for i, v in s.kept.items())
    return sorted(s.kept)


def test_sample_is_the_seeds_and_spans_the_window():
    assert draw(2, 9, 60) == draw(2, 9, 60)
    assert len(draw(2, 9, 60)) == 2 and draw(2, 9, 1) == [0]
    # a uniform draw over all 60 calls: late calls are compared as often
    # as early ones
    picks = [i for seed in range(400) for i in draw(2, 2 ** 40 + seed, 60)]
    assert min(picks) == 0 and max(picks) == 59
    late = sum(i >= 30 for i in picks) / len(picks)
    assert 0.43 < late < 0.57


@pytest.mark.parametrize("bad", [dict(flow="tvl1"), dict(content="davis"),
                                 dict(entry="stream"), dict(flow="../x"),
                                 dict(frames=1), dict(check_calls=0)])
def test_bad_mix_refused(bad):
    with pytest.raises(ValueError):
        generator.check_mix(dict(MIX, **bad))
