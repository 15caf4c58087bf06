"""The readers of the program's own spans on synthetic profiler events:
``vnlb.*`` ranges that the program opens inside the harness's ranges,
device ops launched inside and outside them, idle gaps whose midpoints
fall inside them; and silence where the program opens no span, as a
program without ``utils.timer.span_names`` does."""

import pytest

from perfbench.harness import spec, trace
from perfbench.tests.test_perfbench_stats import CPU, CUDA, Ev

US = 1000
FRAMES = 5
HARNESS = ["pipeline.proc_nl", "pipeline.accumulate", "ops.search_dense",
           "ops.bayes", "ops.agg.agg_rows", "kernel.patch_dist",
           "kernel.econ_filter"]
SPANS = ["vnlb.pass.prepare", "vnlb.pass.plan", "vnlb.pass.finish",
         "vnlb.scatter.order", "vnlb.scatter.rounds", "vnlb.filter.prep",
         "vnlb.filter.finish", "vnlb.search.topk"]


def launch(corr, t_us, s_us, e_us, name):
    """A runtime launch at ``t_us`` of a device op over [s_us, e_us]."""
    return [Ev("cudaLaunchKernel", CPU, t_us * US, (t_us + 1) * US,
               corr=corr),
            Ev(name, CUDA, s_us * US, e_us * US, corr=corr)]


def span_trace():
    """One 5-frame call of 1000 us.  Device ops (us): K1 120-170, the sort
    of the top-K 200-240, K1 again 296-300, filter prep 301-340, K2
    360-460, filter finish 470-490, the scatter's sort 500-520, its rounds
    620-700 and 800-820, the pass's colour conversion 950-990.  Idle gaps
    of 10 us or more and the innermost range at their midpoints: 0-120
    (the plan), 170-200 (the dense search), 240-296 (the top-K), 340-360
    (K2's call), 460-470 and 490-500 (the filter's finish), 520-620 (the
    order), 700-800 (the rounds), 820-950 and 990-1000 (the pass's
    finish)."""
    evs = [
        Ev(trace.WINDOW, CPU, 0, 1000 * US),
        Ev(trace.CALL, CPU, 0, 1000 * US),
        Ev("pipeline.proc_nl", CPU, 0, 1000 * US),
        Ev("vnlb.pass.prepare", CPU, 0, 50 * US),
        Ev("vnlb.pass.plan", CPU, 50 * US, 100 * US),
        Ev("vnlb.sync.sites", CPU, 80 * US, 95 * US),
        Ev("pipeline.accumulate", CPU, 100 * US, 880 * US),
        Ev("ops.search_dense", CPU, 100 * US, 300 * US),
        Ev("kernel.patch_dist", CPU, 105 * US, 115 * US),
        Ev("vnlb.search.topk", CPU, 190 * US, 295 * US),
        Ev("ops.bayes", CPU, 300 * US, 499 * US),
        Ev("vnlb.filter.prep", CPU, 300 * US, 345 * US),
        Ev("kernel.econ_filter", CPU, 345 * US, 355 * US),
        Ev("vnlb.sync.filter_consts", CPU, 346 * US, 350 * US),
        Ev("vnlb.filter.finish", CPU, 465 * US, 498 * US),
        Ev("ops.agg.agg_rows", CPU, 500 * US, 880 * US),
        Ev("vnlb.scatter.order", CPU, 500 * US, 600 * US),
        Ev("vnlb.sync.scatter_counts", CPU, 590 * US, 600 * US),
        Ev("vnlb.scatter.rounds", CPU, 600 * US, 880 * US),
        Ev("vnlb.pass.finish", CPU, 880 * US, 1000 * US),
    ]
    evs += launch(1, 110, 120, 170, "void patch_dist_kernel<7>()")
    evs += launch(2, 200, 200, 240, "void cub::DeviceSegmentedRadixSort()")
    evs += launch(3, 301, 301, 340, "void elementwise_kernel()")
    evs += launch(4, 351, 360, 460, "void econ_tc_kernel<64>()")
    evs += launch(5, 466, 470, 490, "void elementwise_kernel()")
    evs += launch(6, 500, 500, 520, "void radixSortKVInPlace()")
    evs += launch(7, 610, 620, 700, "void index_elementwise_kernel()")
    evs += launch(8, 790, 800, 820, "void index_put_kernel()")
    evs += launch(9, 940, 950, 990, "void elementwise_kernel()")
    # launched inside ops.search_dense but outside the top-K span: K1 on a
    # coarse level after the sort's range
    evs += launch(10, 296, 296, 300, "void patch_dist_kernel<7>()")
    return evs


def record(range_names, events=None):
    order = (["kernel.patch_dist", "kernel.econ_filter"]
             + [s for s in SPANS if not s.startswith("vnlb.pass")]
             + ["ops.search_dense", "ops.bayes", "ops.agg.agg_rows",
                "pipeline.accumulate", "vnlb.pass.prepare", "vnlb.pass.plan",
                "vnlb.pass.finish", "pipeline.proc_nl", trace.CALL,
                trace.WINDOW])
    return trace.reduce_events(span_trace() if events is None else events,
                               range_names, FRAMES, {},
                               [n for n in order if n in range_names
                                or n in (trace.CALL, trace.WINDOW)])


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_device_time_of_the_spans():
    rec = record(HARNESS + SPANS)
    # the sort of the top-K only; K1 (120-170 and 296-300) launched in
    # the same ops.search_dense range lies outside the span
    assert rec.in_range["ops.search_dense"] == pytest.approx(94e-6)
    assert read("topk.ms_per_frame", rec) == pytest.approx(1e3 * 40e-6 / 5)
    assert not any(r == "vnlb.search.topk" and "patch_dist" in op
                   for r, op in rec.in_range_op)
    # the glue: prep 39 us + finish 20 us; K2's 100 us is not glue
    assert read("filter_glue.ms_per_frame", rec) == pytest.approx(
        1e3 * 59e-6 / 5)
    assert read("filter.ms_per_frame", rec) == pytest.approx(
        1e3 * 159e-6 / 5)
    # the rounds' two index kernels, not the order's sort
    assert read("scatter_rounds.ms_per_frame", rec) == pytest.approx(
        1e3 * 100e-6 / 5)
    assert read("scatter_rounds.ms_per_frame", rec) <= read(
        "agg.ms_per_frame", rec)


def test_idle_put_down_to_the_spans():
    rec = record(HARNESS + SPANS)
    idle = rec.idle_by_label
    # 0-120: midpoint 60 in the plan span; 990-1000 and 820-950 (midpoint
    # 885) in the pass's finish
    assert idle["vnlb.pass.plan"] == pytest.approx(120e-6)
    assert idle["vnlb.pass.finish"] == pytest.approx(140e-6)
    assert read("pass_host.idle_ms_per_frame", rec) == pytest.approx(
        1e3 * 260e-6 / 5)
    # 520-620 (midpoint 570) in the order, 700-800 in the rounds
    assert idle["vnlb.scatter.order"] == pytest.approx(100e-6)
    assert idle["vnlb.scatter.rounds"] == pytest.approx(100e-6)
    assert read("scatter_host.idle_ms_per_frame", rec) == pytest.approx(
        1e3 * 200e-6 / 5)
    # nothing left on the bare ranges the spans split
    assert "ops.agg.agg_rows" not in idle
    assert "pipeline.proc_nl" not in idle
    # 240-296 (midpoint 268) in the top-K span; 170-200 in the search
    assert idle["vnlb.search.topk"] == pytest.approx(56e-6)
    assert idle["ops.search_dense"] == pytest.approx(30e-6)


def test_without_spans_the_ranges_keep_the_idle():
    """The record of a program that opens no span (the harness skips the
    range files): the new metrics are absent, and the idle stays on the
    ranges around them."""
    evs = [e for e in span_trace() if not e.name().startswith("vnlb.")]
    rec = record(HARNESS, evs)
    for name in ("pass_host.idle_ms_per_frame",
                 "scatter_host.idle_ms_per_frame",
                 "scatter_rounds.ms_per_frame", "filter_glue.ms_per_frame",
                 "topk.ms_per_frame"):
        assert read(name, rec) is None
    assert rec.idle_by_label["pipeline.proc_nl"] == pytest.approx(260e-6)
    assert rec.idle_by_label["ops.agg.agg_rows"] == pytest.approx(200e-6)
    # the same events reduced without the span names listed: absent too
    rec = record(HARNESS)
    assert read("topk.ms_per_frame", rec) is None
    assert read("filter.ms_per_frame", rec) == pytest.approx(
        1e3 * 159e-6 / 5)


@pytest.mark.parametrize("name", ["pass_host.idle_ms_per_frame",
                                  "scatter_host.idle_ms_per_frame",
                                  "scatter_rounds.ms_per_frame",
                                  "filter_glue.ms_per_frame",
                                  "topk.ms_per_frame"])
def test_silent_without_frames_or_device_time(name):
    rec = record(HARNESS + SPANS)
    assert read(name, rec) > 0
    assert read(name, rec._replace(frames=0)) is None
    assert read(name, rec._replace(busy_s=0.0)) is None


def test_range_files_anchor_on_the_span_catalogue(monkeypatch):
    """Each span's range file points at ``utils.timer.span_names``, which
    no ``denoise`` call runs; a program without it skips the files."""
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch.utils import timer

    files = {n: w for n, w in spec.ranges().items()
             if n.startswith("vnlb.")}
    assert sorted(files) == sorted(SPANS)
    for where in files.values():
        assert (where["module"], where["attribute"]) == (
            "vnlb_tpu_torch.utils.timer", "span_names")
    catalogue = timer.span_names
    inst = trace.Instrument(vt)
    try:
        assert set(SPANS) <= set(inst.range_names)
        assert timer.span_names is not catalogue
    finally:
        inst.undo()
    assert timer.span_names is catalogue
    monkeypatch.delattr(timer, "span_names")
    inst = trace.Instrument(vt)
    try:
        assert not any(n.startswith("vnlb.") for n in inst.range_names)
    finally:
        inst.undo()
