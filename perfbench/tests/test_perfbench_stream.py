"""The long-clip cell's files: the configuration, the mix, the entry, the
limits, the two range files and the two metric readers load by name; the
entry's program (``denoise_streaming`` on the host clip, its outputs moved
to the device) and its reference (the plain whole-clip ``denoise``) run on
a tiny CPU clip; both metrics read synthetic records, and are absent where
the program has no stream."""

import time

import numpy as np
import pytest
import torch

import vnlb_tpu_torch as vt
from perfbench import reference
from perfbench.harness import check, spec, trace
from perfbench.harness.loop import program_config, run_cell
from perfbench.tests.helpers import tiny
from perfbench.tests.test_perfbench_stats import CPU, CUDA, Ev
from perfbench.traffic import generator

CELL = "iphone-480p-t48-stream"
RANGES = ["streaming.enter_step", "streaming.retire"]
METRICS = ["stream_retire.ms_per_frame", "stream_host.idle_ms_per_frame"]
US = 1000
FRAMES = 48


def test_cell_loads_by_name():
    c = spec.cell(CELL)
    assert c.entry["config"] == "vnlb-iphone-480p-stream"
    assert c.entry["traffic"] == "t48-stream" and c.entry["chips"] == 1
    assert (c.config["preset"], c.config["sigma"], c.config["height"],
            c.config["width"], c.config["overrides"]) == ("iphone", 20.0,
                                                          480, 854, {})
    assert c.traffic["frames"] == 48 and c.traffic["flow"] == "zero"
    assert c.traffic["entry"] == "denoise_streaming"
    assert c.limits["limits"]
    assert [m["name"] for m in c.per_layer][-2:] == METRICS
    assert {m["name"] for m in c.end_to_end} == {"fps", "peak_mem_gib",
                                                  "setup_s"}
    for name in METRICS:
        assert callable(spec.metric_reader(name))
    ranges = spec.ranges()
    for name in RANGES:
        assert ranges[name] == {"module": "vnlb_tpu_torch.streaming",
                                "attribute": name.split(".")[1], "depth": 2}


@pytest.mark.parametrize("frames,nwt", [(3, None), (13, 2)])
def test_entry_program_and_reference(frames, nwt):
    """3 frames: one step, the program bitwise the reference; 13 frames at
    nwt 2: 6 steps a pass over a live window of 7 frames, the gaps of the
    scatter's summation order."""
    c = spec.cell(CELL)
    mix = dict(c.traffic, frames=frames, pool=1)
    entry = generator.module(mix, "entry")
    (clip,) = generator.make_pool(mix, 40, 48, 20.0, 2 ** 33 + 5)
    over = {} if nwt is None else dict(nwt_f=[nwt, nwt], nwt_b=[nwt, nwt])
    conf = dict(c.config, overrides=over)
    deno, basic = entry.program(vt, None, clip, 20.0,
                                program_config(vt, conf), "cpu", vt.KERNELS)
    assert isinstance(deno, torch.Tensor) and deno.shape == clip.noisy.shape
    rd, rb = entry.reference(reference, clip, 20.0,
                             program_config(reference, conf), "cpu")
    gaps = check.gaps(deno, basic, rd, rb)
    if nwt is None:
        assert torch.equal(deno, rd) and torch.equal(basic, rb)
    else:
        assert gaps["deno_mean_abs"] < 1e-3, gaps
        assert gaps["basic_mean_abs"] < 1e-3, gaps


def test_tiny_run_is_correct():
    got = run_cell(tiny(CELL), 2 ** 31 + 13, 0.01, False, "cpu",
                   time.perf_counter())
    assert got["correct"] is True, got["checks"]
    assert set(got["metrics"]) == {"fps", "peak_mem_gib", "setup_s"}


def launch(corr, t_us, s_us, e_us, name):
    return [Ev("cudaLaunchKernel", CPU, t_us * US, (t_us + 1) * US,
               corr=corr),
            Ev(name, CUDA, s_us * US, e_us * US, corr=corr)]


def stream_trace():
    """One call of 1000 us: a step (0-100; its colour conversion on the
    device 60-80), the accumulate (100-600; a kernel 120-580), a retire
    (600-900; the fold 650-700, the conversion 800-820, the copy out
    850-860), and host work outside the stream's ranges (900-1000).  Idle
    gaps and the range at their midpoints: 0-60, 80-120 (the step, its
    midpoint at 100 still inside it), 580-650, 700-800 and 820-850 (the
    retire), 860-1000 (midpoint 930: the call)."""
    evs = [
        Ev(trace.WINDOW, CPU, 0, 1000 * US),
        Ev(trace.CALL, CPU, 0, 1000 * US),
        Ev("streaming.enter_step", CPU, 0, 101 * US),
        Ev("vnlb.stream.step", CPU, 1 * US, 100 * US),
        Ev("pipeline.accumulate", CPU, 101 * US, 600 * US),
        Ev("streaming.retire", CPU, 600 * US, 900 * US),
        Ev("vnlb.stream.retire", CPU, 601 * US, 899 * US),
    ]
    evs += launch(1, 50, 60, 80, "void elementwise_kernel()")
    evs += launch(2, 110, 120, 580, "void patch_dist_kernel<7>()")
    evs += launch(3, 640, 650, 700, "void elementwise_kernel()")
    evs += launch(4, 790, 800, 820, "void elementwise_kernel()")
    evs += launch(5, 845, 850, 860, "Memcpy DtoH (Device -> Pageable)")
    return evs


def record(range_names):
    order = [n for n in ["pipeline.accumulate", *RANGES] if n in range_names]
    return trace.reduce_events(stream_trace(), range_names, FRAMES, {},
                               order + [trace.CALL, trace.WINDOW])


def test_metrics_read_the_stream_ranges():
    rec = record(["pipeline.accumulate", *RANGES])
    read = {m: spec.metric_reader(m)(rec) for m in METRICS}
    # the fold 50, the conversion 20, the copy 10 us
    assert read["stream_retire.ms_per_frame"] == pytest.approx(
        1e3 * 80e-6 / FRAMES)
    idle = rec.idle_by_label
    assert idle["streaming.enter_step"] == pytest.approx(100e-6)
    assert idle["streaming.retire"] == pytest.approx((70 + 100 + 30) * 1e-6)
    assert read["stream_host.idle_ms_per_frame"] == pytest.approx(
        1e3 * (100 + 200) * 1e-6 / FRAMES)
    assert np.isclose(idle["api.denoise"], 140e-6)


@pytest.mark.parametrize("name", METRICS)
def test_metrics_silent_without_the_stream(name):
    """A program without ``streaming.retire`` / ``enter_step`` (the ranges
    never open), or a record with no frames or no device time."""
    rec = record(["pipeline.accumulate"])
    assert spec.metric_reader(name)(rec) is None
    full = record(["pipeline.accumulate", *RANGES])
    assert spec.metric_reader(name)(full._replace(frames=0)) is None
    assert spec.metric_reader(name)(full._replace(busy_s=0.0)) is None
