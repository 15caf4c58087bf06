"""The program's spans (``vnlb_tpu_torch.utils.timer.span``) on the CPU.

With no profiler recording, ``span`` hands back one shared no-op object
and a ``denoise`` call opens no ``record_function``.  Under
``torch.profiler`` a two-pass ``denoise`` (zero flow, 5 frames) records
every span of ``span_names()`` but the sync sites only a CUDA run has,
each inside the benchmark's ranges at the depth its
``perfbench/ranges/<span>.json`` gives, with no kernel call inside a
filter or top-K span, no span inside one of its own name and the
``vnlb.sync.*`` spans innermost; a ``denoise_streaming`` call in the same
recording opens the stream's spans, each inside the range around the
function that opens it.  Every ``span("...")`` of the package names an
entry of the catalogue."""

import json
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils import span, span_names, timer

from perfbench.harness import trace

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "vnlb_tpu_torch"
# the depth of each span's range file: 1 is the pass (pipeline.proc_nl),
# 2 accumulate and the pass's own work, 3 the layer entries, 4 inside them
DEPTH = {"vnlb.pass.prepare": 2, "vnlb.pass.plan": 2, "vnlb.pass.finish": 2,
         "vnlb.scatter.order": 4, "vnlb.scatter.rounds": 4,
         "vnlb.filter.prep": 4, "vnlb.filter.finish": 4,
         "vnlb.search.topk": 4}
# the stream's spans are read through the ranges around the functions that
# open them (perfbench/ranges/streaming.*.json), not through files of their
# own
STREAM = {"vnlb.stream.step": "streaming.enter_step",
          "vnlb.stream.retire": "streaming.retire"}
REGISTERED = [n for n in span_names()
              if not n.startswith("vnlb.sync.") and n not in STREAM]
# K2's tables are uploaded by the kernel's wrapper; only a CUDA call ends
# in a synchronize
CUDA_ONLY = ("vnlb.sync.filter_consts", "vnlb.sync.call_end")
ON_CPU = [n for n in span_names() if n not in CUDA_ONLY]


def clip():
    return add_noise(synthetic_video(5, 40, 52, seed=3), 20.0, seed=1)


@pytest.fixture(scope="module")
def recorded():
    """(CPU range events as (name, start, end), the harness's range
    depths) of one profiled two-pass ``denoise`` with the benchmark's
    ranges around the program's entries and kernel calls."""
    inst = trace.Instrument(vt)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            vt.denoise(clip(), 20.0, device="cpu", kernels=inst.kernels)
            vt.denoise_streaming(clip(), 20.0, chunk=2, device="cpu",
                                 kernels=inst.kernels)
        depth = {n: d for n, d in inst.depth.items()
                 if not n.startswith("vnlb.")}
        names = set(inst.range_names) | set(span_names())
    finally:
        inst.undo()
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    return events, depth


def of(events, name):
    return [(s, e) for n, s, e in events if n == name]


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_off_is_one_shared_noop(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    a, b = span("vnlb.pass.plan"), span("vnlb.search.topk")
    assert a is b
    with a, b:
        pass
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    deno, basic, _ = vt.denoise(clip(), 20.0, device="cpu")
    assert deno.shape == basic.shape == (5, 3, 40, 52)
    assert opened == []


@pytest.mark.parametrize("name", ON_CPU)
def test_every_span_recorded(recorded, name):
    events, _ = recorded
    assert of(events, name), f"{name} never opened"


def test_cuda_only_sites_absent_on_the_cpu(recorded):
    events, _ = recorded
    for name in CUDA_ONLY:
        assert not of(events, name)


@pytest.mark.parametrize("name", REGISTERED)
def test_span_sits_at_its_range_files_depth(recorded, name):
    """Each occurrence lies inside a harness range of depth one less than
    its own and inside none of its depth or deeper."""
    events, depth = recorded
    ranges = [(n, s, e) for n, s, e in events if n in depth]
    for iv in of(events, name):
        around = [depth[n] for n, s, e in ranges if inside(iv, (s, e))]
        assert around and max(around) == DEPTH[name] - 1, (name, around)


def test_no_kernel_call_inside_filter_or_topk(recorded):
    events, _ = recorded
    kernels = [(s, e) for n, s, e in events if n.startswith(trace.KERNEL)]
    assert kernels
    for name in ("vnlb.filter.prep", "vnlb.filter.finish",
                 "vnlb.search.topk"):
        for iv in of(events, name):
            assert not any(k[0] < iv[1] and iv[0] < k[1] for k in kernels)


def test_same_name_never_nests(recorded):
    events, _ = recorded
    for name in span_names():
        ivs = sorted(of(events, name))
        assert all(a[1] <= b[0] for a, b in zip(ivs, ivs[1:])), name


def test_sync_spans_innermost(recorded):
    events, _ = recorded
    for n, s, e in events:
        if not n.startswith("vnlb.sync."):
            continue
        assert not any(m != n and inside((s2, e2), (s, e))
                       for m, s2, e2 in events), n


def test_range_files_are_the_registered_spans():
    files = sorted((REPO / "perfbench" / "ranges").glob("vnlb.*.json"))
    assert sorted(p.stem for p in files) == sorted(REGISTERED)
    assert sorted(REGISTERED) == sorted(DEPTH)
    for p in files:
        assert json.loads(p.read_text()) == {
            "module": "vnlb_tpu_torch.utils.timer",
            "attribute": "span_names", "depth": DEPTH[p.stem]}


def test_stream_spans_inside_their_ranges(recorded):
    events, depth = recorded
    for name, rng in STREAM.items():
        assert depth[rng] == 2
        spans = of(events, name)
        assert spans and len(spans) == len(of(events, rng))
        assert all(any(inside(iv, r) for r in of(events, rng))
                   for iv in spans)


def test_catalogue_is_what_the_package_opens():
    names = span_names()
    assert names is timer.SPANS and len(set(names)) == len(names)
    assert all(n.startswith("vnlb.") for n in names)
    opened = set()
    for path in PACKAGE.rglob("*.py"):
        opened |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert opened == set(names)
