"""The traced run: ranges around the program's layer entries and kernel
calls, a log of every kernel call's arguments, and the reduction of the
profiler's events to a record the per-layer metric readers read.

Instrumentation lives in the benchmark's files only (``Instrument``): each
entry that a ``perfbench/ranges/<range>.json`` names is wrapped in a
``torch.profiler.record_function`` range while the traced run lasts, and
the ``Kernels`` tuple that ``denoise(kernels=)`` takes is rebuilt from
wrappers that put every call of each field ``f`` in a range
``kernel.<f>`` and log its arguments (tensors as their shape, dtype and
element size; other arguments as they are), whatever the kernel.  A
reader derives a call's work from that log.  An entry the program no
longer has is left out, and the metrics that read it are absent.  Nothing
adds a synchronize.

A device operation (kernel, copy or fill) belongs to a range when the host
call that launched it (CUPTI's runtime event of the same correlation id)
lies inside the range.
"""

from __future__ import annotations

import bisect
import importlib
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

from . import spec, stats

WINDOW = "bench.window"
CALL = "api.denoise"
KERNEL = "kernel."
SMALL_GAP_NS = 10_000


class Tensor(NamedTuple):
    """What the log keeps of a tensor argument."""

    shape: Tuple[int, ...]
    dtype: str
    element_size: int

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def describe(arg):
    """A kernel call's argument as the log keeps it: a tensor as its
    ``Tensor``, a list or tuple item by item, anything else as it is."""
    if hasattr(arg, "shape") and hasattr(arg, "element_size"):
        return Tensor(tuple(int(s) for s in arg.shape),
                      str(arg.dtype).replace("torch.", ""),
                      int(arg.element_size()))
    if isinstance(arg, (list, tuple)) and not hasattr(arg, "_fields"):
        return type(arg)(describe(a) for a in arg)
    return arg


class Instrument:
    """Ranges around the program's entries and kernels for one traced run;
    ``undo`` restores every patched attribute.  ``calls[range]`` is the
    log of that kernel range's calls: dicts of ``args``, ``kwargs`` and
    ``launched`` (whether the call's ``launches`` counter moved, True for
    a kernel without one)."""

    def __init__(self, vt, root: Path = spec.ROOT):
        import torch

        self._torch = torch
        self._saved: List[Tuple[object, str, object]] = []
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.depth: Dict[str, int] = {}
        for rng, where in spec.ranges(root).items():
            mod = importlib.import_module(where["module"])
            fn = getattr(mod, where["attribute"], None)
            if fn is None:
                continue
            self._saved.append((mod, where["attribute"], fn))
            setattr(mod, where["attribute"], self._ranged(rng, fn))
            self.depth[rng] = int(where["depth"])
        fields = {f: self._kernel(KERNEL + f, getattr(vt.KERNELS, f))
                  for f in vt.KERNELS._fields
                  if callable(getattr(vt.KERNELS, f))}
        self.kernels = vt.KERNELS._replace(**fields)
        self.kernel_ranges = [KERNEL + f for f in fields]

    @property
    def range_names(self) -> List[str]:
        return list(self.depth) + self.kernel_ranges

    def label_order(self) -> List[str]:
        """Range names innermost first: what the host was doing during an
        idle gap."""
        return (self.kernel_ranges
                + sorted(self.depth, key=lambda r: -self.depth[r])
                + [CALL, WINDOW])

    def _ranged(self, name, fn):
        record_function = self._torch.profiler.record_function

        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    def _kernel(self, name, fn):
        record_function = self._torch.profiler.record_function
        log = self.calls[name]

        def run(*args, **kwargs):
            before = getattr(fn, "launches", None)
            with record_function(name):
                out = fn(*args, **kwargs)
            after = getattr(fn, "launches", None)
            log.append(dict(args=describe(args),
                            kwargs={k: describe(v)
                                    for k, v in kwargs.items()},
                            launched=before is None or after - before > 0))
            return out
        return run

    def clear(self):
        for log in self.calls.values():
            log.clear()

    def undo(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


class Record(NamedTuple):
    """What a traced window holds, for the metric readers (seconds)."""

    window_s: float
    busy_s: float
    frames: int
    device_ops: Dict[str, float]          # op name -> seconds
    in_range: Dict[str, float]            # range -> seconds of its ops
    in_range_op: Dict[Tuple[str, str], float]   # (range, op) -> seconds
    kernel_calls: Dict[str, List[dict]]   # kernel range -> logged calls
    idle_by_label: Dict[str, float]       # host range -> idle seconds
    unattributed_s: float                 # device time with no launch found
    n_device_ops: int                     # device ops in the window

    def op_seconds(self, rng: str, contains: str) -> Optional[float]:
        """Seconds of the ops launched inside ``rng`` whose name holds
        ``contains``; None when the range never ran."""
        if rng not in self.in_range:
            return None
        return sum(s for (r, op), s in self.in_range_op.items()
                   if r == rng and contains in op)


class _Ranges:
    """Sorted, disjoint intervals of one range name; ``holds(t)``."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def holds(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def short_name(op: str) -> str:
    """A device op's name without ``(anonymous namespace)::`` and its
    parameter list, at most 100 characters."""
    return op.replace("(anonymous namespace)::", "").split("(")[0].strip()[:100]


def reduce_events(events, range_names, frames: int, kernel_calls,
                  label_order=None) -> Record:
    """The record of one traced window from the profiler's raw events
    (objects with the ``_KinetoEvent`` accessors); the window is the
    ``WINDOW`` range.  ``label_order``: the range names innermost first
    (default: ``range_names`` in reverse), by which an idle gap is put
    down to what the host was in."""
    from torch.autograd import DeviceType

    names = set(range_names) | {WINDOW, CALL}
    spans = defaultdict(list)
    runtime, cpu_ops, device = {}, {}, []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name in names:
                spans[name].append((ev.start_ns(), ev.end_ns()))
            elif name.startswith("cu"):   # a CUDA API call (cuda*, cu*)
                runtime[ev.correlation_id()] = ev.start_ns()
            else:
                cpu_ops[ev.correlation_id()] = ev.start_ns()
        elif ev.device_type() == DeviceType.CUDA:
            if name in names or ev.is_user_annotation():
                continue
            device.append((ev.start_ns(), ev.end_ns(), name,
                           ev.correlation_id(), ev.linked_correlation_id()))
    if len(spans[WINDOW]) != 1:
        raise RuntimeError(f"the trace holds {len(spans[WINDOW])} window "
                           f"ranges, not one")
    lo, hi = spans[WINDOW][0]
    ranges = {n: _Ranges(s) for n, s in spans.items() if n != WINDOW}
    in_range, in_range_op = defaultdict(float), defaultdict(float)
    for n in ranges:
        in_range[n] += 0.0
    device_ops = defaultdict(float)
    intervals, unattributed = [], 0.0
    for s, e, name, corr, linked in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        sec = (e - s) / 1e9
        op = short_name(name)
        device_ops[op] += sec
        intervals.append((s, e))
        t = runtime.get(corr)
        if t is None:
            t = cpu_ops.get(linked)
        if t is None:
            unattributed += sec
            continue
        for n, r in ranges.items():
            if r.holds(t):
                in_range[n] += sec
                in_range_op[(n, op)] += sec
    busy_ns = stats.busy(intervals, lo, hi)
    order = (list(label_order) if label_order is not None
             else list(reversed(list(range_names))) + [CALL, WINDOW])
    idle = defaultdict(float)
    for s, e in stats.gaps(intervals, lo, hi):
        if e - s < SMALL_GAP_NS:
            idle["gaps under 10 us"] += (e - s) / 1e9
            continue
        mid = (s + e) / 2
        label = next((n for n in order
                      if n in ranges and ranges[n].holds(mid)), "between calls")
        idle[label] += (e - s) / 1e9
    return Record(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
                  frames=frames, device_ops=dict(device_ops),
                  in_range=dict(in_range), in_range_op=dict(in_range_op),
                  kernel_calls={k: list(v) for k, v in kernel_calls.items()},
                  idle_by_label=dict(idle),
                  unattributed_s=unattributed, n_device_ops=len(intervals))


def breakdown(rec: Record) -> dict:
    """The ``breakdown`` of the result line: the 10 device ops that took
    most time and the 10 largest idle totals by what the host was in."""
    top = sorted(rec.device_ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(rec.idle_by_label.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}
