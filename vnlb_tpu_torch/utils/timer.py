"""Wall-clock timing, an optional profiler region (vnlb_tpu/utils/timer.py,
with ``torch.profiler`` in place of ``jax.profiler``) and the program's
spans.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler session records (``trace``, or any ``torch.profiler.profile``),
and is a shared no-op otherwise: one C call and one branch, no allocation.
Every span the program opens is listed in ``SPANS``, the waits last: the
``vnlb.sync.*`` spans name each host-card copy or read that waits for the
device.  A span adds no synchronize, no ``.item()`` and no tensor.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

SPANS = (
    "vnlb.pass.prepare",        # pipeline.proc_nl: config checks, rgb -> yuv
    "vnlb.pass.plan",           # pipeline.proc_nl: site lattice and upload
    "vnlb.pass.finish",         # pipeline.proc_nl: normalise, yuv -> rgb
    "vnlb.scatter.order",       # agg.scatter_add_rows: sort, ranks, counts
    "vnlb.scatter.rounds",      # agg.scatter_add_rows: one round a rank
    "vnlb.filter.prep",         # bayes.bayes_denoise: centring, flat switch
    "vnlb.filter.finish",       # bayes.bayes_denoise: trace, + mean, layout
    "vnlb.search.topk",         # both searches: sort, merge, threshold
    "vnlb.sync.inputs",         # api.denoise / denoise_mod: clip, flows
    "vnlb.sync.sites",          # pipeline.proc_nl: the sites' upload
    "vnlb.sync.color_matrix",   # color._mix: the 3 x 3 matrix's upload
    "vnlb.sync.dense_inf",      # search_dense._masker: the inf scalar
    "vnlb.sync.gather_inf",     # search.exec_search: the inf scalar
    "vnlb.sync.scatter_counts",  # agg.scatter_add_rows: bincount, tolist
    "vnlb.sync.filter_consts",  # econ_filter._consts: K2's tables
    "vnlb.sync.call_end",       # api.denoise / denoise_mod: the last wait
)

_NOOP = contextlib.nullcontext()
_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` (one of ``SPANS``) while
    a profiler records, else the shared no-op context."""
    if _enabled():
        return torch.profiler.record_function(name)
    return _NOOP


def span_names() -> tuple:
    """Every span the program opens, in ``SPANS``' order."""
    return SPANS


class Timer:
    def __init__(self):
        self._start = None
        self.elapsed = 0.0

    def tic(self):
        self._start = time.perf_counter()
        return self

    def toc(self) -> float:
        if self._start is None:
            raise RuntimeError("Timer.toc() before tic()")
        self.elapsed = time.perf_counter() - self._start
        return self.elapsed

    def __enter__(self):
        return self.tic()

    def __exit__(self, *exc):
        self.toc()
        return False


@contextlib.contextmanager
def trace(name: str, logdir: str | None = None):
    """Profile a region with ``torch.profiler`` (the host, and the CUDA
    device when there is one) when VNLB_TPU_PROFILE names a log directory
    (or ``logdir`` is given); the trace is written there for TensorBoard,
    the program's spans inside the region.  Unset, the region runs as it
    is."""
    logdir = logdir or os.environ.get("VNLB_TPU_PROFILE", "")
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        with record_function(name):
            yield


def sync(tree):
    """Wait for the CUDA device of every CUDA tensor in a nested tuple,
    list or dict (a fence for timing); returns ``tree``."""
    import torch

    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
