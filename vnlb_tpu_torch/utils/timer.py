"""Wall-clock timing and an optional profiler region (vnlb_tpu/utils/timer.py,
with ``torch.profiler`` in place of ``jax.profiler``)."""

from __future__ import annotations

import contextlib
import os
import time


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
    (or ``logdir`` is given); the trace is written there for TensorBoard.
    Unset, the region runs as it is."""
    logdir = logdir or os.environ.get("VNLB_TPU_PROFILE", "")
    if not logdir:
        yield
        return
    import torch
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
