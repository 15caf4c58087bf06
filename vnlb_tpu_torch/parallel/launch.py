"""Start a ``torch.distributed`` world on this host and run one function
on every rank.

    from vnlb_tpu_torch.parallel.launch import run_world
    outs = run_world(denoise_halo, 2, args=(noisy, 20.0), device="cuda:0")

Each rank is a process started with the ``spawn`` method; the ranks meet
through a ``file://`` store in a temporary directory (no network), so the
function must be importable by module (a function of this package, never
one defined in a test module).  Under gloo the ranks talk over the
loopback interface.  Several ranks may share one device (``device=``);
NCCL refuses two ranks on one GPU, so such a world runs on gloo.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..pipeline import KERNELS
from .comm import make_mesh


def _to_host(obj):
    """Tensors -> numpy arrays, through tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, fn, n, backend, device, threads, args, kwargs, tmp,
               timeout):
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = fn(*args, mesh=make_mesh(device=dev), **kwargs)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(_to_host(out), f)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, n: int, args=(), kwargs=None,
              backend: str = "gloo", device=None,
              threads: Optional[int] = None, timeout: float = 1800.0):
    """Run ``fn(*args, mesh=mesh, **kwargs)`` on each rank of a new world
    of ``n`` processes and return the list of their results (tensors come
    back as numpy arrays).  ``device``: every rank's device (default
    ``cuda:<rank>``); ``threads``: torch threads per rank.  A rank that
    raises makes this raise (the other ranks are stopped)."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, n, backend, device, threads, args,
                                 kwargs or {}, tmp, timeout),
                           nprocs=n, join=True, start_method="spawn")
        outs = []
        for rank in range(n):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return outs


def sequence(calls, mesh):
    """Run ``[(fn, args, kwargs), ...]`` in order on this rank (one world
    for several programs): [(result, wall seconds, launches)], each wall
    ended after a device synchronize; ``launches`` maps the name of each
    kernel wrapper of ``pipeline.KERNELS`` to the launches of that call
    (every count is set to 0 before it)."""
    outs = []
    for fn, a, kw in calls:
        for k in KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        out = fn(*a, mesh=mesh, **kw)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        outs.append((out, time.perf_counter() - t0,
                     {k.__name__: k.launches for k in KERNELS}))
    return outs
