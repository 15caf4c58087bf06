"""The two passes pipelined over temporal chunks (vnlb_tpu/parallel/pipe.py).

Both paths use the windowed composition's windows (``streaming.windows``,
``pass_ctx``), and pass 2 reads the same finalized basic frames, so the
output equals that composition (``streaming.window_stream`` of
``window_pass``, as ``denoise_streaming(mesh=...)`` runs it) on the same
chunking bit for bit.  A
pass-2 window starts once every basic frame it reads is final
(``schedule``): in steady state L = ceil(ctx2 / chunk) pass-1 chunks
later, the smallest such lag.

``devices=(d0, d1)``: one process runs pass 1 on ``d0`` and pass 2 on
``d1``.  Pass-1 chunk j+1 is queued before chunk j is copied back, so the
copy overlaps the next chunk where the device runs ahead of the host.
With one card both devices are ``cuda:0``.

``meshes=(mesh1, mesh2)``: the PP x SP composition, an SPMD call on every
rank of one ``torch.distributed`` world.  ``stage_meshes`` splits the world
into two stage groups: world ranks [0, n1) run pass 1 halo-sharded over H
(``halo.proc_nl_halo`` on ``mesh1``), ranks [n1, n1 + n2) run pass 2 the
same way on ``mesh2``, both at once.  The edge between the stages: every
stage-1 rank holds each finalized basic chunk whole, and stage-2 rank i
receives it from stage-1 rank i mod n1 by a point-to-point ``isend`` over
the default group, so stage 1 goes on to its next window while the frames
travel.  The transport is ``comm``'s: gloo staged through host memory,
CUDA tensors directly under NCCL.  At the end stage 2's output is
broadcast, and every rank returns the same (deno, basic, seconds).  Each
stage runs ``denoise_streaming(mesh=...)``'s program for its pass on a
group of its size, so the output equals that of ``denoise_streaming`` over
an n-rank mesh (n1 = n2 = n) bit for bit, at equal torch thread counts.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import VnlbConfig, default_config
from ..streaming import host_inputs, pass_ctx, window_pass, windows
from ..utils.precision import full_f32
from .comm import Mesh, make_mesh


def schedule(w1, w2):
    """For each pass-1 window, the pass-2 windows [i, ...] that may start
    once its frames [start, stop) are final: window i (start, stop, lo, hi)
    needs every basic frame below hi (vnlb_tpu/parallel/pipe.py:135)."""
    out, i = [], 0
    for _, stop, _, _ in w1:
        ready = []
        while i < len(w2) and stop >= w2[i][3]:
            ready.append(i)
            i += 1
        out.append(ready)
    return out


def stage_meshes(mesh: Mesh, sizes=(2, 2)) -> Tuple[Mesh, Mesh]:
    """Split the world of ``mesh`` (a ``Mesh`` over the default group) into
    the two pipeline stages: world ranks [0, n1) and [n1, n1 + n2).

    Every rank calls this (``dist.new_group`` is collective over the world,
    both groups in the same order).  Returns (mesh1, mesh2): the rank's own
    stage carries its rank in that group, the other stage rank -1."""
    n1, n2 = (int(s) for s in sizes)
    if n1 < 1 or n2 < 1:
        raise ValueError(f"stage sizes {sizes}: each stage needs a rank")
    if n1 + n2 != mesh.size:
        raise ValueError(f"stage sizes {sizes} do not add up to the world "
                         f"of {mesh.size} ranks")
    out = []
    for lo, n in ((0, n1), (n1, n2)):
        group = dist.new_group(ranks=list(range(lo, lo + n)))
        mine = lo <= mesh.rank < lo + n
        out.append(Mesh(group, mesh.rank - lo if mine else -1, n,
                        mesh.device, mesh.axis))
    return out[0], out[1]


@full_f32()
def denoise_pipelined(noisy, sigma: float, chunk: int = 12, flows=None,
                      preset: str = "iphone",
                      cfg: Optional[VnlbConfig] = None, devices=None,
                      meshes=None, verbose: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Two-pass denoising with the passes pipelined over temporal chunks.

    ``devices``: pass 1 on ``devices[0]`` and pass 2 on ``devices[1]``
    (default: the first two CUDA devices, or ``cuda:0`` twice).
    ``meshes``: a (mesh1, mesh2) pair from ``stage_meshes``, called on
    every rank of the world; each pass runs halo-sharded over its stage's
    group.  Overrides ``devices``.

    Returns (deno, basic, seconds) as host numpy arrays, equal to the
    windowed composition of ``streaming.window_stream`` on the same
    chunking (with ``meshes``: ``denoise_streaming(..., mesh=...)`` over a
    mesh of the stages' size), the same on every rank.
    """
    if meshes is not None:
        return _over_meshes(noisy, sigma, chunk, flows, preset, cfg, meshes,
                            verbose)[:3]
    t0 = time.perf_counter()
    noisy, fflow, bflow, zflow = host_inputs(noisy, flows)
    t_len = noisy.shape[0]
    cfg = cfg or default_config(sigma, preset=preset)
    s0, s1 = cfg.stage(0), cfg.stage(1)
    if devices is None:
        n = torch.cuda.device_count()
        devices = ("cuda:0", f"cuda:{1 % max(n, 1)}")
    d0, d1 = (torch.device(d) for d in devices)

    w1 = windows(t_len, chunk, pass_ctx(s0))
    w2 = windows(t_len, chunk, pass_ctx(s1))
    basic = np.empty_like(noisy)
    deno = np.empty_like(noisy)
    basic_final = -1                   # highest finalized basic frame + 1
    p1_pending, p2_pending = [], []

    def dispatch_p1(j):
        _, _, lo, hi = w1[j]
        p1_pending.append((j, window_pass(s0, noisy, None, fflow, bflow,
                                          zflow, lo, hi, d0)))

    def drain_p1():
        nonlocal basic_final
        j, o = p1_pending.pop(0)
        start, stop, lo, _ = w1[j]
        basic[start:stop] = o[start - lo:stop - lo].cpu().numpy()
        basic_final = stop
        if verbose:
            print(f"[pipe] pass 1 chunk {j} final (frames {start}:{stop})")

    def dispatch_p2(i):
        _, _, lo, hi = w2[i]
        p2_pending.append((i, window_pass(s1, noisy, basic, fflow, bflow,
                                          zflow, lo, hi, d1)))

    def drain_p2():
        i, o = p2_pending.pop(0)
        start, stop, lo, _ = w2[i]
        deno[start:stop] = o[start - lo:stop - lo].cpu().numpy()
        if verbose:
            print(f"[pipe] pass 2 chunk {i} final (frames {start}:{stop})")

    p2_next = 0
    for j in range(len(w1)):
        dispatch_p1(j)                 # queue j before copying j-1 back
        if j >= 1:
            drain_p1()
        while p2_next < len(w2) and basic_final >= w2[p2_next][3]:
            dispatch_p2(p2_next)
            p2_next += 1
        while len(p2_pending) > 1:     # bounded in-flight memory
            drain_p2()
    while p1_pending:
        drain_p1()
    while p2_next < len(w2):           # tail chunks (basic now complete)
        dispatch_p2(p2_next)
        p2_next += 1
    while p2_pending:
        drain_p2()
    return deno, basic, time.perf_counter() - t0


def _over_meshes(noisy, sigma, chunk, flows, preset, cfg, meshes, verbose):
    """The ``meshes=`` path on this rank: (deno, basic, seconds, stats).
    ``stats``: this rank's stage, its busy seconds (its pass's windows,
    output copied to the host), and the bytes it moved across the stage
    edge with the seconds it spent on them (stage 1: staging, posting and
    the final wait of its sends; stage 2: waiting for basic chunks)."""
    from .halo import proc_nl_halo

    t0 = time.perf_counter()
    noisy, fflow, bflow, _ = host_inputs(noisy, flows)
    cfg = cfg or default_config(sigma, preset=preset)
    s0, s1 = cfg.stage(0), cfg.stage(1)
    mesh1, mesh2 = meshes
    n1 = mesh1.size
    w1 = windows(noisy.shape[0], chunk, pass_ctx(s0))
    w2 = windows(noisy.shape[0], chunk, pass_ctx(s1))
    basic = np.empty_like(noisy)
    deno = np.empty_like(noisy)
    mine = mesh1 if mesh1.rank >= 0 else mesh2
    # the edge's transport: CUDA tensors under NCCL, host memory otherwise
    wire = (mine.device if dist.get_backend() == "nccl"
            else torch.device("cpu"))
    stats = dict(stage=1 if mine is mesh1 else 2, busy_s=0.0, edge_bytes=0,
                 edge_s=0.0)

    def run(scfg, mesh, basic_full, win, out, idx):
        start, stop, lo, hi = win
        t = time.perf_counter()
        o = proc_nl_halo(noisy[lo:hi], None if basic_full is None
                         else basic_full[lo:hi], fflow[lo:hi], bflow[lo:hi],
                         scfg, mesh, t_origin=lo)[start - lo:stop - lo]
        out[start:stop] = o.cpu().numpy()
        stats["busy_s"] += time.perf_counter() - t
        if verbose and mesh.rank == 0:
            print(f"[pipe] pass {scfg.step + 1} chunk {idx} final (frames "
                  f"{start}:{stop})")
        return o

    if mine is mesh1:
        peers = [n1 + i for i in range(mesh2.size) if i % n1 == mesh1.rank]
        sends = []
        for j, win in enumerate(w1):
            o = run(s0, mesh1, None, win, basic, j)
            t = time.perf_counter()
            buf = (o.contiguous() if wire.type == "cuda"
                   else torch.from_numpy(basic[win[0]:win[1]]))
            for p in peers:
                sends.append((dist.isend(buf, p, tag=j), buf))
                stats["edge_bytes"] += buf.numel() * buf.element_size()
            stats["edge_s"] += time.perf_counter() - t
        t = time.perf_counter()
        for req, _ in sends:
            req.wait()
        stats["edge_s"] += time.perf_counter() - t
    else:
        src = mesh2.rank % n1
        recvs = []
        for j, (start, stop, _, _) in enumerate(w1):
            buf = (torch.empty(basic[start:stop].shape, device=wire)
                   if wire.type == "cuda"
                   else torch.from_numpy(basic[start:stop]))
            recvs.append((dist.irecv(buf, src, tag=j), buf))
        for j, ready in enumerate(schedule(w1, w2)):
            t = time.perf_counter()
            req, buf = recvs[j]
            req.wait()
            if wire.type == "cuda":
                basic[w1[j][0]:w1[j][1]] = buf.cpu().numpy()
            stats["edge_bytes"] += buf.numel() * buf.element_size()
            stats["edge_s"] += time.perf_counter() - t
            for i in ready:
                run(s1, mesh2, basic, w2[i], deno, i)

    out = torch.from_numpy(deno).to(wire)
    dist.broadcast(out, src=n1)
    deno = out.cpu().numpy()
    secs = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                        device=wire)
    dist.all_reduce(secs, op=dist.ReduceOp.MAX)
    return deno, basic, float(secs.item()), stats


@full_f32()
def pipelined_world(noisy, sigma: float, mesh: Optional[Mesh] = None,
                    sizes=(2, 2), chunk: int = 12, flows=None,
                    preset: str = "iphone", cfg: Optional[VnlbConfig] = None,
                    verbose: bool = False):
    """``denoise_pipelined(meshes=stage_meshes(mesh, sizes))`` on this rank
    of the world, as ``launch.run_world`` starts it (``mesh``: this rank's
    ``Mesh`` over the default group).  Returns (deno, basic, seconds,
    stats) with this rank's ``stats`` (its stage, busy and edge seconds,
    edge bytes)."""
    return _over_meshes(noisy, sigma, chunk, flows, preset, cfg,
                        stage_meshes(mesh or make_mesh(), sizes), verbose)
