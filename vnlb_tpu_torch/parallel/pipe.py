"""The two passes pipelined over temporal chunks on two devices
(vnlb_tpu/parallel/pipe.py, the ``devices=`` path).

Pass 1 (basic) runs chunk j on the first device while pass 2 (final) runs
the newest chunk whose basic context is final on the second.  The windows
are ``denoise_streaming``'s (``streaming.windows``, ``pass_ctx``) and pass
2 reads the same finalized basic frames, so the output equals
``denoise_streaming`` on the same chunking bit for bit.  The lag, L =
ceil(ctx2 / chunk) chunks, is the smallest offset at which every basic
frame pass 2 needs is final.  Pass-1 chunk j+1 is queued before chunk j is
copied back, so the copy overlaps the next chunk where the device runs
ahead of the host.  With one card both devices are ``cuda:0``.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import VnlbConfig, default_config
from ..streaming import host_inputs, pass_ctx, window_pass, windows
from ..utils.precision import full_f32


@full_f32()
def denoise_pipelined(noisy, sigma: float, chunk: int = 12, flows=None,
                      preset: str = "iphone",
                      cfg: Optional[VnlbConfig] = None, devices=None,
                      meshes=None, verbose: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Two-pass denoising with pass 1 on ``devices[0]`` and pass 2 on
    ``devices[1]`` (default: the first two CUDA devices, or ``cuda:0``
    twice).  Returns (deno, basic, seconds) as host numpy arrays, equal to
    ``denoise_streaming(noisy, sigma, chunk=chunk, ...)``."""
    if meshes is not None:
        raise NotImplementedError(
            "vnlb_tpu_torch does not run denoise_pipelined(meshes=...) yet "
            "(ROADMAP.md, item 17: two disjoint process groups from one "
            "controller)")
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
