"""Public API: ``denoise`` and ``denoise_streaming`` (vnlb_tpu/api.py:28-167)."""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .config import VnlbConfig, default_config
from .pipeline import KERNELS, Kernels, as_video, prep_flows, proc_nl
from .streaming import host_inputs, pass_ctx, window_pass, windows
from .utils.precision import full_f32


@full_f32()
def denoise(noisy, sigma: float, flows=None, clean=None,
            preset: str = "iphone", cfg: Optional[VnlbConfig] = None,
            device="cuda", kernels: Kernels = KERNELS
            ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Video Non-Local Bayes denoising (two passes).

    Args:
      noisy: (T, 3, H, W) RGB video on the [0, 255] scale (numpy or torch).
      sigma: noise standard deviation on the [0, 255] scale.
      flows: None (zero flow), or a (fflow, bflow) pair or dict of optical
        flows, each (T, 2, H, W) or (T-1, 2, H, W), u (x) then v (y).
      clean: optional clean video, searched when ``srch_img="clean"``.
      preset/cfg: a named preset or a full ``VnlbConfig``; the default is
        the JAX API default (preset ``iphone``: step_s 3, sliding borders,
        needle search in the first pass, poly filter, exact top-K).
      device: where the passes run ("cuda" by default; the tests pass
        "cpu", where every kernel takes its plain version).
      kernels: the kernel functions of the passes (``pipeline.KERNELS``
        dispatches by device; ``pipeline.PLAIN`` runs the plain versions).

    Returns (deno, basic, seconds) with deno and basic on ``device``;
    seconds is the wall time of the call, ended after a device
    synchronize.
    """
    t0 = time.perf_counter()
    device = torch.device(device)
    cfg = cfg or default_config(sigma, preset=preset)
    noisy_t = as_video(noisy, device)
    fflow, bflow, zf = prep_flows(tuple(noisy_t.shape), flows, device)
    clean_t = None if clean is None else as_video(clean, device)
    basic = proc_nl(noisy_t, None, clean_t, fflow, bflow, cfg.stage(0),
                    zero_flow=zf, kernels=kernels)
    deno = proc_nl(noisy_t, basic, clean_t, fflow, bflow, cfg.stage(1),
                   zero_flow=zf, kernels=kernels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return deno, basic, time.perf_counter() - t0


@full_f32()
def denoise_streaming(noisy, sigma: float, chunk: int = 12, flows=None,
                      preset: str = "iphone",
                      cfg: Optional[VnlbConfig] = None, mesh=None,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray, float]:
    """Two-pass denoising of a long clip in bounded device memory
    (vnlb_tpu/api.py:86-167).

    Each pass streams over temporal chunks of ``chunk`` output frames, each
    run in a fixed window of ``chunk + 2*ctx`` frames
    (``streaming.pass_ctx``), so every contributing site sees what it sees
    in the whole-clip run.  Pass 1 is assembled on the host before pass 2
    streams over it; each window's lattice is anchored to global frame
    indices (``proc_nl(..., t_origin)``).  The device holds one window at a
    time; outputs match ``denoise`` up to the summation order of the
    scatter.

    ``mesh`` (a ``parallel.comm.Mesh``): every rank of the world calls this
    with the whole clip, and each window runs ``parallel.halo.proc_nl_halo``
    split over H across the mesh, on the mesh's device (``device`` is then
    not used).  Returns (deno, basic, seconds) as host numpy arrays.
    """
    t0 = time.perf_counter()
    device = torch.device(device)
    noisy, fflow, bflow, zflow = host_inputs(noisy, flows)
    t_len = noisy.shape[0]
    cfg = cfg or default_config(sigma, preset=preset)
    if mesh is not None:
        from .parallel.halo import proc_nl_halo

    def stream_pass(scfg, basic_full):
        out = np.empty_like(noisy)
        for start, stop, lo, hi in windows(t_len, chunk, pass_ctx(scfg)):
            if mesh is None:
                o = window_pass(scfg, noisy, basic_full, fflow, bflow, zflow,
                                lo, hi, device)
            else:
                o = proc_nl_halo(noisy[lo:hi], None if basic_full is None
                                 else basic_full[lo:hi], fflow[lo:hi],
                                 bflow[lo:hi], scfg, mesh, t_origin=lo)
            out[start:stop] = o[start - lo:stop - lo].cpu().numpy()
        return out

    basic = stream_pass(cfg.stage(0), None)
    deno = stream_pass(cfg.stage(1), basic)
    return deno, basic, time.perf_counter() - t0
