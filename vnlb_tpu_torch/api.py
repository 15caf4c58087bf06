"""Public API (vnlb_tpu/api.py): ``denoise``, ``denoise_streaming``,
``denoise_mod`` and the cached-result readers ``proc_nl_cache`` and
``proc_nn``, with the JAX package's arguments in its order; ``device``
(and ``kernels``) follow them."""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .config import VnlbConfig, default_config
from .pipeline import KERNELS, Kernels, as_video, prep_flows, proc_nl
from .streaming import host_inputs, pass_ctx, window_pass, windows
from .utils.precision import full_f32
from .utils.timer import span


@full_f32()
def denoise(noisy, sigma: float, flows=None, clean=None,
            preset: str = "iphone", cfg: Optional[VnlbConfig] = None,
            verbose: bool = False, gpuid: int = 0, device="cuda",
            kernels: Kernels = KERNELS
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
      verbose: print the preset and sigma, as ``vnlb_tpu.denoise`` does.
      gpuid: accepted and ignored, for drop-in compatibility with
        ``vnlb_tpu.denoise`` (which ignores it too); ``device`` picks the
        card.
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
    cfg = cfg or default_config(sigma, preset=preset, verbose=verbose)
    with span("vnlb.sync.inputs"):
        noisy_t = as_video(noisy, device)
        fflow, bflow, zf = prep_flows(tuple(noisy_t.shape), flows, device)
        clean_t = None if clean is None else as_video(clean, device)
    if verbose:
        print(f"[vnlb_tpu_torch] preset={cfg.preset} sigma={sigma}")
    basic = proc_nl(noisy_t, None, clean_t, fflow, bflow, cfg.stage(0),
                    zero_flow=zf, kernels=kernels)
    deno = proc_nl(noisy_t, basic, clean_t, fflow, bflow, cfg.stage(1),
                   zero_flow=zf, kernels=kernels)
    if device.type == "cuda":
        with span("vnlb.sync.call_end"):
            torch.cuda.synchronize(device)
    return deno, basic, time.perf_counter() - t0


@full_f32()
def denoise_streaming(noisy, sigma: float, chunk: int = 12, flows=None,
                      preset: str = "iphone",
                      cfg: Optional[VnlbConfig] = None, mesh=None,
                      verbose: bool = False, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
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
    not used).  ``verbose`` prints one line per window, as
    ``vnlb_tpu.denoise_streaming`` does.  Returns (deno, basic, seconds)
    as host numpy arrays.
    """
    t0 = time.perf_counter()
    device = torch.device(device)
    noisy, fflow, bflow, zflow = host_inputs(noisy, flows)
    t_len = noisy.shape[0]
    cfg = cfg or default_config(sigma, preset=preset, verbose=verbose)
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
            if verbose:
                print(f"[vnlb_tpu_torch] pass {scfg.step} streamed frames "
                      f"{start}:{stop} (ctx {lo}:{hi})")
        return out

    basic = stream_pass(cfg.stage(0), None)
    deno = stream_pass(cfg.stage(1), basic)
    return deno, basic, time.perf_counter() - t0


@full_f32()
def denoise_mod(noisy, sigma: float, flows=None, clean=None,
                verbose: bool = False, gpuid: int = 0, device="cuda",
                kernels: Kernels = KERNELS
                ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The variant pipeline of ``vnlb_tpu.denoise_mod``
    (vnlb_tpu/api.py:170-207), preset ``iphone``:

    1. an averaging warm start (K=10, search on noisy, ``deno="ave"``);
    2. three damped ``"ave"`` iterations (alpha=0.75, K=2, search on
       basic);
    3. a Bayes pass with K=100 searching on basic;
    4. the final second-stage pass (K=60, gamma=0.2, cpatches=basic).

    ``gpuid`` is accepted and ignored, as in ``denoise``.  Returns (deno,
    basic, seconds) on ``device``; seconds ends after a device
    synchronize.
    """
    t0 = time.perf_counter()
    device = torch.device(device)
    cfg = default_config(sigma, preset="iphone", verbose=verbose)
    with span("vnlb.sync.inputs"):
        noisy_t = as_video(noisy, device)
        fflow, bflow, zf = prep_flows(tuple(noisy_t.shape), flows, device)
        clean_t = None if clean is None else as_video(clean, device)

    def run(basic, scfg):
        return proc_nl(noisy_t, basic, clean_t, fflow, bflow, scfg,
                       zero_flow=zf, kernels=kernels)

    s0 = cfg.stage(0)
    basic = run(None, s0.replace(npatches=10, srch_img="noisy",
                                 cpatches="noisy", deno="ave"))
    alpha = 0.75
    for _ in range(3):
        basic = alpha * basic + (1 - alpha) * noisy_t
        basic = run(basic, s0.replace(npatches=2, srch_img="basic",
                                      cpatches="noisy", deno="ave"))
    basic = run(basic, s0.replace(npatches=100, srch_img="basic",
                                  cpatches="noisy", deno="bayes"))
    deno = run(basic, cfg.stage(1).replace(npatches=60, gamma=0.2,
                                           cpatches="basic"))
    if device.type == "cuda":
        with span("vnlb.sync.call_end"):
            torch.cuda.synchronize(device)
    return deno, basic, time.perf_counter() - t0


def proc_nl_cache(vid_set, vid_name, sigma):
    """A cached denoised sequence (vnlb_tpu/api.py:210-215), read from the
    result cache both packages share (``VNLB_TPU_CACHE``, else
    ``~/.cache/vnlb_tpu``); None when absent."""
    from .utils.video_io import read_nl_sequence

    return read_nl_sequence(vid_set, vid_name, sigma)


def proc_nn(model: str, vid_set, vid_name, sigma):
    """Cached outputs of a neural denoiser, ``"udvd"`` or ``"pacnet"``, or
    of ``"vnlb"`` (vnlb_tpu/api.py:218-228); None when absent."""
    from .utils import video_io

    readers = {"udvd": video_io.read_udvd_sequence,
               "pacnet": video_io.read_pacnet_sequence,
               "vnlb": video_io.read_nl_sequence}
    if model not in readers:
        raise ValueError(f"unknown nn model [{model}]")
    return readers[model](vid_set, vid_name, sigma)
