"""Public API: ``denoise`` and ``denoise_streaming`` (vnlb_tpu/api.py:28-167)."""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .config import VnlbConfig, default_config
from .pipeline import KERNELS, Kernels, proc_nl
from .utils.flow_io import expand_flows


def _as_video(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _prep_flows(noisy_shape, flows, device="cpu"):
    """(fflow, bflow, zero_flow) for ``denoise`` (vnlb_tpu/api.py:28-50):
    ``flows`` is None (zero flow), a (fflow, bflow) pair or a dict with
    those keys, each (T, 2, H, W) or (T-1, 2, H, W); (T-1)-frame stacks are
    edge-replicated to T frames.  The flows come back as f32 tensors on
    ``device``; the flag says whether both are all zero."""
    t, _, h, w = noisy_shape
    if flows is None:
        z = torch.zeros((t, 2, h, w), dtype=torch.float32, device=device)
        return z, z, True
    if isinstance(flows, dict):
        fflow, bflow = flows["fflow"], flows["bflow"]
    else:
        fflow, bflow = flows
    fflow = np.asarray(fflow.cpu() if isinstance(fflow, torch.Tensor)
                       else fflow, np.float32)
    bflow = np.asarray(bflow.cpu() if isinstance(bflow, torch.Tensor)
                       else bflow, np.float32)
    if fflow.shape[0] == t - 1:
        fflow, bflow = expand_flows(fflow, bflow)
    if fflow.shape[0] != t or bflow.shape[0] != t:
        raise ValueError(f"flows must have {t} or {t - 1} frames")
    zero = bool(not fflow.any() and not bflow.any())
    return (torch.as_tensor(fflow, device=device),
            torch.as_tensor(bflow, device=device), zero)


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
    # full f32 matrix products everywhere the port runs (the plain
    # versions use torch.bmm)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or default_config(sigma, preset=preset)
    noisy_t = _as_video(noisy, device)
    fflow, bflow, zf = _prep_flows(tuple(noisy_t.shape), flows, device)
    clean_t = None if clean is None else _as_video(clean, device)
    basic = proc_nl(noisy_t, None, clean_t, fflow, bflow, cfg.stage(0),
                    zero_flow=zf, kernels=kernels)
    deno = proc_nl(noisy_t, basic, clean_t, fflow, bflow, cfg.stage(1),
                   zero_flow=zf, kernels=kernels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return deno, basic, time.perf_counter() - t0


def denoise_streaming(noisy, sigma: float, chunk: int = 12, flows=None,
                      preset: str = "iphone",
                      cfg: Optional[VnlbConfig] = None, mesh=None,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray, float]:
    """Two-pass denoising of a long clip in bounded device memory
    (vnlb_tpu/api.py:86-167, the single-device branch).

    Each pass streams over temporal chunks of ``chunk`` output frames, each
    run in a fixed window of ``chunk + 2*ctx`` frames, ``ctx = 2*max(nwt)
    + pt - 1``: an output frame takes deposits from sites up to nwt + pt -
    1 frames away, whose windows reach as far again, so every contributing
    site sees what it sees in the whole-clip run.  Pass 1 is assembled on
    the host before pass 2 streams over it; each window's lattice is
    anchored to global frame indices (``proc_nl(..., t_origin)``).  The
    device holds one window at a time; outputs match ``denoise`` up to the
    summation order of the scatter.

    ``mesh`` (spatial sharding across cards) is not ported.  Returns
    (deno, basic, seconds) as host numpy arrays.
    """
    if mesh is not None:
        raise NotImplementedError(
            "vnlb_tpu_torch does not run denoise_streaming(mesh=...) yet "
            "(ROADMAP.md, item 15: the K1 tile entry with parallel/)")
    t0 = time.perf_counter()
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    noisy = np.asarray(noisy.cpu() if isinstance(noisy, torch.Tensor)
                       else noisy, np.float32)
    t_len = noisy.shape[0]
    cfg = cfg or default_config(sigma, preset=preset)
    fflow, bflow, zflow = _prep_flows(noisy.shape, flows)
    fflow, bflow = fflow.numpy(), bflow.numpy()

    def stream_pass(scfg, basic_full):
        ctx = 2 * max(scfg.nwt_b, scfg.nwt_f) + scfg.pt - 1
        out = np.empty_like(noisy)
        win = min(t_len, chunk + 2 * ctx)
        for start in range(0, t_len, chunk):
            stop = min(start + chunk, t_len)
            # a fixed window that covers [start, stop); extra context only
            # widens the exact-match region
            lo = max(0, min(start - ctx, t_len - win))
            hi = lo + win
            nz = torch.from_numpy(noisy[lo:hi]).to(device)
            bs = (None if basic_full is None
                  else torch.from_numpy(basic_full[lo:hi]).to(device))
            ff, bf = ((None, None) if zflow else
                      (torch.from_numpy(fflow[lo:hi]).to(device),
                       torch.from_numpy(bflow[lo:hi]).to(device)))
            o = proc_nl(nz, bs, None, ff, bf, scfg, zero_flow=zflow,
                        t_origin=lo)
            out[start:stop] = o[start - lo:stop - lo].cpu().numpy()
        return out

    basic = stream_pass(cfg.stage(0), None)
    deno = stream_pass(cfg.stage(1), basic)
    return deno, basic, time.perf_counter() - t0
