"""Public API: ``denoise`` (vnlb_tpu/api.py:28-83)."""

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
