"""Public API: ``denoise`` (vnlb_tpu/api.py:53-83), zero flow."""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .config import VnlbConfig, default_config
from .pipeline import KERNELS, Kernels, proc_nl


def _as_video(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _check_zero_flow(flows) -> None:
    if flows is None:
        return
    pair = (flows["fflow"], flows["bflow"]) if isinstance(flows, dict) \
        else flows
    if any(np.any(np.asarray(f)) for f in pair):
        raise NotImplementedError(
            "vnlb_tpu_torch does not run nonzero flow yet (ROADMAP.md, "
            "item 8: slide borders and flow search)")


def denoise(noisy, sigma: float, flows=None, clean=None,
            preset: str = "iphone", cfg: Optional[VnlbConfig] = None,
            device="cuda", kernels: Kernels = KERNELS
            ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Video Non-Local Bayes denoising (two passes).

    Args:
      noisy: (T, 3, H, W) RGB video on the [0, 255] scale (numpy or torch).
      sigma: noise standard deviation on the [0, 255] scale.
      flows: None (zero flow) or an all-zero (fflow, bflow) pair / dict.
      clean: optional clean video, searched when ``srch_img="clean"``.
      preset/cfg: a named preset or a full ``VnlbConfig``.
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
    _check_zero_flow(flows)
    cfg = cfg or default_config(sigma, preset=preset)
    noisy_t = _as_video(noisy, device)
    clean_t = None if clean is None else _as_video(clean, device)
    basic = proc_nl(noisy_t, None, clean_t, cfg.stage(0), kernels=kernels)
    deno = proc_nl(noisy_t, basic, clean_t, cfg.stage(1), kernels=kernels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return deno, basic, time.perf_counter() - t0
