"""Flat-area detection (vnlb_tpu/ops/flat.py): a patch group is flat when
the channel mean of the unbiased variance of its pixels is below
``gamma * sigma^2``."""

from __future__ import annotations

import torch


def flat_areas(pnoisy: torch.Tensor, gamma: float, sigma2: float
               ) -> torch.Tensor:
    """(B, K, c, p) c-major noisy patch rows -> (B,) bool flat flags."""
    b, k, c, p = pnoisy.shape
    x = pnoisy.to(torch.float32)
    z = k * p
    psum = x.sum(dim=(1, 3))
    psum2 = (x * x).sum(dim=(1, 3))
    var = (psum2 - psum * psum / z) / (z - 1)
    return var.mean(dim=1) < (gamma * sigma2)
