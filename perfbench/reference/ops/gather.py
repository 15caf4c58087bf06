"""Top-K index decoding (vnlb_tpu/ops/gather.py:142-155).

The JAX package gathers patch groups from an unfolded patch-column arena
built with one-hot convolutions (pt-fused and lane-joined on the TPU);
those are TPU layout devices.  The port reads each patch directly from the
video at its decoded corner: kernel K4 (ops/patch_gather.py).
"""

from __future__ import annotations

import torch


def decode_corners(inds: torch.Tensor, shape, ps: int, pt: int):
    """Flat indices -> clipped patch corners (f, y, x), int64; -1 decodes
    as index 0 (callers mask it)."""
    t_len, c, h, w = shape
    hp, wp = h - ps + 1, w - ps + 1
    chw, hw = c * h * w, h * w
    safe = torch.clamp(inds.long(), min=0)
    f = torch.clamp(safe // chw, 0, t_len - pt)
    y = torch.clamp((safe % hw) // w, 0, hp - 1)
    x = torch.clamp(safe % w, 0, wp - 1)
    return f, y, x


def inds_to_rows(inds: torch.Tensor, shape, ps: int, pt: int) -> torch.Tensor:
    """Flat image indices -> (B, K, pt) rows of the flattened (T, H', W')
    patch-corner space (frame f+j, same corner)."""
    t_len, c, h, w = shape
    hp, wp = h - ps + 1, w - ps + 1
    f, y, x = decode_corners(inds, shape, ps, pt)
    base = f * (hp * wp) + y * wp + x
    dt = torch.arange(pt, device=inds.device) * (hp * wp)
    return base[:, :, None] + dt[None, None, :]
