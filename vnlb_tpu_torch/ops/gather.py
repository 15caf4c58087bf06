"""Patch-group gather straight from the YUV video at the top-K corners.

``inds_to_rows`` is vnlb_tpu/ops/gather.py:142-155.  The JAX package
gathers from an unfolded patch-column arena built with one-hot
convolutions (pt-fused and lane-joined on the TPU); those are TPU layout
devices.  Here each patch is indexed directly in the video, which gives the
same values: the patch at corner (f, y, x) holds V[f+j, c, y+dy, x+dx].
With ``cols_bf16`` the values round to bf16 and return to f32, as the JAX
arena's do.
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


def patch_offsets(shape, ps: int, pt: int, device) -> torch.Tensor:
    """(C, pt*ps*ps) flat video offsets of a patch's pixels from its corner,
    in c-major (c, j, dy, dx) order."""
    t_len, c, h, w = shape
    ci = torch.arange(c, device=device)[:, None, None, None]
    j = torch.arange(pt, device=device)[None, :, None, None]
    dy = torch.arange(ps, device=device)[None, None, :, None]
    dx = torch.arange(ps, device=device)[None, None, None, :]
    off = (j * c + ci) * (h * w) + dy * w + dx
    return off.reshape(c, pt * ps * ps)


def gather_patches(video: torch.Tensor, f: torch.Tensor, y: torch.Tensor,
                   x: torch.Tensor, ps: int, pt: int, bf16: bool
                   ) -> torch.Tensor:
    """(T, C, H, W) video + (B, K) corners -> (B, K, C, pt*ps*ps) c-major
    patch rows in f32 (bf16-rounded when ``bf16``)."""
    shape = video.shape
    t_len, c, h, w = shape
    base = f * (c * h * w) + y * w + x                       # (B, K)
    off = patch_offsets(shape, ps, pt, video.device)          # (C, p)
    idx = base[:, :, None, None] + off[None, None]
    out = video.reshape(-1)[idx]
    if bf16:
        out = out.to(torch.bfloat16).to(torch.float32)
    return out
