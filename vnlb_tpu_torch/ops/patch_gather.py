"""K4: the patch-group gather at the top-K corners as a CUDA kernel
(csrc/patch_gather.cu).

For top-K flat indices ``inds`` (B, K) int32 (-1 decodes as index 0; the
pipeline masks those rows) and one or two (T, C, H, W) videos, each output
is (B, K, C, pt*ps*ps) f32 in c-major order:

    out[b, k, c, j*ps*ps + dy*ps + dx] = V[f+j, c, y+dy, x+dx]

at the clipped corner (f, y, x) of ``gather.decode_corners``.  This is the
function of the JAX package's ``fill_patches_cols`` and
``fill_patches_cols_joint`` (vnlb_tpu/ops/gather.py:158-239), which gather
rows of a patch-column arena; the port reads the video directly.  With
``bf16`` each value rounds to bf16 and back, as the JAX bf16 arena's do.
Two videos (the second pass's noisy and basic) are read at the same
corners in one call.

``patch_gather`` dispatches by device: CPU tensors take the plain version
``patch_gather_plain``; CUDA tensors launch the kernel, and a build or
launch failure raises.  ``patch_gather.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import _build
from .gather import decode_corners

__all__ = ["patch_gather", "patch_gather_plain", "patch_gather_kernel"]


def _check(videos, inds):
    if len(videos) not in (1, 2):
        raise ValueError(f"one or two videos, got {len(videos)}")
    shape = videos[0].shape
    for v in videos:
        if v.dim() != 4 or v.dtype != torch.float32 or v.shape != shape:
            raise ValueError(f"videos must be (T, C, H, W) float32 of one "
                             f"shape, got {tuple(v.shape)} {v.dtype}")
    if inds.dim() != 2:
        raise ValueError(f"inds must be (B, K), got {tuple(inds.shape)}")


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


def patch_gather_plain(videos: Sequence[torch.Tensor], inds: torch.Tensor,
                       ps: int, pt: int, bf16: bool) -> List[torch.Tensor]:
    """Plain PyTorch version: one int64 (B, K, C, pt*ps*ps) index into the
    flattened video, shared by both videos."""
    _check(videos, inds)
    shape = videos[0].shape
    t_len, c, h, w = shape
    f, y, x = decode_corners(inds, shape, ps, pt)
    base = f * (c * h * w) + y * w + x                        # (B, K)
    off = patch_offsets(shape, ps, pt, inds.device)            # (C, p)
    idx = base[:, :, None, None] + off[None, None]
    outs = []
    for v in videos:
        out = v.reshape(-1)[idx]
        if bf16:
            out = out.to(torch.bfloat16).to(torch.float32)
        outs.append(out)
    return outs


def patch_gather_kernel(videos: Sequence[torch.Tensor], inds: torch.Tensor,
                        ps: int, pt: int, bf16: bool) -> List[torch.Tensor]:
    """Launch the CUDA kernel; all tensors on one CUDA device."""
    _check(videos, inds)
    if not (all(v.is_cuda for v in videos) and inds.is_cuda):
        raise ValueError("patch_gather_kernel needs CUDA tensors")
    t_len, c, h, w = videos[0].shape
    videos = [v.contiguous() for v in videos]
    flat = inds.to(torch.int32).contiguous()
    b, k = inds.shape
    outs = [torch.empty((b, k, c, pt * ps * ps), dtype=torch.float32,
                        device=inds.device) for _ in videos]
    second = (videos[1].data_ptr(), outs[1].data_ptr()) \
        if len(videos) == 2 else (None, None)
    lib = _build.library()
    err = lib.vnlb_patch_gather(
        videos[0].data_ptr(), second[0], t_len, c, h, w, flat.data_ptr(),
        b * k, pt, ps, int(bf16), outs[0].data_ptr(), second[1],
        torch.cuda.current_stream(inds.device).cuda_stream)
    _build.check(err, "patch_gather kernel")
    patch_gather.launches += 1
    return outs


def patch_gather(videos: Sequence[torch.Tensor], inds: torch.Tensor,
                 ps: int, pt: int, bf16: bool) -> List[torch.Tensor]:
    """One (B, K, C, pt*ps*ps) patch tensor per video: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    dev = inds.device
    if dev.type == "cpu":
        return patch_gather_plain(videos, inds, ps, pt, bf16)
    if dev.type == "cuda":
        return patch_gather_kernel(videos, inds, ps, pt, bf16)
    raise ValueError(f"unsupported device {dev}")


patch_gather.launches = 0
