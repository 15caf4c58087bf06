"""RGB <-> opponent-YUV (vnlb_tpu/ops/color.py:23-37), full f32.

    y = (r + g + b) / sqrt(3)
    u = (r - b) / sqrt(2)
    v = (r - 2g + b) * sqrt(2) / (2 sqrt(3))
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timer import span

_S3 = 1.0 / np.sqrt(3.0)
_S2 = 1.0 / np.sqrt(2.0)
_S6 = np.sqrt(2.0) * 2.0 / np.sqrt(3.0)

# rows: output channel, cols: input channel
RGB2YUV = np.array(
    [[_S3, _S3, _S3],
     [_S2, 0.0, -_S2],
     [0.25 * _S6, -0.5 * _S6, 0.25 * _S6]], dtype=np.float32)

_SI = np.sqrt(2.0) / np.sqrt(3.0)
YUV2RGB = np.array(
    [[_S3, _S2, 0.5 * _SI],
     [_S3, 0.0, -_SI],
     [_S3, -_S2, 0.5 * _SI]], dtype=np.float32)


def _mix(m: np.ndarray, video: torch.Tensor) -> torch.Tensor:
    """out[..., d, :, :] = sum_c m[d, c] * video[..., c, :, :], in f32
    elementwise products (no matmul unit, so no TF32)."""
    with span("vnlb.sync.color_matrix"):
        mt = torch.as_tensor(m, dtype=video.dtype, device=video.device)
    chans = [sum(mt[d, c] * video[..., c, :, :] for c in range(3))
             for d in range(3)]
    return torch.stack(chans, dim=-3)


def rgb2yuv(video: torch.Tensor) -> torch.Tensor:
    """(..., 3, h, w) RGB -> opponent YUV."""
    return _mix(RGB2YUV, video)


def yuv2rgb(video: torch.Tensor) -> torch.Tensor:
    """(..., 3, h, w) opponent YUV -> RGB."""
    return _mix(YUV2RGB, video)
