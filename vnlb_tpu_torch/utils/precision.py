"""Full-f32 matrix products for the duration of a call."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for matrix products and cuDNN inside the block (the
    plain versions use ``torch.bmm``) and restore the caller's two flags on
    exit, also when the block raises.  Usable as a decorator."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
