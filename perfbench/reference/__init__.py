"""The plain reference of the benchmark: two-pass Video Non-Local Bayes in
plain PyTorch, frozen from the port's plain path (``vnlb_tpu_torch``'s
``pipeline.PLAIN`` kernels, its config, lattice, searches, filters,
scatter and fold).  It imports nothing of the program and takes nothing
the program made: given the clip, its flows and the configuration, it
works out the lattice, both searches, the filter and the aggregation
itself.

``denoise`` runs under full f32 (TF32 off), as the program does;
``tf32=True`` turns TF32 on for its matrix products, the lower-precision
control of the benchmark's correctness check.
"""

from __future__ import annotations

import contextlib

import torch

from .config import VnlbConfig, default_config
from .pipeline import as_video, prep_flows, proc_nl

__all__ = ["denoise", "default_config", "VnlbConfig", "matmul_precision"]


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Set TF32 for matrix products and cuDNN inside the block; restore the
    caller's flags on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def denoise(noisy, sigma: float, flows, cfg: VnlbConfig, device,
            tf32: bool = False):
    """(deno, basic) of the two passes on ``device``; ``flows`` is None or
    a (fflow, bflow) pair of (T-1)- or T-frame stacks."""
    device = torch.device(device)
    with matmul_precision(tf32), torch.no_grad():
        noisy_t = as_video(noisy, device)
        fflow, bflow, zf = prep_flows(tuple(noisy_t.shape), flows, device)
        basic = proc_nl(noisy_t, None, None, fflow, bflow, cfg.stage(0),
                        zero_flow=zf)
        deno = proc_nl(noisy_t, basic, None, fflow, bflow, cfg.stage(1),
                       zero_flow=zf)
    return deno, basic
