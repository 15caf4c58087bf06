"""Temporal windows of the long-clip entry points (vnlb_tpu/api.py:86-167,
vnlb_tpu/parallel/pipe.py:35-50): ``api.denoise_streaming`` and
``parallel.pipe.denoise_pipelined`` run each pass over fixed windows of a
host clip, each window's lattice anchored at its first global frame."""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import prep_flows, proc_nl


def host_inputs(noisy, flows):
    """(noisy, fflow, bflow, zero_flow) with the clip and the flows as host
    f32 arrays."""
    noisy = np.asarray(noisy.cpu() if isinstance(noisy, torch.Tensor)
                       else noisy, np.float32)
    fflow, bflow, zflow = prep_flows(noisy.shape, flows)
    return noisy, fflow.numpy(), bflow.numpy(), zflow


def pass_ctx(scfg) -> int:
    """Context frames on each side of a window: an output frame takes
    deposits from sites up to nwt + pt - 1 frames away, whose windows reach
    as far again."""
    return 2 * max(scfg.nwt_b, scfg.nwt_f) + scfg.pt - 1


def windows(t_len: int, chunk: int, ctx: int):
    """[(start, stop, lo, hi)]: output frames [start, stop) computed in the
    fixed window [lo, hi) of chunk + 2*ctx frames (extra context only widens
    the exact-match region)."""
    win = min(t_len, chunk + 2 * ctx)
    out = []
    for start in range(0, t_len, chunk):
        lo = max(0, min(start - ctx, t_len - win))
        out.append((start, min(start + chunk, t_len), lo, lo + win))
    return out


def window_pass(scfg, noisy, basic_full, fflow, bflow, zflow, lo, hi,
                device) -> torch.Tensor:
    """``proc_nl`` on ``device`` over frames [lo, hi) of the host clip, its
    lattice anchored at frame lo."""
    nz = torch.from_numpy(noisy[lo:hi]).to(device)
    bs = (None if basic_full is None
          else torch.from_numpy(basic_full[lo:hi]).to(device))
    ff, bf = ((None, None) if zflow else
              (torch.from_numpy(fflow[lo:hi]).to(device),
               torch.from_numpy(bflow[lo:hi]).to(device)))
    return proc_nl(nz, bs, None, ff, bf, scfg, zero_flow=zflow, t_origin=lo)
