"""Patch aggregation in column space, fold and normalization
(vnlb_tpu/ops/agg.py:85-211).

Every aggregated patch adds one row to a (T*H'*W', pt*D + 1) accumulator
at the row of its corner: its pt*C*ps*ps pixels and one weight lane.  The
fold sums the rows back to image space once per pass.

The scatter is deterministic on every device and adds each row's updates
in their original order, as a sequential scatter does (and as the JAX
package's scatter does on the CPU): the updates are grouped by their
occurrence rank among updates of the same row (a stable sort), and each
rank is added with an indexed read-add-write over rows that are unique
within it.  ``index_add_`` and ``index_put_(accumulate=True)`` reduce
duplicates in an order that varies from run to run (atomics on CUDA, a
parallel reduction on the CPU).
"""

from __future__ import annotations

from typing import Tuple

import torch


def agg_rows(acc: torch.Tensor, patches: torch.Tensor, rows: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Accumulate patch rows into ``acc`` in place and return it.

    patches: (B, K, pt, C, ps, ps) filtered patches; rows: (B, K) base rows;
    valid: (B,) or (B, K) bool or float per-patch weights (the weight lane
    accumulates the weight mass).
    """
    b, k = rows.shape
    ptd = acc.shape[1] - 1
    if valid.dim() == 1:
        valid = valid[:, None]
    vm = valid[:, :, None].to(patches.dtype)
    upd = torch.cat([patches.reshape(b, k, ptd) * vm,
                     vm.expand(b, k, 1)], dim=-1)
    scatter_add_rows(acc, rows.reshape(-1).long(), upd.reshape(-1, ptd + 1))
    return acc


def scatter_add_rows(acc: torch.Tensor, rows: torch.Tensor,
                     upd: torch.Tensor) -> None:
    """acc[rows[i]] += upd[i] for i in order, deterministically, in place.

    Rank r holds the r-th occurrence of every row; ranks are added in
    ascending order, so each row receives its updates in original order."""
    n = rows.numel()
    if n == 0:
        return
    srt, perm = torch.sort(rows, stable=True)
    pos = torch.arange(n, device=rows.device)
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    new[1:] = srt[1:] != srt[:-1]
    start = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                         dim=0).values
    rank = pos - start                       # occurrence rank, sorted order
    order = perm[torch.sort(rank, stable=True).indices]
    counts = torch.bincount(rank).tolist()
    off = 0
    for cnt in counts:
        sel = order[off:off + cnt]
        r = rows[sel]
        acc[r] += upd[sel]
        off += cnt


def fold(acc: torch.Tensor, pt: int, ps: int, shape
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column-space accumulator -> deno (T, C, H, W), weights (T, H, W).

    Lane block j holds temporal patch plane j, deposited at the plane-0
    row; the dy offsets are summed first, then the dx offsets, both in
    ascending order, as in the JAX fold."""
    t_len, c, h, w = shape
    hp, wp = h - ps + 1, w - ps + 1
    d = c * ps * ps
    wv = acc[:, -1].reshape(t_len, hp, wp)
    wfull = torch.zeros((t_len, h, w), dtype=acc.dtype, device=acc.device)
    for dy in range(ps):
        for dx in range(ps):
            wfull[:, dy:dy + hp, dx:dx + wp] += wv
    weights = wfull.clone()
    for j in range(1, pt):
        weights[j:] += wfull[:t_len - j]

    deno = None
    for j in range(pt):
        a = acc[:, j * d:(j + 1) * d].reshape(t_len, hp, wp, c, ps, ps)
        a = a.permute(0, 3, 5, 4, 1, 2)            # (T, C, dx, dy, H', W')
        accx = torch.zeros((t_len, c, ps, h, wp), dtype=acc.dtype,
                           device=acc.device)
        for dy in range(ps):
            accx[:, :, :, dy:dy + hp, :] += a[:, :, :, dy]
        dj = torch.zeros((t_len, c, h, w), dtype=acc.dtype,
                         device=acc.device)
        for dx in range(ps):
            dj[:, :, :, dx:dx + wp] += accx[:, :, dx]
        if deno is None:
            deno = dj
        else:
            deno[j:] += dj[:t_len - j]
    return deno, weights


def finalize_img(deno: torch.Tensor, weights: torch.Tensor,
                 fallback: torch.Tensor) -> torch.Tensor:
    """Normalize by the weights; zero-weight pixels take ``fallback``."""
    wpos = weights > 0
    wsafe = torch.where(wpos, weights, torch.ones_like(weights))
    out = deno / wsafe[:, None]
    return torch.where(wpos[:, None], out, fallback)
