"""Patch aggregation in column space, fold and normalization
(vnlb_tpu/ops/agg.py:85-211), and the pixel-space aggregation of the
reference-order pass (``agg_patches``, ``finalize``; compat.py).

Every aggregated patch adds one row to a (T*H'*W', pt*D + 1) accumulator
at the row of its corner: its pt*C*ps*ps pixels and one weight lane.  The
fold sums the rows back to image space once per pass.

The scatter is deterministic on every device and adds each row's updates
in their original order, as a sequential scatter does (and as the JAX
package's scatter does on the CPU).  ``agg_rows`` sorts the rows stably
and hands them to a ``Kernels.scatter_rows`` function (ops/scatter_rows.py:
kernel K6 on the card, whose warps each walk one row's updates in order).
The plain version, and the pixel-space ``agg_patches``, use
``scatter_add_rows``: the updates are grouped by their occurrence rank
among updates of the same row, and each rank is added with an indexed
read-add-write over rows that are unique within it.  ``index_add_`` and
``index_put_(accumulate=True)`` reduce duplicates in an order that varies
from run to run (atomics on CUDA, a parallel reduction on the CPU).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.timer import span


def agg_rows(acc: torch.Tensor, patches: torch.Tensor, rows: torch.Tensor,
             valid: torch.Tensor, scatter, bf16: bool = False
             ) -> torch.Tensor:
    """Accumulate patch rows into ``acc`` in place and return it.

    patches: (B, K, pt, C, ps, ps) filtered patches, of which the first ka
    are scattered; rows: (B, ka) base rows; valid: (B,) or (B, ka) bool or
    float per-patch weights (the weight lane accumulates the weight mass).
    ``bf16`` rounds the update rows (the weighted patch lanes and the
    weight lane) to bf16 before the scatter, which adds them exactly into
    the f32 accumulator (vnlb_tpu/pipeline.py:257-261).  ``scatter`` is a
    ``Kernels.scatter_rows`` function: it takes the rows sorted stably
    (int32 keys) with their permutation and adds every row's updates in
    their original order.
    """
    b, ka = rows.shape
    if valid.dim() == 1:
        valid = valid[:, None].expand(b, ka)
    wts = valid.to(patches.dtype)
    with span("vnlb.scatter.order"):
        srt, perm = torch.sort(rows.to(torch.int32).reshape(-1), stable=True)
    with span("vnlb.scatter.rounds"):
        scatter(acc, patches, wts, srt, perm, bf16)
    return acc


def scatter_add_rows(acc: torch.Tensor, rows: torch.Tensor,
                     upd: torch.Tensor) -> None:
    """acc[rows[i]] += upd[i] for i in order, deterministically, in place.

    Rank r holds the r-th occurrence of every row; ranks are added in
    ascending order, so each row receives its updates in original order."""
    if rows.numel() == 0:
        return
    with span("vnlb.scatter.order"):
        srt, perm = torch.sort(rows, stable=True)
        idx, counts = rank_order(srt)
    with span("vnlb.scatter.rounds"):
        add_by_rank(acc, srt, perm, upd, idx, counts)


def rank_order(srt: torch.Tensor):
    """(idx, counts) of stably sorted rows ``srt``: the sorted positions
    ordered by occurrence rank (stable), and the count of each rank, read
    back to the host."""
    n = srt.numel()
    pos = torch.arange(n, device=srt.device)
    new = torch.ones(n, dtype=torch.bool, device=srt.device)
    new[1:] = srt[1:] != srt[:-1]
    start = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                         dim=0).values
    rank = pos - start                       # occurrence rank, sorted order
    idx = torch.sort(rank, stable=True).indices
    with span("vnlb.sync.scatter_counts"):
        counts = torch.bincount(rank).tolist()
    return idx, counts


def add_by_rank(acc: torch.Tensor, srt: torch.Tensor, perm: torch.Tensor,
                upd: torch.Tensor, idx: torch.Tensor, counts) -> None:
    """One indexed read-add-write a rank: rank r adds update perm[i] at row
    srt[i] for its sorted positions i, rows unique within the rank."""
    off = 0
    for cnt in counts:
        ix = idx[off:off + cnt]
        acc[srt[ix]] += upd[perm[ix]]
        off += cnt


def agg_patches(deno: torch.Tensor, weights: torch.Tensor,
                patches: torch.Tensor, inds: torch.Tensor,
                valid: torch.Tensor, pt: int, ps: int, shape
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-space aggregation of the reference-order pass
    (vnlb_tpu/ops/agg.py:24-82), in place; returns (deno, weights).

    deno (T*H*W, C) and weights (T*H*W,) accumulators; patches (B, K, pt,
    C, ps, ps); inds (B, K) flat indices (-1 invalid); valid (B,) or (B,
    K) bool.  Every pixel of each patch adds at its clipped corner
    (frame in [0, T-pt], row in [0, H-ps], column in [0, W-ps]), and one
    count to the weights; invalid entries add zeros.  Each pixel receives
    its updates in their original order, as JAX's sequential scatter adds
    them."""
    t_len, c, h, w = shape
    b, k = inds.shape
    hw = h * w
    valid = (valid[:, None] if valid.dim() == 1 else valid) & (inds >= 0)
    safe = torch.clamp(inds.long(), min=0)
    f = torch.clamp(safe // (c * hw), 0, t_len - pt)
    y = torch.clamp((safe % hw) // w, 0, h - ps)
    x = torch.clamp(safe % w, 0, w - ps)
    dev = inds.device
    dt = torch.arange(pt, device=dev)[:, None, None]
    dy = torch.arange(ps, device=dev)[None, :, None]
    dx = torch.arange(ps, device=dev)[None, None, :]
    rows = ((f[..., None, None, None] + dt) * hw
            + (y[..., None, None, None] + dy) * w
            + (x[..., None, None, None] + dx)).reshape(-1)
    vmask = valid[..., None, None, None].to(patches.dtype)
    upd = torch.cat([patches.permute(0, 1, 2, 4, 5, 3)
                     * vmask[..., None],
                     vmask.expand(b, k, pt, ps, ps)[..., None]], dim=-1)
    acc = torch.cat([deno, weights[:, None]], dim=1)
    scatter_add_rows(acc, rows, upd.reshape(-1, c + 1))
    deno.copy_(acc[:, :c])
    weights.copy_(acc[:, c])
    return deno, weights


def fold(acc: torch.Tensor, pt: int, ps: int, shape
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column-space accumulator -> deno (T, C, H, W), weights (T, H, W).

    Lane block j holds temporal patch plane j, deposited at the plane-0
    row; the dy offsets are summed first, then the dx offsets, both in
    ascending order, as in the JAX fold."""
    deno, weights, _ = fold_slab(acc, pt, ps, shape)
    return deno, weights


def fold_slab(acc: torch.Tensor, pt: int, ps: int, shape, carry=None):
    """``fold`` of the rows of n consecutive frames (``shape`` = (n, C, H,
    W)), which may be a slab of a longer clip: the streamed pass's
    retiring frames.

    Plane j of row frame r lands on frame r + j, so planes j >= 1 of the
    last j row frames spill past the slab.  ``carry`` is the previous
    slab's spill, [(deno (j, C, H, W), weights (j, H, W)) for j = 1 ..
    pt-1] (None: the slab starts the clip, nothing spills in, as zeros).
    Each frame's sums are those of the whole clip's fold, in its order.
    Returns (deno, weights, carry) with this slab's spill."""
    n, c, h, w = shape
    hp, wp = h - ps + 1, w - ps + 1
    d = c * ps * ps
    wv = acc[:, -1].reshape(n, hp, wp)
    wfull = torch.zeros((n, h, w), dtype=acc.dtype, device=acc.device)
    for dy in range(ps):
        for dx in range(ps):
            wfull[:, dy:dy + hp, dx:dx + wp] += wv
    weights = wfull.clone()
    deno, spill = None, []
    for j in range(pt):
        a = acc[:, j * d:(j + 1) * d].reshape(n, hp, wp, c, ps, ps)
        a = a.permute(0, 3, 5, 4, 1, 2)            # (n, C, dx, dy, H', W')
        accx = torch.zeros((n, c, ps, h, wp), dtype=acc.dtype,
                           device=acc.device)
        for dy in range(ps):
            accx[:, :, :, dy:dy + hp, :] += a[:, :, :, dy]
        dj = torch.zeros((n, c, h, w), dtype=acc.dtype, device=acc.device)
        for dx in range(ps):
            dj[:, :, :, dx:dx + wp] += accx[:, :, dx]
        if j == 0:
            deno = dj
            continue
        if carry is None:
            cd = torch.zeros((j, c, h, w), dtype=acc.dtype, device=acc.device)
            cw = torch.zeros((j, h, w), dtype=acc.dtype, device=acc.device)
        else:
            cd, cw = carry[j - 1]
        # plane j of row frames [start - j, start + n): frame f takes row
        # f - j, from the carry below the slab
        ed, ew = torch.cat([cd, dj]), torch.cat([cw, wfull])
        deno += ed[:n]
        weights += ew[:n]
        spill.append((ed[n:], ew[n:]))
    return deno, weights, spill


def finalize_img(deno: torch.Tensor, weights: torch.Tensor,
                 fallback: torch.Tensor) -> torch.Tensor:
    """Normalize by the weights; zero-weight pixels take ``fallback``."""
    wpos = weights > 0
    wsafe = torch.where(wpos, weights, torch.ones_like(weights))
    out = deno / wsafe[:, None]
    return torch.where(wpos[:, None], out, fallback)


def finalize(deno_flat: torch.Tensor, weights_flat: torch.Tensor,
             fallback: torch.Tensor, shape) -> torch.Tensor:
    """``agg_patches``' accumulators -> (T, C, H, W): normalized by the
    weights, the fallback image where no patch landed
    (vnlb_tpu/ops/agg.py:193-202)."""
    t_len, c, h, w = shape
    fb = fallback.permute(0, 2, 3, 1).reshape(-1, c)
    out = finalize_img(deno_flat, weights_flat, fb)
    return out.reshape(t_len, h, w, c).permute(0, 3, 1, 2)
