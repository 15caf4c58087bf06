"""Patch aggregation in column space, fold and normalization
(vnlb_tpu/ops/agg.py:85-211), and the pixel-space aggregation of the
reference-order pass (``agg_patches``, ``finalize``; compat.py).

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

from ..utils.timer import span


def agg_rows(acc: torch.Tensor, patches: torch.Tensor, rows: torch.Tensor,
             valid: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Accumulate patch rows into ``acc`` in place and return it.

    patches: (B, K, pt, C, ps, ps) filtered patches; rows: (B, K) base rows;
    valid: (B,) or (B, K) bool or float per-patch weights (the weight lane
    accumulates the weight mass).  ``bf16`` rounds the update rows (the
    weighted patch lanes and the weight lane) to bf16 before the scatter,
    which adds them exactly into the f32 accumulator
    (vnlb_tpu/pipeline.py:257-261).
    """
    b, k = rows.shape
    ptd = acc.shape[1] - 1
    if valid.dim() == 1:
        valid = valid[:, None]
    vm = valid[:, :, None].to(patches.dtype)
    upd = torch.cat([patches.reshape(b, k, ptd) * vm,
                     vm.expand(b, k, 1)], dim=-1)
    if bf16:
        upd = upd.to(torch.bfloat16).to(acc.dtype)
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
    with span("vnlb.scatter.order"):
        srt, perm = torch.sort(rows, stable=True)
        pos = torch.arange(n, device=rows.device)
        new = torch.ones(n, dtype=torch.bool, device=rows.device)
        new[1:] = srt[1:] != srt[:-1]
        start = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                             dim=0).values
        rank = pos - start                   # occurrence rank, sorted order
        order = perm[torch.sort(rank, stable=True).indices]
        with span("vnlb.sync.scatter_counts"):
            counts = torch.bincount(rank).tolist()
    with span("vnlb.scatter.rounds"):
        off = 0
        for cnt in counts:
            sel = order[off:off + cnt]
            r = rows[sel]
            acc[r] += upd[sel]
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


def finalize(deno_flat: torch.Tensor, weights_flat: torch.Tensor,
             fallback: torch.Tensor, shape) -> torch.Tensor:
    """``agg_patches``' accumulators -> (T, C, H, W): normalized by the
    weights, the fallback image where no patch landed
    (vnlb_tpu/ops/agg.py:193-202)."""
    t_len, c, h, w = shape
    fb = fallback.permute(0, 2, 3, 1).reshape(-1, c)
    out = finalize_img(deno_flat, weights_flat, fb)
    return out.reshape(t_len, h, w, c).permute(0, 3, 1, 2)
