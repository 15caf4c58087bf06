"""Zero-flow top-K search with out-of-bounds masking (the main path of
vnlb_tpu/ops/search_dense.py:501-739, ``border_mode="mask"``, exact top-K).

Per pyramid level and temporal offset dt, kernel K1 (ops/patch_dist.py)
gives every site its w_s x w_s raw candidate distances directly; the TPU's
phase-major selection layout is not needed.  The semantics kept exactly:

* needle pyramid: 2x average pooling, stopping before a level smaller than
  w_s+ps-1 (search_dense.py:527-534);
* coarse queries are clamped into [half, h_l-ps-half] (``_site_rows``,
  :284-297); level 0 is not clamped;
* each level's raw distance rounds to bf16 (``search_bf16``), is divided by
  norm = pt*c_d*ps^2*255^2 in f32 (as a product with the f32 reciprocal,
  which is what XLA emits for that division), and the levels add in order
  0+1+2;
* then ``- offset``, ``+inf`` for an invalid dt (t+dt outside [0, T-pt])
  and ``+inf`` for out-of-bounds candidates;
* exact top-K in enumeration order (dt, dy, dx) with ties listed earliest
  position first, as ``lax.top_k`` does: a stable ascending sort;
* indices decode with the frame clipped, -1 where the value is inf.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..config import StageConfig
from .patch_dist import patch_dist
from .search import _apply_tau, eff_dt_range, inv_norm, search_levels


def level_queries(sites: torch.Tensor, lvl: int, h_l: int, w_l: int,
                  cfg: StageConfig):
    """Query corners of the sites at pyramid level ``lvl``: level 0 as is,
    coarse levels scaled and clamped into [half, h_l-ps-half]."""
    t, y, x = sites[:, 0], sites[:, 1], sites[:, 2]
    if lvl == 0:
        return t, y, x
    half = (cfg.w_s - 1) // 2
    y = torch.clamp(y >> lvl, min=half, max=max(h_l - cfg.ps - half, 0))
    x = torch.clamp(x >> lvl, min=half, max=max(w_l - cfg.ps - half, 0))
    return t, y, x


def exec_search_dense(video: torch.Tensor, sites: torch.Tensor,
                      cfg: StageConfig,
                      levels: Optional[List[torch.Tensor]] = None,
                      dist_fn: Callable = patch_dist
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K search for lattice ``sites`` (S, 3) of ``video`` (T, C, H, W).

    Returns (vals (S, K) f32 ascending, inds (S, K) int32 flat indices,
    -1 invalid).  ``levels`` reuses a pyramid from ``search_levels``;
    ``dist_fn`` is the distance function (the device-dispatching wrapper by
    default; the tests and the on-card comparison pass the plain one).
    """
    t_len, c_full, h, w = video.shape
    k = cfg.npatches
    ps, pt, w_s = cfg.ps, cfg.pt, cfg.w_s
    half = (w_s - 1) // 2
    ws2 = w_s * w_s
    s_cnt = sites.shape[0]
    inv = inv_norm(cfg)
    dt_lo, dt_hi = eff_dt_range(cfg, t_len)
    n_dt = dt_hi - dt_lo + 1
    if n_dt * ws2 < k:
        raise ValueError(f"{n_dt * ws2} candidates < K={k}")
    if levels is None:
        levels = search_levels(video, cfg)
    sites = sites.to(device=video.device, dtype=torch.int64)

    cand = None                                        # (n_dt, S, ws2)
    for lvl, v_l in enumerate(levels):
        qt, qy, qx = level_queries(sites, lvl, v_l.shape[2], v_l.shape[3],
                                   cfg)
        raw = dist_fn(v_l, qt, qy, qx, dt_lo, n_dt, pt, ps, w_s)
        if cfg.search_bf16:
            raw = raw.to(torch.bfloat16).to(torch.float32)
        part = raw * inv
        cand = part if cand is None else cand + part

    ts, ys, xs = sites[:, 0], sites[:, 1], sites[:, 2]
    dts = torch.arange(dt_lo, dt_hi + 1, device=video.device)
    f = ts[None, :] + dts[:, None]                     # (n_dt, S)
    valid = (f >= 0) & (f <= t_len - pt)
    inf = torch.tensor(float("inf"), device=video.device)
    zero = torch.zeros((), device=video.device)
    cand = cand - cfg.offset + torch.where(valid, zero, inf)[:, :, None]
    dgrid = torch.arange(w_s, device=video.device)
    cy = ys[:, None, None] - half + dgrid[None, :, None]
    cx = xs[:, None, None] - half + dgrid[None, None, :]
    bad = (cy < 0) | (cy > h - ps) | (cx < 0) | (cx > w - ps)
    oob = torch.where(bad, inf, zero).reshape(s_cnt, ws2)
    cand = cand + oob[None]

    # (S, n_dt*ws2) in enumeration order (dt, dy, dx); a stable ascending
    # sort lists equal values earliest position first, like lax.top_k
    flat = cand.permute(1, 0, 2).reshape(s_cnt, n_dt * ws2)
    svals, sel = torch.sort(flat, dim=1, stable=True)
    vals, sel = svals[:, :k].contiguous(), sel[:, :k]

    dt_i = sel // ws2 + dt_lo
    rem = sel % ws2
    fcl = torch.clamp(ts[:, None] + dt_i, 0, t_len - pt)
    y = ys[:, None] - half + rem // w_s
    x = xs[:, None] - half + rem % w_s
    inds = (fcl * (c_full * h * w) + y * w + x).to(torch.int32)
    inds = torch.where(torch.isinf(vals), torch.full_like(inds, -1), inds)
    return vals, _apply_tau(vals, inds, cfg)
