"""The per-site gather search with flow-tracked windows
(vnlb_tpu/ops/search.py:49-140, 300-425), and the helpers it shares with
the dense search.

Every site evaluates n_dt x w_s x w_s candidates: for each temporal offset
dt the w_s x w_s window is centred on the site's flow-tracked position in
frame t+dt and slides to stay inside the frame (``_window_starts``).
Kernel K1 (ops/patch_dist.py) computes the distances of every pyramid
level from per-(dt, site) window starts.  The semantics kept exactly:

* centres accumulate flow in f32, clipped to the frame after each step;
  flow is read at the rounded (half up), clipped position; u is x, v is y;
  backward centres are listed first, so dt ascends;
* no bf16 rounding of the distances (``search_bf16`` is a dense-path
  setting); each level's distance is divided by norm =
  pt*c_d*ps^2*255^2 as a product with the f32 reciprocal (what XLA emits
  for that division; on the CPU it also fuses the level sum into FMAs,
  which the port does not mirror) and the levels add in order 0+1+2;
* needle coarse levels halve the query, clip(y//2, 0, lh-ps) and
  min(x//2, lw-ps), and the centres, clip(cy//2, 0, lh-1) and
  min(cx//2, lw-1), level by level; then that level's sliding clamp
  applies;
* ``- offset``, ``+inf`` for an invalid dt (t+dt outside [0, T-pt]);
* one top-K over (dt, dy, dx) with ties earliest position first (a stable
  ascending sort, as ``lax.top_k`` orders them); candidate indices at
  frame clip(t+dt, 0, T-pt), rows min(sy+a, H-ps), columns
  min(sx+b, W-ps); -1 where the value is inf.

On a halo strip tile of the H-sharded pass (vnlb_tpu/ops/search.py:64-141,
300-412) ``y_bounds`` = (first, last) GLOBAL frame row in tile coordinates
replaces (0, H-1) in the level-0 centre, flow-lookup, window and corner
clamps, and the coarse levels are the full-frame pooled levels (JAX's
``coarse_global``, which every caller with bounds sets): the query and the
centres shift to global rows before the first halving, and the full-frame
clamps apply from there.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import StageConfig
from ..utils.timer import span
from .patch_dist import patch_dist


def eff_dt_range(cfg: StageConfig, t_len: int):
    """Static clamp of the temporal offset range: dt can only be valid when
    some site has 0 <= t+dt <= T-pt."""
    return (max(-cfg.nwt_b, -(t_len - cfg.pt)),
            min(cfg.nwt_f, t_len - cfg.pt))


def _avg_pool2(video: torch.Tensor) -> torch.Tensor:
    """2x spatial average pooling of (T, C, H, W); odd sizes truncate."""
    t, c, h, w = video.shape
    h2, w2 = h // 2, w // 2
    v = video[:, :, :h2 * 2, :w2 * 2].reshape(t, c, h2, 2, w2, 2)
    return v.mean(dim=(3, 5))


def search_levels(video: torch.Tensor, cfg: StageConfig) -> List[torch.Tensor]:
    """Pyramid levels of the searched channels: level 0 is the first
    ``dist_chnls`` channels of ``video``; needle search adds pooled levels
    while they hold a (w_s+ps-1)^2 region."""
    levels = [video[:, :cfg.dist_chnls].contiguous()]
    if cfg.stype == "needle":
        r = cfg.w_s + cfg.ps - 1
        for _ in range(1, cfg.needle_scales):
            lh, lw = levels[-1].shape[2] // 2, levels[-1].shape[3] // 2
            if lh < r or lw < r:
                break
            levels.append(_avg_pool2(levels[-1]).contiguous())
    return levels


def inv_norm(cfg: StageConfig) -> float:
    """f32 reciprocal of the distance normalization pt*c_d*ps^2*255^2."""
    norm = float(cfg.pt * cfg.dist_chnls * cfg.ps * cfg.ps) * 255.0 ** 2
    return float(np.float32(1.0) / np.float32(norm))


def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5)


def track_centers(sites: torch.Tensor, fflow: torch.Tensor,
                  bflow: torch.Tensor, nwt_b: int, nwt_f: int,
                  shape, y_bounds=None) -> torch.Tensor:
    """Flow-tracked window centres: int32 (B, nwt_b+nwt_f+1, 2) = (cy, cx)
    for dt = -nwt_b .. +nwt_f.  With zero flow every centre is the site.
    ``y_bounds`` (y0, y1): the frame's first and last rows in this array's
    coordinates (a halo tile's global bounds), (0, H-1) by default."""
    t_len, _, h, w = shape
    y0, y1 = (0, h - 1) if y_bounds is None else y_bounds
    tq = sites[:, 0].long()
    cy0 = sites[:, 1].to(torch.float32)
    cx0 = sites[:, 2].to(torch.float32)

    def lookup(flow, f_idx, cy, cx):
        fi = f_idx.clamp(0, t_len - 1)
        yi = _round_half_up(cy).clamp(max(y0, 0), min(y1, h - 1)).long()
        xi = _round_half_up(cx).clamp(0, w - 1).long()
        return flow[fi, 0, yi, xi], flow[fi, 1, yi, xi]

    def walk(flow, sign, n):
        out, cy, cx = [], cy0, cx0
        for i in range(n):
            u, v = lookup(flow, tq + sign * i, cy, cx)
            cy = (cy + v).clamp(float(y0), float(y1))
            cx = (cx + u).clamp(0.0, w - 1.0)
            out.append((cy, cx))
        return out

    chain = walk(bflow, -1, nwt_b)[::-1] + [(cy0, cx0)] \
        + walk(fflow, 1, nwt_f)
    centers = torch.stack([torch.stack([cy, cx], dim=-1)
                           for cy, cx in chain], dim=1)
    return _round_half_up(centers).to(torch.int32)


def _window_starts(centers: torch.Tensor, w_s: int, ps: int, h: int,
                   w: int, y_bounds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sliding-window top-left corners clip(centre - half, 0, (H-ps) -
    (w_s-1)), so that all w_s candidates stay inside the frame (the lower
    clip wins when the frame is smaller than the window); rows between
    ``y_bounds`` when given."""
    half = (w_s - 1) // 2
    if y_bounds is None:
        ylo, yhi = 0, max(h - ps - (w_s - 1), 0)
    else:
        ylo = y_bounds[0]
        yhi = max(y_bounds[1] + 1 - ps - (w_s - 1), ylo)
    sy = (centers[..., 0] - half).clamp(ylo, yhi)
    sx = (centers[..., 1] - half).clamp(0, max(w - ps - (w_s - 1), 0))
    return sy, sx


def exec_search(video: torch.Tensor, sites: torch.Tensor,
                fflow: torch.Tensor, bflow: torch.Tensor, cfg: StageConfig,
                levels: Optional[List[torch.Tensor]] = None,
                dist_fn: Callable = patch_dist, y_bounds=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K gather search for ``sites`` (S, 3) of ``video`` (T, C, H, W)
    along the flows ``fflow``/``bflow`` (T, 2, H, W).  On a halo tile,
    ``y_bounds`` are the global frame rows in tile coordinates and
    ``levels[1:]`` are full-frame levels.

    Returns (vals (S, K) f32 ascending, inds (S, K) int32 flat indices,
    -1 invalid).  ``levels`` reuses a pyramid from ``search_levels``;
    ``dist_fn`` is the distance function (the device-dispatching wrapper by
    default; the tests and the on-card comparison pass the plain one).
    """
    t_len, c_full, h, w = video.shape
    k, w_s, ps, pt = cfg.npatches, cfg.w_s, cfg.ps, cfg.pt
    ws2 = w_s * w_s
    if ws2 < k:
        raise ValueError(f"w_s^2={ws2} < K={k}: not enough candidates")
    r = w_s + ps - 1
    if h < r or w < r:
        raise ValueError(f"frame {h}x{w} smaller than search region {r}x{r}; "
                         f"reduce w_s or pad the video")
    if levels is None:
        levels = search_levels(video, cfg)
    dev = video.device
    sites = sites.to(device=dev, dtype=torch.int64)
    s_cnt = sites.shape[0]
    dt_lo, dt_hi = eff_dt_range(cfg, t_len)
    n_dt = dt_hi - dt_lo + 1
    # only the statically valid offsets: a centre depends on the steps
    # before it only, so these equal JAX's centres sliced to [dt_lo, dt_hi]
    centers = track_centers(sites, fflow, bflow, -dt_lo, dt_hi,
                            video.shape, y_bounds).long()
    inv = inv_norm(cfg)

    ts, qy, qx = sites[:, 0], sites[:, 1], sites[:, 2]
    cy, cx = centers[..., 0], centers[..., 1]                 # (S, n_dt)
    cand = starts0 = None
    for lvl, v_l in enumerate(levels):
        lh, lw = v_l.shape[2], v_l.shape[3]
        if lvl == 1 and y_bounds is not None:
            # full-frame coarse levels: global rows from here on
            qy, cy = qy - y_bounds[0], cy - y_bounds[0]
        if lvl:
            qy, qx = (qy // 2).clamp(0, lh - ps), (qx // 2).clamp(max=lw - ps)
            cy, cx = (cy // 2).clamp(0, lh - 1), (cx // 2).clamp(max=lw - 1)
        sy, sx = _window_starts(torch.stack([cy, cx], dim=-1), w_s, ps, lh,
                                lw, y_bounds if lvl == 0 else None)
        if lvl == 0:
            starts0 = (sy, sx)
        raw = dist_fn(v_l, ts, qy, qx, dt_lo, n_dt, pt, ps, w_s,
                      sy=sy.T.contiguous(), sx=sx.T.contiguous())
        part = raw * inv                                      # (n_dt, S, ws2)
        cand = part if cand is None else cand + part

    f = ts[None, :] + torch.arange(dt_lo, dt_hi + 1, device=dev)[:, None]
    valid = (f >= 0) & (f <= t_len - pt)                      # (n_dt, S)
    with span("vnlb.sync.gather_inf"):
        inf = torch.tensor(float("inf"), device=dev)
    cand = torch.where(valid[:, :, None], cand - cfg.offset, inf)

    # (S, n_dt*ws2) in enumeration order (dt, dy, dx); a stable ascending
    # sort lists equal values earliest position first, like lax.top_k
    with span("vnlb.search.topk"):
        flat = cand.permute(1, 0, 2).reshape(s_cnt, n_dt * ws2)
        svals, sel = torch.sort(flat, dim=1, stable=True)
        vals, sel = svals[:, :k].contiguous(), sel[:, :k]

    di, rem = sel // ws2, sel % ws2
    sy0, sx0 = (s.gather(1, di) for s in starts0)
    y = (sy0 + rem // w_s).clamp(
        max=h - ps if y_bounds is None else y_bounds[1] + 1 - ps)
    x = (sx0 + rem % w_s).clamp(max=w - ps)
    fcl = (ts[:, None] + di + dt_lo).clamp(0, t_len - pt)
    inds = (fcl * (c_full * h * w) + y * w + x).to(torch.int32)
    inds = torch.where(torch.isinf(vals), torch.full_like(inds, -1), inds)
    return vals, _apply_tau(vals, inds, cfg)


def _apply_tau(vals: torch.Tensor, inds: torch.Tensor, cfg: StageConfig):
    """Similarity threshold: when ``cfg.tau`` > 0, candidates whose
    normalized distance exceeds tau/255^2 - offset get index -1."""
    if cfg.tau <= 0:
        return inds
    tau_n = cfg.tau / (255.0 ** 2) - cfg.offset
    with span("vnlb.search.topk"):
        return torch.where(vals > tau_n, torch.full_like(inds, -1), inds)
