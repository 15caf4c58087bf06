"""Zero-flow top-K search with out-of-bounds masking
(vnlb_tpu/ops/search_dense.py:501-739): both row modes and every top-K
mode.

Each pyramid level's candidate distances come from one of two kernels:

* ``dense_rows="auto"`` (the default, JAX's lattice-row path): kernel K1
  (ops/patch_dist.py) gives every site its w_s x w_s raw distances
  directly; the TPU's phase-major selection layout is not needed;
* ``dense_rows="full"`` (JAX's all-rows path, ``qrow0=None``): kernel K3
  (ops/dense_dist.py) computes the distances of every pixel for one
  (level, dt) at a time, and each site takes its row of that plane.  The
  planes are shared by every site of the call, so a pass searches all its
  dense sites in one call (pipeline.accumulate).

The semantics kept exactly:

* needle pyramid: 2x average pooling, stopping before a level smaller than
  w_s+ps-1 (search_dense.py:527-534);
* coarse queries are clamped into [half, h_l-ps-half] (``_site_rows``,
  :284-297); level 0 is not clamped;
* each level's raw distance rounds to bf16 (``search_bf16``), is divided by
  norm = pt*c_d*ps^2*255^2 in f32 (as a product with the f32 reciprocal,
  which is what XLA emits for that division), and the levels add in order
  0+1+2;
* then ``- offset``, ``+inf`` for an invalid dt (t+dt outside [0, T-pt])
  and, under ``border_mode="mask"``, ``+inf`` for out-of-bounds
  candidates;
* top-K in enumeration order (dt, dy, dx) with ties listed earliest
  position first, as ``lax.top_k`` does: a stable ascending sort.
  ``topk="stream"`` (when w_s^2 >= K) merges a running (S, K) top-K with
  each dt plane, running entries first, which gives the same bits as the
  one-shot sort with an O(S*(K+w_s^2)) buffer.  ``topk="approx"`` is the
  exact top-K: ``lax.approx_max_k`` is exact on every backend but the TPU;
* indices decode with the frame clipped, -1 where the value is inf.

``exec_search_dense_tile`` (vnlb_tpu/ops/search_dense.py:342-498 and the
all-rows ``_search_dense_halo``, vnlb_tpu/parallel/halo.py:100-177) is the
same search on a halo strip tile of the H-sharded pass: level 0 on the
tile in tile coordinates, the coarse needle levels on the full-frame pooled
levels at the sites' global rows, +inf for candidates outside the GLOBAL
frame, indices decoded in tile coordinates.

On a temporal slab of a streamed pass, ``exec_search_dense`` takes the
gather search's ``t_bounds`` (ops/search.py): the offset range and the
+inf of invalid offsets follow the clip, and the distances of K1 or K3
come from the slab, which holds every frame a valid candidate reads.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from ..config import StageConfig
from ..utils.timer import span
from .dense_dist import dense_dist, frame_range
from .patch_dist import patch_dist, patch_dist_tile, tile_oob
from .search import (_apply_tau, clip_frames, eff_dt_range, inv_norm,
                     search_levels)

# sites per sort of the exact top-K (bounds the sort's scratch)
SORT_CHUNK = 4096


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


def _round(raw: torch.Tensor, cfg: StageConfig, inv: float) -> torch.Tensor:
    """One level's normalized term: bf16 rounding, then times 1/norm."""
    if cfg.search_bf16:
        raw = raw.to(torch.bfloat16).to(torch.float32)
    return raw * inv


def _site_planes(levels, queries, cfg, dt_lo, n_dt, dist_fn,
                 dist0=None) -> torch.Tensor:
    """(n_dt, S, ws2) level sums from K1's per-site distances at each
    level's queries (qt, qy, qx); ``dist0`` computes level 0 instead of
    ``dist_fn`` when given (the tile entry)."""
    inv = inv_norm(cfg)
    cand = None                                        # (n_dt, S, ws2)
    for lvl, (v_l, (qt, qy, qx)) in enumerate(zip(levels, queries)):
        fn = dist0 if lvl == 0 and dist0 is not None else dist_fn
        part = _round(fn(v_l, qt, qy, qx, dt_lo, n_dt, cfg.pt, cfg.ps,
                         cfg.w_s), cfg, inv)
        cand = part if cand is None else cand + part
    return cand


def _full_planes(levels, queries, cfg, dt_lo, n_dt, dense_fn
                 ) -> Iterator[torch.Tensor]:
    """Per-dt (S, ws2) level sums taken from K3's all-pixel planes at each
    level's queries (qt, qy, qx), one (level, dt) plane alive at a time.
    Sites whose frame has no candidate frame at this dt read a valid row;
    the caller masks them +inf."""
    inv = inv_norm(cfg)
    t_len = levels[0].shape[0]
    for dt in range(dt_lo, dt_lo + n_dt):
        f_lo, f_hi = frame_range(t_len, cfg.pt, dt)
        if f_lo >= f_hi:
            # a slab with no candidate frame at this dt: every site is
            # masked +inf
            yield torch.zeros((queries[0][0].shape[0], cfg.w_s * cfg.w_s),
                              device=levels[0].device)
            continue
        cand = None
        for v_l, (qt, qy, qx) in zip(levels, queries):
            plane = dense_fn(v_l, dt, cfg.pt, cfg.ps, cfg.w_s)
            _, hp, wp, ws2 = plane.shape
            rows = ((qt.clamp(f_lo, f_hi - 1) - f_lo) * hp + qy) * wp + qx
            got = plane.view(-1, ws2).index_select(0, rows)
            del plane
            part = _round(got, cfg, inv)
            cand = part if cand is None else cand + part
        yield cand


def _sorted_topk(flat: torch.Tensor, k: int):
    """Exact top-K of each row, ascending, ties earliest position first."""
    vals, sel = [], []
    for s0 in range(0, flat.shape[0], SORT_CHUNK):
        sv, si = torch.sort(flat[s0:s0 + SORT_CHUNK], dim=1, stable=True)
        # copies: a view would keep the whole sorted chunk alive
        vals.append(sv[:, :k].contiguous())
        sel.append(si[:, :k].contiguous())
    if len(vals) == 1:
        return vals[0], sel[0]
    return torch.cat(vals), torch.cat(sel)


def _stream_topk(planes: Iterator[torch.Tensor], k: int, ws2: int):
    """Running top-K merged with each dt plane (search_dense.py:628-658):
    the running entries come from earlier planes and precede the new
    plane's in the stable sort, so ties keep the one-shot order."""
    run_v = run_s = None
    for di, cand in enumerate(planes):
        # the plane is computed by ``enumerate``, outside the span
        with span("vnlb.search.topk"):
            if run_v is None:
                sv, si = torch.sort(cand, dim=1, stable=True)
                run_s = si[:, :k].contiguous()
            else:
                code = di * ws2 + torch.arange(ws2, device=cand.device)
                sv, si = torch.sort(torch.cat([run_v, cand], dim=1), dim=1,
                                    stable=True)
                mc = torch.cat([run_s, code.expand(cand.shape[0], ws2)],
                               dim=1)
                run_s = mc.gather(1, si[:, :k])
                del mc
            # copies, and the sort's scratch freed before the next plane is
            # computed: the running state is all this mode keeps
            run_v = sv[:, :k].contiguous()
            del sv, si, cand
    return run_v, run_s


def _select(planes, cfg: StageConfig, s_cnt: int, n_dt: int, ws2: int,
            per_dt: bool):
    """Top-K of the masked candidates: ``planes`` is (n_dt, S, ws2), or an
    iterator of per-dt (S, ws2) planes when ``per_dt``.  Returns (vals,
    sel) with sel the position in enumeration order (dt, dy, dx)."""
    k = cfg.npatches
    if cfg.topk == "stream" and ws2 >= k:
        return _stream_topk(planes, k, ws2)
    if per_dt:
        flat = None
        for di, cand in enumerate(planes):
            if flat is None:
                flat = torch.empty((s_cnt, n_dt, ws2), dtype=torch.float32,
                                   device=cand.device)
            flat[:, di] = cand
    else:
        flat = planes.permute(1, 0, 2)
    # the per-dt planes are all computed by now: no kernel in the span
    with span("vnlb.search.topk"):
        return _sorted_topk(flat.reshape(s_cnt, n_dt * ws2), k)


def _decode(vals, sel, sites, cfg: StageConfig, dt_lo: int, shape):
    """Flat indices t*C*H*W + y*W + x of the selected candidates of
    ``sites`` in a (T, C, H, W) video (frame clipped), -1 where the value is
    inf, then the similarity threshold."""
    t_len, c_full, h, w = shape
    ws2 = cfg.w_s * cfg.w_s
    half = (cfg.w_s - 1) // 2
    ts, ys, xs = sites[:, 0], sites[:, 1], sites[:, 2]
    dt_i = sel // ws2 + dt_lo
    rem = sel % ws2
    fcl = torch.clamp(ts[:, None] + dt_i, 0, t_len - cfg.pt)
    y = ys[:, None] - half + rem // cfg.w_s
    x = xs[:, None] - half + rem % cfg.w_s
    inds = (fcl * (c_full * h * w) + y * w + x).to(torch.int32)
    inds = torch.where(torch.isinf(vals), torch.full_like(inds, -1), inds)
    return vals, _apply_tau(vals, inds, cfg)


def _masker(sites, cfg: StageConfig, t_len: int, dt_lo: int, n_dt: int,
            oob: Optional[torch.Tensor], t0: int = 0):
    """(mask, valid): ``mask(cand, ok)`` subtracts the offset and adds +inf
    where ``ok`` (the leading dims of ``cand``) is False and where ``oob``
    (S, ws2) is True -- additions, so x + 0 stays x; ``valid`` (n_dt, S)
    says which (dt, site) have a candidate frame in the clip of ``t_len``
    frames whose frame ``t0`` is the sites' frame 0."""
    dev = sites.device
    f = sites[None, :, 0] + t0 + torch.arange(dt_lo, dt_lo + n_dt,
                                               device=dev)[:, None]
    valid = (f >= 0) & (f <= t_len - cfg.pt)
    with span("vnlb.sync.dense_inf"):
        inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    add = None if oob is None else torch.where(oob, inf, zero)

    def mask(cand, ok):
        cand = cand - cfg.offset + torch.where(ok, zero, inf)[..., None]
        return cand if add is None else cand + add

    return mask, valid


def _dt_span(cfg: StageConfig, t_len: int):
    dt_lo, dt_hi = eff_dt_range(cfg, t_len)
    n_dt = dt_hi - dt_lo + 1
    if n_dt * cfg.w_s * cfg.w_s < cfg.npatches:
        raise ValueError(f"{n_dt * cfg.w_s * cfg.w_s} candidates < "
                         f"K={cfg.npatches}")
    return dt_lo, n_dt


def exec_search_dense(video: torch.Tensor, sites: torch.Tensor,
                      cfg: StageConfig,
                      levels: Optional[List[torch.Tensor]] = None,
                      dist_fn: Callable = patch_dist,
                      dense_fn: Callable = dense_dist, t_bounds=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K search for lattice ``sites`` (S, 3) of ``video`` (T, C, H, W).

    Returns (vals (S, K) f32 ascending, inds (S, K) int32 flat indices,
    -1 invalid).  ``levels`` reuses a pyramid from ``search_levels``;
    ``dist_fn`` (K1, ``dense_rows="auto"``) and ``dense_fn`` (K3,
    ``dense_rows="full"``) are the distance functions (the
    device-dispatching wrappers by default; the tests and the on-card
    comparison pass the plain ones).  ``t_bounds``: a temporal slab's (t0,
    T), as in ``search.exec_search``.
    """
    t_len, _, h, w = video.shape
    ps, w_s = cfg.ps, cfg.w_s
    half = (w_s - 1) // 2
    ws2 = w_s * w_s
    s_cnt = sites.shape[0]
    t0, t_clip = clip_frames(t_len, t_bounds)
    dt_lo, n_dt = _dt_span(cfg, t_clip)
    if levels is None:
        levels = search_levels(video, cfg)
    sites = sites.to(device=video.device, dtype=torch.int64)
    oob = None
    if cfg.border_mode == "mask":
        dgrid = torch.arange(w_s, device=video.device)
        cy = sites[:, 1, None, None] - half + dgrid[None, :, None]
        cx = sites[:, 2, None, None] - half + dgrid[None, None, :]
        oob = ((cy < 0) | (cy > h - ps) | (cx < 0)
               | (cx > w - ps)).reshape(s_cnt, ws2)
    mask, valid = _masker(sites, cfg, t_clip, dt_lo, n_dt, oob, t0)

    queries = [level_queries(sites, lvl, v.shape[2], v.shape[3], cfg)
               for lvl, v in enumerate(levels)]
    full = cfg.dense_rows == "full"
    if full:
        # one (level, dt) plane at a time; per-dt candidates
        planes = (mask(cand, valid[di]) for di, cand in enumerate(
            _full_planes(levels, queries, cfg, dt_lo, n_dt, dense_fn)))
    else:
        planes = mask(_site_planes(levels, queries, cfg, dt_lo, n_dt,
                                   dist_fn), valid)    # (n_dt, S, ws2)
    vals, sel = _select(planes, cfg, s_cnt, n_dt, ws2, full)
    del planes
    return _decode(vals, sel, sites, cfg, dt_lo, video.shape)


def tile_search_mode(cfg: StageConfig) -> str:
    """The halo tile's dense search (vnlb_tpu/parallel/halo.py:404-408):
    "rows" (K1's tile entry at the lattice sites) for the exact top-K with
    lattice rows, else "full" (K3 planes of every tile row, JAX's all-rows
    ``_search_dense_halo``)."""
    return ("rows" if cfg.dense_rows != "full" and cfg.topk == "exact"
            else "full")


def exec_search_dense_tile(tile: torch.Tensor, sites: torch.Tensor,
                           gy: torch.Tensor, cfg: StageConfig, base_row: int,
                           hp_g: int, coarse: Sequence[torch.Tensor] = (),
                           dist_fn: Callable = patch_dist,
                           tile_fn: Callable = patch_dist_tile,
                           dense_fn: Callable = dense_dist
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-flow top-K search on a halo strip tile, with the global frame's
    out-of-bounds mask.

    tile:     (T, C, Ht, W) search tile (YUV); row 0 is global row
              ``base_row`` (negative on the first strip).
    sites:    (S, 3) lattice sites in tile coordinates.
    gy:       (S,) global rows of the sites (the coarse levels' anchors).
    hp_g:     global H - ps + 1 of the (padded) frame.
    coarse:   the full-frame pooled needle levels 1, 2, ... (searched
              channels only).

    ``tile_search_mode(cfg)`` "rows": level 0 by K1's tile entry
    (``tile_fn``), the coarse levels by K1 (``dist_fn``) at the global
    queries clamped as in ``exec_search_dense``.  "full": K3 planes
    (``dense_fn``) of the tile and the coarse levels with no bf16 rounding,
    as JAX's ``_search_dense_halo``.  Returns (vals, inds) with inds in
    TILE flat coordinates t*(C*Ht*W) + y_t*W + x.
    """
    t_len, _, _, w = tile.shape
    ps, w_s = cfg.ps, cfg.w_s
    ws2 = w_s * w_s
    wp = w - ps + 1
    s_cnt = sites.shape[0]
    dt_lo, n_dt = _dt_span(cfg, t_len)
    dev = tile.device
    sites = sites.to(device=dev, dtype=torch.int64)
    gy = gy.to(device=dev, dtype=torch.int64)
    levels = [tile[:, :cfg.dist_chnls].contiguous()] + list(coarse)
    sites_g = torch.stack([sites[:, 0], gy, sites[:, 2]], dim=1)
    queries = [level_queries(sites if lvl == 0 else sites_g, lvl,
                             v.shape[2], v.shape[3], cfg)
               for lvl, v in enumerate(levels)]

    if tile_search_mode(cfg) == "rows":
        mask, valid = _masker(sites, cfg, t_len, dt_lo, n_dt, None)
        planes = mask(_site_planes(
            levels, queries, cfg, dt_lo, n_dt, dist_fn,
            dist0=lambda *a: tile_fn(*a, base_row, hp_g, wp)), valid)
        full = False
    else:
        oob = tile_oob(sites[:, 1], sites[:, 2], w_s, base_row, hp_g, wp)
        mask, valid = _masker(sites, cfg, t_len, dt_lo, n_dt, oob)
        planes = (mask(cand, valid[di]) for di, cand in enumerate(
            _full_planes(levels, queries, cfg.replace(search_bf16=False),
                         dt_lo, n_dt, dense_fn)))
        full = True
    vals, sel = _select(planes, cfg, s_cnt, n_dt, ws2, full)
    del planes
    return _decode(vals, sel, sites, cfg, dt_lo, tile.shape)
