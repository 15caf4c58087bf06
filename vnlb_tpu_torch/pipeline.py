"""One denoising pass (``proc_nl``) in PyTorch: vnlb_tpu/pipeline.py with
every top-K mode, both dense row modes, both border modes, zero or
user-given flow.

RGB -> YUV, the coverage lattice of sites in search order (``plan_sites``),
then, under ``dense_rows="full"``, the dense search of every dense site in
one call (kernel K3's all-pixel planes are shared by all of them, as JAX's
``precompute_inds`` shares them), then for each chunk of sites: search
(the dense zero-flow search or the per-site gather search, kernel K1 for
the distances of both, unless the first phase searched them), patch gather
(kernel K4), flat-area flags (second pass), the Bayes filter in any of its
modes (the econ filter is kernel K2, the two-factor filter kernel K5) or
the raw patches (``deno="ave"``), ``agg_k`` thinning, the aggregation
weights (``agg_weights``: ``only_frame``, ``agg_weight="exp"``) and the
scatter into the column-space accumulator (kernel K6; ``agg_bf16`` rounds
its update rows).
After the last chunk: fold, normalization with the fallback image, YUV ->
RGB.  Chunks bound the memory; they are processed in the planned site
order, so the scatter adds rows in the same order as JAX's one scatter over
all site batches.  The pass is deterministic.  The rolling stream of
``denoise_streaming`` (streaming.py) calls ``accumulate`` on a temporal
slab of the clip with its live accumulator (``Live``), and folds and
finishes the complete frames itself.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import StageConfig
from .ops import agg, color, flat, gather
from .ops.bayes import ave_denoise, bayes_denoise
from .ops.dense_dist import dense_dist, dense_dist_plain
from .ops.econ_filter import econ_filter, econ_filter_plain
from .ops.mask import interior_split, lattice_sites
from .ops.patch_dist import (patch_dist, patch_dist_plain, patch_dist_tile,
                             patch_dist_tile_plain)
from .ops.patch_gather import patch_gather, patch_gather_plain
from .ops.poly_filter import poly_filter, poly_filter_plain
from .ops.scatter_rows import scatter_rows, scatter_rows_plain
from .ops.search import exec_search, search_levels
from .ops.search_dense import (exec_search_dense, exec_search_dense_tile,
                                tile_search_mode)
from .utils.flow_io import expand_flows
from .utils.index import check_codec_range
from .utils.timer import span

# sites per chunk: bounds the candidate planes, patch gathers and filter
# groups of one step (~2 GB at the 480p second pass)
SITE_CHUNK = 4096


class Kernels(NamedTuple):
    """The kernel functions a pass calls."""

    patch_dist: object
    econ_filter: object
    patch_gather: object
    poly_filter: object
    dense_dist: object
    patch_dist_tile: object
    scatter_rows: object


# the device-dispatching wrappers (kernels on CUDA, plain versions on CPU)
KERNELS = Kernels(patch_dist=patch_dist, econ_filter=econ_filter,
                  patch_gather=patch_gather, poly_filter=poly_filter,
                  dense_dist=dense_dist, patch_dist_tile=patch_dist_tile,
                  scatter_rows=scatter_rows)
# the plain PyTorch versions on any device (on-card comparison)
PLAIN = Kernels(patch_dist=patch_dist_plain, econ_filter=econ_filter_plain,
                patch_gather=patch_gather_plain,
                poly_filter=poly_filter_plain, dense_dist=dense_dist_plain,
                patch_dist_tile=patch_dist_tile_plain,
                scatter_rows=scatter_rows_plain)


def check_supported(cfg: StageConfig) -> None:
    """Raise ValueError for an unknown ``deno`` mode."""
    if cfg.deno not in ("bayes", "ave"):
        raise ValueError(f"unknown deno mode [{cfg.deno}]")


def agg_weights(vals: torch.Tensor, inds: torch.Tensor, shape,
                cfg: StageConfig, ka: int, t0: int = 0) -> torch.Tensor:
    """(B, ka) aggregation weights of the best ``ka`` candidates
    (vnlb_tpu/pipeline.py:227-249): valid candidates (``inds >= 0``);
    with ``only_frame >= 0`` only those whose decoded corner frame (plus
    ``t0``, a slab's first global frame) is that frame; with
    ``agg_weight="exp"`` each weighted by
    exp(-max(val, 0) * 255^2 / (agg_h * sigma^2))."""
    t_len, c, h, w = shape
    valid = inds >= 0
    if cfg.only_frame >= 0:
        f = torch.clamp(torch.clamp(inds.long(), min=0) // (c * h * w),
                        0, t_len - cfg.pt)
        valid = valid & (f + t0 == cfg.only_frame)
    wts = valid[:, :ka].to(torch.float32)
    if cfg.agg_weight == "exp":
        wts = wts * torch.exp(-torch.clamp(vals[:, :ka], min=0.0)
                              * (255.0 ** 2) / (cfg.agg_h * cfg.sigma2))
    return wts


def plan_sites(shape, cfg: StageConfig, zero_flow: bool, t_origin: int = 0):
    """Sites of the pass in search order (vnlb_tpu/pipeline.py:341-368):
    (sites (S, 3) int32, n_dense).  The first ``n_dense`` sites take the
    dense zero-flow search, the rest the per-site gather search.
    ``t_origin`` anchors the lattice phases to global frame indices
    (streaming windows).

    * nonzero flow: every lattice site, raster order, gather search;
    * zero flow, ``border_mode="mask"``: every site, dense search;
    * zero flow, ``border_mode="slide"``: interior sites (dense search),
      then border sites (gather search)."""
    sites = lattice_sites(shape, cfg, t_origin)
    if not zero_flow:
        return sites, 0
    if cfg.border_mode == "mask":
        return sites, sites.shape[0]
    interior, border = interior_split(sites, shape, cfg)
    return np.concatenate([interior, border]), interior.shape[0]


class Tile(NamedTuple):
    """Where a halo strip tile of the H-sharded pass (parallel/halo.py)
    lies in the frame: tile row 0 is global row ``base_row`` of a frame of
    ``h_run`` rows; ``gy`` (S,) holds the sites' global rows and
    ``coarse`` the full-frame pooled needle levels 1, 2, ... (searched
    channels)."""

    base_row: int
    h_run: int
    gy: torch.Tensor
    coarse: Sequence[torch.Tensor]


class Live(NamedTuple):
    """Where a temporal slab of a streamed pass (streaming.py) lies in its
    clip: slab frame 0 is global frame ``t0`` of a clip of ``t_clip``
    frames.  ``acc`` is the pass's live accumulator, (slots * H' * W', pt
    * D + 1): the rows of global frame g at slot g mod slots."""

    t0: int
    t_clip: int
    acc: torch.Tensor


def accumulate(noisy_yuv: torch.Tensor, basic_yuv: torch.Tensor,
               srch_yuv: torch.Tensor, fflow: torch.Tensor,
               bflow: torch.Tensor, sites: torch.Tensor, n_dense: int,
               cfg: StageConfig, kernels: Kernels = KERNELS,
               tile: Optional[Tile] = None, live: Optional[Live] = None):
    """All sites -> image-space (deno (T, C, H, W), weights (T, H, W))
    accumulators over the shape of ``noisy_yuv``, un-normalized.  Chunks
    never mix the dense and the gather sites.

    With ``tile`` the inputs are a halo strip tile: the dense sites take
    ``exec_search_dense_tile`` (the global frame's out-of-bounds mask), the
    gather sites the global row bounds, and both the full-frame coarse
    levels.  A search whose planes every site shares (``dense_rows="full"``,
    and any all-rows tile search) runs once over all dense sites first.

    With ``live`` the inputs are a temporal slab: both searches take the
    clip's temporal bounds, the rows go into ``live.acc``, and nothing is
    folded or returned (the stream retires complete frames itself)."""
    shape = tuple(noisy_yuv.shape)
    t_len, c, h, w = shape
    hp, wp = h - cfg.ps + 1, w - cfg.ps + 1
    d = c * cfg.ps * cfg.ps
    dev = noisy_yuv.device
    t_bounds = None if live is None else (live.t0, live.t_clip)
    if tile is None:
        levels = search_levels(srch_yuv, cfg)
        whole_dense = cfg.dense_rows == "full"
        y_bounds = None

        def dense_search(s0, s1):
            return exec_search_dense(srch_yuv, sites[s0:s1], cfg,
                                     levels=levels,
                                     dist_fn=kernels.patch_dist,
                                     dense_fn=kernels.dense_dist,
                                     t_bounds=t_bounds)
    else:
        levels = [srch_yuv[:, :cfg.dist_chnls].contiguous(), *tile.coarse]
        whole_dense = tile_search_mode(cfg) == "full"
        y_bounds = (-tile.base_row, tile.h_run - 1 - tile.base_row)

        def dense_search(s0, s1):
            return exec_search_dense_tile(
                srch_yuv, sites[s0:s1], tile.gy[s0:s1], cfg, tile.base_row,
                tile.h_run - cfg.ps + 1, tile.coarse,
                dist_fn=kernels.patch_dist, tile_fn=kernels.patch_dist_tile,
                dense_fn=kernels.dense_dist)
    dense = dense_vals = None
    if n_dense and whole_dense:
        # before the accumulator exists: the search's planes and candidate
        # buffer are the pass's largest temporaries
        dense_vals, dense = dense_search(0, n_dense)
    if live is None:
        acc, t0, slots = torch.zeros((t_len * hp * wp, cfg.pt * d + 1),
                                     dtype=torch.float32, device=dev), 0, None
    else:
        acc, t0 = live.acc, live.t0
        slots = acc.shape[0] // (hp * wp)
    ka = (cfg.agg_k if cfg.agg_k and cfg.agg_k < cfg.npatches
          else cfg.npatches)
    s_cnt = sites.shape[0]
    bounds = ([(s0, min(s0 + SITE_CHUNK, n_dense))
               for s0 in range(0, n_dense, SITE_CHUNK)]
              + [(s0, min(s0 + SITE_CHUNK, s_cnt))
                 for s0 in range(n_dense, s_cnt, SITE_CHUNK)])

    for s0, s1 in bounds:
        chunk = sites[s0:s1]
        if s0 < n_dense and dense is not None:
            vals, inds = dense_vals[s0:s1], dense[s0:s1]
        elif s0 < n_dense:
            vals, inds = dense_search(s0, s1)
        else:
            vals, inds = exec_search(srch_yuv, chunk, fflow, bflow, cfg,
                                     levels=levels,
                                     dist_fn=kernels.patch_dist,
                                     y_bounds=y_bounds, t_bounds=t_bounds)
        if cfg.deno == "ave":
            (pnoisy,) = kernels.patch_gather([noisy_yuv], inds, cfg.ps,
                                             cfg.pt, cfg.cols_bf16)
            pfilt = ave_denoise(pnoisy, cfg)
        elif cfg.step == 1:
            pnoisy, pbasic = kernels.patch_gather(
                [noisy_yuv, basic_yuv], inds, cfg.ps, cfg.pt, cfg.cols_bf16)
            flags = (flat.flat_areas(pnoisy, cfg.gamma, cfg.sigma2)
                     if cfg.flat_areas else
                     torch.zeros((chunk.shape[0],), dtype=torch.bool,
                                 device=dev))
            pfilt, _ = bayes_denoise(pnoisy, pbasic, flags, cfg,
                                     econ_fn=kernels.econ_filter,
                                     poly_fn=kernels.poly_filter)
        else:
            (pnoisy,) = kernels.patch_gather([noisy_yuv], inds, cfg.ps,
                                             cfg.pt, cfg.cols_bf16)
            pfilt, _ = bayes_denoise(pnoisy, None, None, cfg,
                                     econ_fn=kernels.econ_filter,
                                     poly_fn=kernels.poly_filter)
        # thin the scatter to the best agg_k candidates (vals ascend); the
        # Bayes prior above used all K
        rows = gather.inds_to_rows(inds[:, :ka], shape, cfg.ps, cfg.pt, t0,
                                   slots)
        wts = agg_weights(vals, inds, shape, cfg, ka, t0)
        agg.agg_rows(acc, pfilt, rows[:, :, 0], wts, kernels.scatter_rows,
                     bf16=cfg.agg_bf16)
    if live is None:
        return agg.fold(acc, cfg.pt, cfg.ps, shape)


def as_video(x, device) -> torch.Tensor:
    """A (T, C, H, W) video, numpy or torch, as f32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def prep_flows(noisy_shape, flows, device="cpu"):
    """(fflow, bflow, zero_flow) for a two-pass call (vnlb_tpu/api.py:28-50):
    ``flows`` is None (zero flow), a (fflow, bflow) pair or a dict with
    those keys, each (T, 2, H, W) or (T-1, 2, H, W); (T-1)-frame stacks are
    edge-replicated to T frames.  The flows come back as f32 tensors on
    ``device``; the flag says whether both are all zero."""
    t, _, h, w = noisy_shape
    if flows is None:
        z = torch.zeros((t, 2, h, w), dtype=torch.float32, device=device)
        return z, z, True
    if isinstance(flows, dict):
        fflow, bflow = flows["fflow"], flows["bflow"]
    else:
        fflow, bflow = flows
    fflow = np.asarray(fflow.cpu() if isinstance(fflow, torch.Tensor)
                       else fflow, np.float32)
    bflow = np.asarray(bflow.cpu() if isinstance(bflow, torch.Tensor)
                       else bflow, np.float32)
    if fflow.shape[0] == t - 1:
        fflow, bflow = expand_flows(fflow, bflow)
    if fflow.shape[0] != t or bflow.shape[0] != t:
        raise ValueError(f"flows must have {t} or {t - 1} frames")
    zero = bool(not fflow.any() and not bflow.any())
    return (torch.as_tensor(fflow, device=device),
            torch.as_tensor(bflow, device=device), zero)


def _as_flow(flow, shape, device) -> torch.Tensor:
    t_len, _, h, w = shape
    if flow is None:
        return torch.zeros((t_len, 2, h, w), dtype=torch.float32,
                           device=device)
    if isinstance(flow, torch.Tensor):
        flow = flow.to(device=device, dtype=torch.float32)
    else:
        flow = torch.as_tensor(np.asarray(flow, np.float32), device=device)
    if tuple(flow.shape) != (t_len, 2, h, w):
        raise ValueError(f"flow must be {(t_len, 2, h, w)}, got "
                         f"{tuple(flow.shape)}")
    return flow


def prepare(noisy: torch.Tensor, basic: Optional[torch.Tensor],
            clean: Optional[torch.Tensor], fflow, bflow, cfg: StageConfig,
            zero_flow: Optional[bool] = None):
    """A pass's inputs on the device of ``noisy``: (noisy_yuv, basic_yuv,
    srch_yuv, fflow, bflow, zero_flow), after the config and size
    checks."""
    check_supported(cfg)
    noisy = noisy.to(torch.float32)
    shape = tuple(int(s) for s in noisy.shape)
    check_codec_range(shape)
    r = cfg.w_s + cfg.ps - 1
    if shape[2] < r or shape[3] < r:
        raise ValueError(
            f"frame {shape[2]}x{shape[3]} smaller than search region "
            f"{r}x{r}; reduce w_s or pad the video")
    fflow = _as_flow(fflow, shape, noisy.device)
    bflow = _as_flow(bflow, shape, noisy.device)
    if zero_flow is None:
        zero_flow = not bool(fflow.any()) and not bool(bflow.any())
    basic = noisy if basic is None else basic.to(torch.float32)
    noisy_yuv = color.rgb2yuv(noisy)
    basic_yuv = color.rgb2yuv(basic)
    if cfg.srch_img == "noisy":
        srch = noisy_yuv
    elif cfg.srch_img == "basic":
        srch = basic_yuv
    elif cfg.srch_img == "clean":
        srch = color.rgb2yuv(noisy if clean is None
                             else clean.to(torch.float32))
    else:
        raise ValueError(f"unknown srch_img [{cfg.srch_img}]")
    return noisy_yuv, basic_yuv, srch, fflow, bflow, zero_flow


def finish(deno_img: torch.Tensor, wts_img: torch.Tensor,
           noisy_yuv: torch.Tensor, basic_yuv: torch.Tensor,
           cfg: StageConfig) -> torch.Tensor:
    """Normalized accumulators (the fallback image where no patch landed)
    -> RGB."""
    fallback = basic_yuv if cfg.step == 1 else noisy_yuv
    return color.yuv2rgb(agg.finalize_img(deno_img, wts_img, fallback))


def proc_nl(noisy: torch.Tensor, basic: Optional[torch.Tensor],
            clean: Optional[torch.Tensor], fflow, bflow, cfg: StageConfig,
            zero_flow: Optional[bool] = None, t_origin: int = 0,
            kernels: Kernels = KERNELS) -> torch.Tensor:
    """One pass: RGB (T, C, H, W) in, RGB denoised out, on the device of
    ``noisy``.  ``fflow``/``bflow`` are (T, 2, H, W) flows (None: zero).
    ``zero_flow`` selects the dense search for the planned sites; when
    None it is detected from the flow values.  ``t_origin`` is the global
    index of frame 0 (streaming windows align their lattices with the
    whole clip's)."""
    with span("vnlb.pass.prepare"):
        noisy_yuv, basic_yuv, srch, fflow, bflow, zero_flow = prepare(
            noisy, basic, clean, fflow, bflow, cfg, zero_flow)
    shape = tuple(noisy_yuv.shape)
    with span("vnlb.pass.plan"):
        sites, n_dense = plan_sites(shape, cfg, zero_flow, t_origin)
        with span("vnlb.sync.sites"):
            sites = torch.as_tensor(sites, device=noisy_yuv.device)
    deno_img, wts_img = accumulate(noisy_yuv, basic_yuv, srch, fflow, bflow,
                                   sites, n_dense, cfg, kernels)
    with span("vnlb.pass.finish"):
        return finish(deno_img, wts_img, noisy_yuv, basic_yuv, cfg)
