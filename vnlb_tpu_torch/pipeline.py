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
the raw patches (``deno="ave"``), ``agg_k`` thinning and the scatter into
the column-space accumulator.
After the last chunk: fold, normalization with the fallback image, YUV ->
RGB.  Chunks bound the memory; they are processed in the planned site
order, so the scatter adds rows in the same order as JAX's one scatter over
all site batches.  The pass is deterministic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import StageConfig
from .ops import agg, color, flat, gather
from .ops.bayes import ave_denoise, bayes_denoise
from .ops.dense_dist import dense_dist, dense_dist_plain
from .ops.econ_filter import econ_filter, econ_filter_plain
from .ops.mask import interior_split, lattice_sites
from .ops.patch_dist import patch_dist, patch_dist_plain
from .ops.patch_gather import patch_gather, patch_gather_plain
from .ops.poly_filter import poly_filter, poly_filter_plain
from .ops.search import exec_search, search_levels
from .ops.search_dense import exec_search_dense
from .utils.index import check_codec_range

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


# the device-dispatching wrappers (kernels on CUDA, plain versions on CPU)
KERNELS = Kernels(patch_dist=patch_dist, econ_filter=econ_filter,
                  patch_gather=patch_gather, poly_filter=poly_filter,
                  dense_dist=dense_dist)
# the plain PyTorch versions on any device (on-card comparison)
PLAIN = Kernels(patch_dist=patch_dist_plain, econ_filter=econ_filter_plain,
                patch_gather=patch_gather_plain,
                poly_filter=poly_filter_plain, dense_dist=dense_dist_plain)


def check_supported(cfg: StageConfig) -> None:
    """Raise NotImplementedError for a config outside the ported slice,
    naming the ROADMAP item that brings it."""
    def no(what, item):
        raise NotImplementedError(
            f"vnlb_tpu_torch does not run {what} yet (ROADMAP.md, {item})")

    modes = "item 11: the aggregation modes and the econ left regime"
    p_eff = cfg.pdim * (3 if cfg.couple_channels else 1)   # RGB videos
    if (cfg.eig_method == "poly" and cfg.poly_impl != "pallas"
            and cfg.poly_econ and cfg.npatches < p_eff
            and not cfg.poly_gram):
        no("poly_gram=False with K < p (the econ left regime)", modes)
    if cfg.agg_weight != "uniform":
        no(f"agg_weight={cfg.agg_weight!r}", modes)
    if cfg.only_frame >= 0:
        no("only_frame", modes)
    if cfg.agg_bf16:
        no("agg_bf16=True", modes)
    if cfg.deno not in ("bayes", "ave"):
        raise ValueError(f"unknown deno mode [{cfg.deno}]")


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


def accumulate(noisy_yuv: torch.Tensor, basic_yuv: torch.Tensor,
               srch_yuv: torch.Tensor, fflow: torch.Tensor,
               bflow: torch.Tensor, sites: torch.Tensor, n_dense: int,
               cfg: StageConfig, kernels: Kernels = KERNELS):
    """All sites -> image-space (deno (T, C, H, W), weights (T, H, W))
    accumulators, un-normalized.  Chunks never mix the dense and the
    gather sites."""
    shape = tuple(noisy_yuv.shape)
    t_len, c, h, w = shape
    hp, wp = h - cfg.ps + 1, w - cfg.ps + 1
    d = c * cfg.ps * cfg.ps
    dev = noisy_yuv.device
    levels = search_levels(srch_yuv, cfg)
    dense = None
    if n_dense and cfg.dense_rows == "full":
        # before the accumulator exists: the search's planes and candidate
        # buffer are the pass's largest temporaries
        _, dense = exec_search_dense(srch_yuv, sites[:n_dense], cfg,
                                     levels=levels,
                                     dense_fn=kernels.dense_dist)
    acc = torch.zeros((t_len * hp * wp, cfg.pt * d + 1), dtype=torch.float32,
                      device=dev)
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
            inds = dense[s0:s1]
        elif s0 < n_dense:
            vals, inds = exec_search_dense(srch_yuv, chunk, cfg,
                                           levels=levels,
                                           dist_fn=kernels.patch_dist)
        else:
            vals, inds = exec_search(srch_yuv, chunk, fflow, bflow, cfg,
                                     levels=levels,
                                     dist_fn=kernels.patch_dist)
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
        rows = gather.inds_to_rows(inds[:, :ka], shape, cfg.ps, cfg.pt)
        wts = (inds[:, :ka] >= 0).to(torch.float32)
        agg.agg_rows(acc, pfilt[:, :ka], rows[:, :, 0], wts)
    return agg.fold(acc, cfg.pt, cfg.ps, shape)


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
    sites, n_dense = plan_sites(shape, cfg, zero_flow, t_origin)
    sites = torch.as_tensor(sites, device=noisy.device)
    deno_img, wts_img = accumulate(noisy_yuv, basic_yuv, srch, fflow, bflow,
                                   sites, n_dense, cfg, kernels)
    fallback = basic_yuv if cfg.step == 1 else noisy_yuv
    return color.yuv2rgb(agg.finalize_img(deno_img, wts_img, fallback))
