"""One denoising pass (``proc_nl``) in PyTorch: vnlb_tpu/pipeline.py for
zero flow, ``border_mode="mask"`` and the exact top-K.

RGB -> YUV, the coverage lattice of sites, then for each chunk of sites:
search (kernel K1 for the distances), patch gather, flat-area flags
(second pass), the econ Bayes filter (kernel K2), ``agg_k`` thinning and the
scatter into the column-space accumulator.  After the last chunk: fold,
normalization with the fallback image, YUV -> RGB.  Chunks bound the
memory; they are processed in site order, so the scatter adds rows in the
same order as one scatter over all sites.  The pass is deterministic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import StageConfig
from .ops import agg, color, flat, gather
from .ops.bayes import bayes_denoise
from .ops.econ_filter import econ_filter, econ_filter_plain
from .ops.mask import lattice_sites
from .ops.patch_dist import patch_dist, patch_dist_plain
from .ops.search_dense import exec_search_dense, search_levels
from .utils.index import check_codec_range

# sites per chunk: bounds the candidate planes, patch gathers and filter
# groups of one step (~2 GB at the 480p second pass)
SITE_CHUNK = 4096


class Kernels(NamedTuple):
    """The two kernel functions a pass calls."""

    patch_dist: object
    econ_filter: object


# the device-dispatching wrappers (kernels on CUDA, plain versions on CPU)
KERNELS = Kernels(patch_dist=patch_dist, econ_filter=econ_filter)
# the plain PyTorch versions on any device (on-card comparison)
PLAIN = Kernels(patch_dist=patch_dist_plain, econ_filter=econ_filter_plain)


def check_supported(cfg: StageConfig) -> None:
    """Raise NotImplementedError for a config outside the ported slice,
    naming the ROADMAP item that brings it."""
    def no(what, item):
        raise NotImplementedError(
            f"vnlb_tpu_torch does not run {what} yet (ROADMAP.md, {item})")

    if cfg.border_mode != "mask":
        no(f"border_mode={cfg.border_mode!r}", "item 8: slide borders and "
           "flow search")
    if cfg.topk != "exact":
        no(f"topk={cfg.topk!r}", "item 9: streaming and approximate top-K")
    if cfg.poly_impl == "pallas":
        no("poly_impl='pallas'", "item 12: kernel K5")
    modes = "item 11: the other filter and aggregation modes"
    if cfg.deno != "bayes":
        no(f"deno={cfg.deno!r}", modes)
    if cfg.eig_method != "poly":
        no(f"eig_method={cfg.eig_method!r}", modes)
    if not cfg.poly_econ:
        no("poly_econ=False", modes)
    if cfg.couple_channels:
        no("couple_channels=True", modes)
    if cfg.npatches < cfg.pdim and not cfg.poly_gram:
        no("poly_gram=False with K < p", modes)
    if cfg.agg_weight != "uniform":
        no(f"agg_weight={cfg.agg_weight!r}", modes)
    if cfg.only_frame >= 0:
        no("only_frame", modes)
    if cfg.agg_bf16:
        no("agg_bf16=True", modes)


def plan_sites(shape, cfg: StageConfig) -> np.ndarray:
    """Sites of the pass, in raster order: with ``border_mode="mask"``
    every lattice site takes the dense search."""
    return lattice_sites(shape, cfg)


def accumulate(noisy_yuv: torch.Tensor, basic_yuv: torch.Tensor,
               srch_yuv: torch.Tensor, sites: torch.Tensor,
               cfg: StageConfig, kernels: Kernels = KERNELS):
    """All sites -> image-space (deno (T, C, H, W), weights (T, H, W))
    accumulators, un-normalized."""
    shape = tuple(noisy_yuv.shape)
    t_len, c, h, w = shape
    hp, wp = h - cfg.ps + 1, w - cfg.ps + 1
    d = c * cfg.ps * cfg.ps
    dev = noisy_yuv.device
    levels = search_levels(srch_yuv, cfg)
    acc = torch.zeros((t_len * hp * wp, cfg.pt * d + 1), dtype=torch.float32,
                      device=dev)
    ka = (cfg.agg_k if cfg.agg_k and cfg.agg_k < cfg.npatches
          else cfg.npatches)

    for s0 in range(0, sites.shape[0], SITE_CHUNK):
        chunk = sites[s0:s0 + SITE_CHUNK]
        vals, inds = exec_search_dense(srch_yuv, chunk, cfg, levels=levels,
                                       dist_fn=kernels.patch_dist)
        f, y, x = gather.decode_corners(inds, shape, cfg.ps, cfg.pt)
        pnoisy = gather.gather_patches(noisy_yuv, f, y, x, cfg.ps, cfg.pt,
                                       cfg.cols_bf16)
        if cfg.step == 1:
            pbasic = gather.gather_patches(basic_yuv, f, y, x, cfg.ps,
                                           cfg.pt, cfg.cols_bf16)
            flags = (flat.flat_areas(pnoisy, cfg.gamma, cfg.sigma2)
                     if cfg.flat_areas else
                     torch.zeros((chunk.shape[0],), dtype=torch.bool,
                                 device=dev))
            pfilt, _ = bayes_denoise(pnoisy, pbasic, flags, cfg,
                                     filter_fn=kernels.econ_filter)
        else:
            pfilt, _ = bayes_denoise(pnoisy, None, None, cfg,
                                     filter_fn=kernels.econ_filter)
        # thin the scatter to the best agg_k candidates (vals ascend); the
        # Bayes prior above used all K
        rows = gather.inds_to_rows(inds[:, :ka], shape, cfg.ps, cfg.pt)
        wts = (inds[:, :ka] >= 0).to(torch.float32)
        agg.agg_rows(acc, pfilt[:, :ka], rows[:, :, 0], wts)
    return agg.fold(acc, cfg.pt, cfg.ps, shape)


def proc_nl(noisy: torch.Tensor, basic: Optional[torch.Tensor],
            clean: Optional[torch.Tensor], cfg: StageConfig,
            kernels: Kernels = KERNELS) -> torch.Tensor:
    """One pass, zero flow: RGB (T, C, H, W) in, RGB denoised out, on the
    device of ``noisy``."""
    check_supported(cfg)
    noisy = noisy.to(torch.float32)
    shape = tuple(int(s) for s in noisy.shape)
    check_codec_range(shape)
    r = cfg.w_s + cfg.ps - 1
    if shape[2] < r or shape[3] < r:
        raise ValueError(
            f"frame {shape[2]}x{shape[3]} smaller than search region "
            f"{r}x{r}; reduce w_s or pad the video")
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
    sites = torch.as_tensor(plan_sites(shape, cfg), device=noisy.device)
    deno_img, wts_img = accumulate(noisy_yuv, basic_yuv, srch, sites, cfg,
                                   kernels)
    fallback = basic_yuv if cfg.step == 1 else noisy_yuv
    return color.yuv2rgb(agg.finalize_img(deno_img, wts_img, fallback))
