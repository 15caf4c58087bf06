"""The reference-order pass (vnlb_tpu/compat.py): sites drawn at random
from a live work mask, batch by batch, with the reference's paste trick.

* Each batch draws ``cfg.bsize`` sites from the mask
  (``np.random.default_rng(seed)``, as JAX draws them), at most
  ceil(initial sites / bsize) batches, ending early when the mask empties;
* the gather search (``ops/search.exec_search``: K1's window-start entry),
  the patch gather (K4, f32 patches as JAX's ``fill_patches``), the Bayes
  filter (K2 or K5 by mode; flat-area flags in the second pass) or the raw
  patches, and the pixel-space scatter ``ops/agg.agg_patches``;
* after each batch the sites, all K matched corners and, with
  ``cfg.aggre_boost``, their {self, +-1 row, +-1 column} neighbours leave
  the mask (``_update_mask``; only the first ``nkeep`` matches when
  ``nkeep >= 0``).

JAX pads the last batch to ``bsize`` sites (its static shapes) and masks
the padding; the filter is per group, so the port runs the last batch at
its own size.  The mask evolves from the top-K indices, which swap at
near-ties, so a run matches JAX's by PSNR and by the sites drawn, not bit
for bit.  One host round trip per batch: this mode exists for parity
experiments, not speed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import StageConfig, VnlbConfig, default_config
from .ops import agg, color, flat
from .ops.bayes import ave_denoise, bayes_denoise
from .ops.mask import lattice_mask
from .ops.search import exec_search, search_levels
from .pipeline import KERNELS, Kernels, as_video, prep_flows, prepare
from .utils.precision import full_f32


def _update_mask(mask: np.ndarray, inds: np.ndarray, valid: np.ndarray,
                 shape, boost: bool, nkeep: int) -> None:
    """Clear processed sites + their matches (+ paste-trick dilation)."""
    t_len, c, h, w = shape
    chw, hw = c * h * w, h * w
    groups = inds[valid & (inds >= 0).all(axis=1)]
    if nkeep >= 0:
        groups = groups[:, :nkeep]
    if groups.size == 0:
        return
    flat_inds = groups.reshape(-1)
    f = flat_inds // chw
    y = (flat_inds % hw) // w
    x = flat_inds % w
    if boost:
        dy = np.array([0, 0, 0, 1, -1])
        dx = np.array([0, -1, 1, 0, 0])
        f = np.repeat(f, 5)
        y = (y[:, None] + dy[None, :]).reshape(-1)
        x = (x[:, None] + dx[None, :]).reshape(-1)
        ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        f, y, x = f[ok], y[ok], x[ok]
    mask[f, y, x] = False


def proc_nl_compat(noisy: torch.Tensor, basic: Optional[torch.Tensor],
                   clean: Optional[torch.Tensor], fflow, bflow,
                   cfg: StageConfig, seed: int = 0, rand: bool = True,
                   kernels: Kernels = KERNELS) -> torch.Tensor:
    """One pass in the reference's random-masked order: RGB (T, C, H, W)
    in, RGB out, on the device of ``noisy``.  ``fflow``/``bflow`` are (T,
    2, H, W) flows (None: zero); ``rand=False`` takes the mask's sites in
    raster order."""
    noisy_yuv, basic_yuv, srch, fflow, bflow, _ = prepare(
        noisy, basic, clean, fflow, bflow, cfg)
    shape = tuple(noisy_yuv.shape)
    t_len, c, h, w = shape
    dev = noisy_yuv.device
    levels = search_levels(srch, cfg)

    mask = lattice_mask(shape, cfg).copy()
    rng = np.random.default_rng(seed)
    n_batches = max(1, -(-int(mask.sum()) // cfg.bsize))
    deno = torch.zeros((t_len * h * w, c), dtype=torch.float32, device=dev)
    weights = torch.zeros((t_len * h * w,), dtype=torch.float32, device=dev)

    for _ in range(n_batches):
        coords = np.argwhere(mask)
        if coords.shape[0] == 0:
            break
        if rand:
            sites_np = coords[rng.permutation(coords.shape[0])[:cfg.bsize]]
        else:
            sites_np = coords[:cfg.bsize]
        sites = torch.as_tensor(sites_np.astype(np.int32), device=dev)
        _, inds = exec_search(srch, sites, fflow, bflow, cfg, levels=levels,
                              dist_fn=kernels.patch_dist)
        if cfg.deno == "ave":
            (pnoisy,) = kernels.patch_gather([noisy_yuv], inds, cfg.ps,
                                             cfg.pt, False)
            pfilt = ave_denoise(pnoisy, cfg)
        elif cfg.step == 1:
            pnoisy, pbasic = kernels.patch_gather(
                [noisy_yuv, basic_yuv], inds, cfg.ps, cfg.pt, False)
            flags = (flat.flat_areas(pnoisy, cfg.gamma, cfg.sigma2)
                     if cfg.flat_areas else
                     torch.zeros((sites.shape[0],), dtype=torch.bool,
                                 device=dev))
            pfilt, _ = bayes_denoise(pnoisy, pbasic, flags, cfg,
                                     econ_fn=kernels.econ_filter,
                                     poly_fn=kernels.poly_filter)
        else:
            (pnoisy,) = kernels.patch_gather([noisy_yuv], inds, cfg.ps,
                                             cfg.pt, False)
            pfilt, _ = bayes_denoise(pnoisy, None, None, cfg,
                                     econ_fn=kernels.econ_filter,
                                     poly_fn=kernels.poly_filter)
        valid = torch.ones((sites.shape[0],), dtype=torch.bool, device=dev)
        agg.agg_patches(deno, weights, pfilt, inds, valid, cfg.pt, cfg.ps,
                        shape)
        _update_mask(mask, inds.cpu().numpy(),
                     np.ones((sites.shape[0],), bool), shape,
                     boost=cfg.aggre_boost, nkeep=cfg.nkeep)

    fallback = basic_yuv if cfg.step == 1 else noisy_yuv
    return color.yuv2rgb(agg.finalize(deno, weights, fallback, shape))


@full_f32()
def denoise_compat(noisy, sigma: float, flows=None, clean=None,
                   preset: str = "iphone",
                   cfg: Optional[VnlbConfig] = None, seed: int = 0,
                   device="cuda", kernels: Kernels = KERNELS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass VNLB in the reference's random-masked order
    (vnlb_tpu/compat.py:133-146): the first pass draws with ``seed``, the
    second with ``seed + 1``.  Arguments as ``denoise``'s; returns (deno,
    basic) on ``device``."""
    device = torch.device(device)
    cfg = cfg or default_config(sigma, preset=preset)
    noisy_t = as_video(noisy, device)
    fflow, bflow, _ = prep_flows(tuple(noisy_t.shape), flows, device)
    clean_t = None if clean is None else as_video(clean, device)
    basic = proc_nl_compat(noisy_t, None, clean_t, fflow, bflow,
                           cfg.stage(0), seed=seed, kernels=kernels)
    deno = proc_nl_compat(noisy_t, basic, clean_t, fflow, bflow,
                          cfg.stage(1), seed=seed + 1, kernels=kernels)
    return deno, basic
