"""Halo-sharded passes (vnlb_tpu/parallel/halo.py): the frame volume is
split over H across the ranks of a ``Mesh``.

* each rank holds one (T, C, Hs, W) strip of every image and receives the
  ``halo`` rows of its neighbours (``comm.exchange_halos``; zeros past the
  frame), so its tile holds every row that its sites' windows and patches
  touch: halo = (w_s-1)//2 + ps - 1, plus the flow margin, rounded even;
* the needle levels are pooled per strip and gathered along H
  (``comm.all_gather``), so the coarse distances are those of the full
  frame;
* sites are searched, filtered and scattered in their home strip's tile;
  with zero flow the dense search runs on the tile with the GLOBAL frame's
  out-of-bounds mask (``border_mode="mask"``): K1's tile entry at the
  lattice sites, or K3's planes of every tile row for the all-rows and
  non-exact top-K modes; with flow the gather search runs with the global
  row bounds (sliding windows, as on one device);
* the tile accumulators' margins are added to the neighbours' rows
  (``comm.fold_margins``), each strip normalizes, and the strips are
  gathered, so every rank returns the whole output.

``strip_runner`` / ``combine_strips`` run the same per-strip program on one
device without a process group, with the halos and the coarse levels
sliced and pooled from the whole clip; their composition gives the same
bits as the mesh program.  Against the single-device ``proc_nl`` under
``border_mode="mask"`` the output differs by near-tie top-K swaps only
(``tests/test_torch_halo.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import StageConfig, VnlbConfig, default_config
from ..ops import color
from ..ops.mask import lattice_sites
from ..pipeline import (KERNELS, Kernels, Tile, accumulate, check_supported,
                        finish, prep_flows)
from ..utils.index import check_codec_range
from .comm import (Mesh, all_gather, exchange_halos, fold_margins, fold_tile,
                   make_mesh)


def _halo_rows(cfg: StageConfig, flow_margin: int = 0) -> int:
    """Rows each neighbour ships: the window half-span and the patch
    extent, plus the worst vertical drift of a flow-tracked centre; even,
    so that the tile's 2x pooling keeps the global parity."""
    base = (cfg.w_s - 1) // 2 + cfg.ps - 1 + flow_margin
    return base + (base % 2)


def _strip_geometry(shape, cfg: StageConfig, n_dev: int, margin: int = 0):
    """(halo, hs, h_run): the strip height hs is even and, in needle mode,
    divisible by 2^l for every coarse level l that the full frame builds
    (pooling an odd strip would shift every seam), and at least the halo;
    H is padded to h_run = n_dev * hs."""
    _, _, h, w = shape
    halo = _halo_rows(cfg, margin)
    mult = 2
    if cfg.stype == "needle":
        r = cfg.w_s + cfg.ps - 1
        for lvl in range(1, cfg.needle_scales):
            if (h >> lvl) >= r and (w >> lvl) >= r:
                mult = max(mult, 2 ** lvl)

    def rup(x, m):
        return -(-x // m) * m

    hs = max(rup(-(-h // n_dev), mult), rup(halo, mult))
    return halo, hs, hs * n_dev


def _pool2(v: torch.Tensor) -> torch.Tensor:
    """2x average pooling of (..., H, W), odd sizes truncated, as four
    elementwise adds: a strip and the full frame give the same bits at the
    same pixel, whatever the tensor's size."""
    h2, w2 = v.shape[-2] // 2 * 2, v.shape[-1] // 2 * 2
    v = v[..., :h2, :w2]
    return (v[..., 0::2, 0::2] + v[..., 0::2, 1::2] + v[..., 1::2, 0::2]
            + v[..., 1::2, 1::2]) * 0.25


def _coarse(srch: torch.Tensor, cfg: StageConfig, hs: int,
            mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Full-frame needle levels 1, 2, ... of the searched channels: the
    strip ``srch`` (hs rows) pooled and gathered along H over ``mesh``, or,
    without a mesh, ``srch`` the full frame pooled.  A level is built while
    the strip height halves evenly and the level holds a search region, so
    both give the same levels and the same values."""
    if cfg.stype != "needle":
        return []
    r = cfg.w_s + cfg.ps - 1
    levels, cur, cur_hs = [], srch[:, :cfg.dist_chnls], hs
    for _ in range(1, cfg.needle_scales):
        if cur_hs % 2:
            break
        cur_hs //= 2
        cur = _pool2(cur)
        full = cur if mesh is None else all_gather(cur, mesh, dim=2)
        if full.shape[2] < r or full.shape[3] < r:
            break
        levels.append(full.contiguous())
    return levels


def _plan_strip_sites(shape, cfg: StageConfig, n_dev: int, halo: int,
                      strip: int, t_origin: int = 0):
    """The lattice sites of home strip ``strip`` in raster order: (sites
    (S, 3) int32 in tile coordinates, their global rows (S,))."""
    hs = shape[2] // n_dev
    sites = lattice_sites(shape, cfg, t_origin)
    r0 = strip * hs
    s = sites[(sites[:, 1] >= r0) & (sites[:, 1] < r0 + hs)].copy()
    gy = s[:, 1].copy()
    s[:, 1] += halo - r0
    return s, gy


def _tile_pass(n_tile, b_tile, ff_tile, bf_tile, sites, gy, coarse,
               cfg: StageConfig, base_row: int, h_run: int,
               kernels: Kernels):
    """One strip's accumulators (deno, weights) over its tile, whose row 0
    is global row ``base_row``.  With flow tiles, the gather search with
    the global row bounds; else the dense tile search under mask
    borders."""
    srch = b_tile if cfg.srch_img == "basic" else n_tile
    tile = Tile(base_row, h_run, gy, coarse)
    if ff_tile is not None:
        return accumulate(n_tile, b_tile, srch, ff_tile, bf_tile, sites, 0,
                          cfg, kernels, tile)
    return accumulate(n_tile, b_tile, srch, None, None, sites, len(sites),
                      cfg.replace(border_mode="mask"), kernels, tile)


def _host(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def _pad_rows(x: Optional[np.ndarray], h_run: int):
    if x is None or x.shape[2] == h_run:
        return x
    pad = ((0, 0), (0, 0), (0, h_run - x.shape[2]), (0, 0))
    return np.pad(x, pad, mode="edge")


def proc_nl_halo(noisy, basic, fflow, bflow, cfg: StageConfig, mesh: Mesh,
                 t_origin: int = 0, kernels: Kernels = KERNELS
                 ) -> torch.Tensor:
    """One pass with the clip split over H across ``mesh`` (an SPMD call:
    every rank passes the whole host clip and gets the whole RGB output
    on its device).

    Nonzero flows widen the halo by the worst vertical drift, ceil(nwt *
    max|flow_v|), and take the gather search with global row bounds
    (sliding windows); zero flow takes the dense tile search under mask
    borders.  When H does not split into valid strips (``_strip_geometry``)
    the clip is edge-padded at the bottom and the output cropped.
    """
    check_supported(cfg)
    noisy_np = _host(noisy)
    shape = tuple(int(s) for s in noisy_np.shape)
    check_codec_range(shape)
    basic_np = _host(basic)
    t_len, c, h, w = shape
    zeros = np.zeros((t_len, 2, h, w), np.float32)
    fflow_np = zeros if fflow is None else _host(fflow)
    bflow_np = zeros if bflow is None else _host(bflow)
    use_flow = bool(fflow_np.any() or bflow_np.any())

    n_dev = mesh.size
    margin = 0
    if use_flow:
        nwt = max(cfg.nwt_b, cfg.nwt_f)
        mv = max(float(np.abs(fflow_np[:, 1]).max()),
                 float(np.abs(bflow_np[:, 1]).max()))
        margin = int(math.ceil(nwt * mv))
    halo = _halo_rows(cfg, margin)
    if h // n_dev < halo:
        raise ValueError(
            f"H={h} gives strips of {h // n_dev} rows < halo {halo} on "
            f"{n_dev} ranks (halo includes flow margin {margin}); use fewer "
            f"ranks or a taller video")
    _, hs, h_run = _strip_geometry(shape, cfg, n_dev, margin)
    noisy_np, basic_np = _pad_rows(noisy_np, h_run), _pad_rows(basic_np, h_run)
    run_shape = (t_len, c, h_run, w)
    sites, gy = _plan_strip_sites(run_shape, cfg, n_dev, halo, mesh.rank,
                                  t_origin)

    dev = mesh.device
    rows = slice(mesh.rank * hs, (mesh.rank + 1) * hs)

    def strip(x):
        return torch.from_numpy(np.ascontiguousarray(x[:, :, rows])).to(dev)

    n_strip = color.rgb2yuv(strip(noisy_np))
    b_strip = n_strip if basic_np is None else color.rgb2yuv(strip(basic_np))
    n_tile = exchange_halos(n_strip, halo, mesh)
    b_tile = n_tile if basic_np is None else exchange_halos(b_strip, halo,
                                                            mesh)
    srch_strip = b_strip if cfg.srch_img == "basic" else n_strip
    coarse = _coarse(srch_strip, cfg, hs, mesh)
    ff_tile = bf_tile = None
    if use_flow:
        ff_tile = exchange_halos(strip(_pad_rows(fflow_np, h_run)), halo,
                                 mesh)
        bf_tile = exchange_halos(strip(_pad_rows(bflow_np, h_run)), halo,
                                 mesh)
    deno, wts = _tile_pass(n_tile, b_tile, ff_tile, bf_tile,
                           torch.as_tensor(sites, device=dev),
                           torch.as_tensor(gy, device=dev), coarse, cfg,
                           mesh.rank * hs - halo, h_run, kernels)
    deno = fold_margins(deno, halo, mesh)
    wts = fold_margins(wts, halo, mesh)
    out = finish(deno, wts, n_strip, b_strip, cfg)
    return all_gather(out, mesh, dim=2)[:, :, :h]


def strip_runner(noisy, basic, cfg: StageConfig, n_dev: int, strip_idx: int,
                 t_origin: int = 0, device="cuda",
                 kernels: Kernels = KERNELS):
    """Strip ``strip_idx`` of the ``n_dev``-strip zero-flow halo program on
    one device, without a process group: the halo rows are sliced from the
    whole clip (zeros past the frame) and the coarse levels pooled from it,
    as the mesh's collectives would deliver them.

    Returns (run, meta): ``run()`` computes the strip's tile accumulators
    (deno (T, C, hs + 2*halo, W), weights (T, hs + 2*halo, W)) from inputs
    already on ``device``; ``combine_strips`` overlap-adds a full set into
    the mesh program's output."""
    check_supported(cfg)
    noisy_np = _host(noisy)
    shape = tuple(int(s) for s in noisy_np.shape)
    check_codec_range(shape)
    t_len, c, h, w = shape
    halo, hs, h_run = _strip_geometry(shape, cfg, n_dev)
    run_shape = (t_len, c, h_run, w)
    sites, gy = _plan_strip_sites(run_shape, cfg, n_dev, halo, strip_idx,
                                  t_origin)
    device = torch.device(device)
    noisy_yuv = color.rgb2yuv(torch.from_numpy(
        _pad_rows(noisy_np, h_run)).to(device))
    basic_yuv = noisy_yuv if basic is None else color.rgb2yuv(
        torch.from_numpy(_pad_rows(_host(basic), h_run)).to(device))
    base_row = strip_idx * hs - halo

    def tile_of(img):
        tile = img.new_zeros((t_len, c, hs + 2 * halo, w))
        lo, hi = max(base_row, 0), min(base_row + hs + 2 * halo, h_run)
        tile[:, :, lo - base_row:hi - base_row] = img[:, :, lo:hi]
        return tile

    n_tile = tile_of(noisy_yuv)
    b_tile = n_tile if basic is None else tile_of(basic_yuv)
    srch = basic_yuv if cfg.srch_img == "basic" else noisy_yuv
    coarse = _coarse(srch, cfg, hs)
    sites_t = torch.as_tensor(sites, device=device)
    gy_t = torch.as_tensor(gy, device=device)
    meta = dict(halo=halo, hs=hs, h_run=h_run, h=h, shape=run_shape,
                sites=len(sites))

    def run():
        return _tile_pass(n_tile, b_tile, None, None, sites_t, gy_t, coarse,
                          cfg, base_row, h_run, kernels)

    return run, meta


def proc_nl_strip_single(noisy, basic, cfg: StageConfig, n_dev: int,
                         strip_idx: int, t_origin: int = 0, device="cuda",
                         kernels: Kernels = KERNELS):
    """``strip_runner`` run once: (deno_tile, wts_tile, meta)."""
    run, meta = strip_runner(noisy, basic, cfg, n_dev, strip_idx, t_origin,
                             device, kernels)
    deno, wts = run()
    return deno, wts, meta


def combine_strips(tiles, cfg: StageConfig, noisy, basic,
                   meta) -> torch.Tensor:
    """The mesh program's margin fold and normalization over a full set of
    strip tiles [(deno_tile, wts_tile)] for strips 0..n-1, on the tiles'
    device: the whole RGB output."""
    halo, h_run, h = meta["halo"], meta["h_run"], meta["h"]
    n = len(tiles)
    dev = tiles[0][0].device
    cores = []
    for j in (0, 1):
        cores.append(torch.cat([
            fold_tile(tiles[i][j], halo,
                      tiles[i - 1][j][..., -halo:, :] if i > 0 else None,
                      tiles[i + 1][j][..., :halo, :] if i + 1 < n else None)
            for i in range(n)], dim=-2))
    noisy_yuv = color.rgb2yuv(torch.from_numpy(
        _pad_rows(_host(noisy), h_run)).to(dev))
    basic_yuv = noisy_yuv if basic is None else color.rgb2yuv(
        torch.from_numpy(_pad_rows(_host(basic), h_run)).to(dev))
    return finish(cores[0], cores[1], noisy_yuv, basic_yuv, cfg)[:, :, :h]


def denoise_halo(noisy, sigma: float, mesh: Optional[Mesh] = None,
                 flows=None, preset: str = "iphone",
                 cfg: Optional[VnlbConfig] = None,
                 kernels: Kernels = KERNELS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass VNLB with the clip split over H across the mesh: (deno,
    basic), whole, on the rank's device."""
    mesh = mesh or make_mesh(axis="h")
    cfg = cfg or default_config(sigma, preset=preset)
    fflow, bflow, _ = prep_flows(tuple(np.shape(noisy)), flows)
    basic = proc_nl_halo(noisy, None, fflow, bflow, cfg.stage(0), mesh,
                         kernels=kernels)
    deno = proc_nl_halo(noisy, basic, fflow, bflow, cfg.stage(1), mesh,
                        kernels=kernels)
    return deno, basic
