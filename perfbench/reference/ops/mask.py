"""Coverage lattice and its interior/border split (numpy copy of
vnlb_tpu/ops/mask.py:25-103).

The lattice is a pure function of the video shape and the stage config:
every frame in [0, T-pt+1), rows ``h % step == phase_h % step`` (phase_h =
frame index, 0 on the last valid frame) plus the first and last valid rows,
columns ``w % step == phase_w % step`` (phase_w = phase_h + h//step, 0 on
the last valid row) plus the first and last valid columns.
"""

from __future__ import annotations

import numpy as np

from ..config import StageConfig


def lattice_mask(shape, cfg: StageConfig, t_origin: int = 0) -> np.ndarray:
    """Boolean (t, h, w) coverage mask."""
    t, c, h, w = shape
    ps, pt, step = cfg.ps, cfg.pt, cfg.step_s
    end_t = t - pt + 1
    end_h = h - ps + 1
    end_w = w - ps + 1
    if end_t <= 0 or end_h <= 0 or end_w <= 0:
        raise ValueError(f"video {shape} smaller than patch ({pt},{ps},{ps})")

    ti = np.arange(end_t)[:, None, None]
    hi = np.arange(end_h)[None, :, None]
    wi = np.arange(end_w)[None, None, :]

    last_t = ti == (end_t - 1)
    phase_h = np.where(last_t, 0, ti + t_origin)

    take_h = (hi % step) == (phase_h % step)
    row_on = take_h | (hi == 0) | (hi == (end_h - 1))

    last_h = hi == (end_h - 1)
    phase_w = np.where(last_h, 0, phase_h + hi // step)
    take_w = (wi % step) == (phase_w % step)
    col_on = take_w | (wi == 0) | (wi == (end_w - 1))

    mask = np.zeros((t, h, w), dtype=bool)
    mask[:end_t, :end_h, :end_w] = row_on & col_on
    return mask


def lattice_sites(shape, cfg: StageConfig, t_origin: int = 0) -> np.ndarray:
    """(S, 3) int32 site coordinates in raster (t, h, w) order."""
    return np.argwhere(lattice_mask(shape, cfg, t_origin)).astype(np.int32)


def interior_split(sites: np.ndarray, shape, cfg: StageConfig):
    """(interior, border) sites (vnlb_tpu/ops/mask.py:86-103): interior
    sites are those whose full-resolution w_s x w_s window never clamps."""
    t, c, h, w = shape
    half = (cfg.w_s - 1) // 2
    ys, xs = sites[:, 1], sites[:, 2]
    ok = ((ys >= half) & (ys <= h - cfg.ps - half)
          & (xs >= half) & (xs <= w - cfg.ps - half))
    return sites[ok], sites[~ok]
