"""PSNR (numpy copy of vnlb_tpu/utils/metrics.py:25-37)."""

from __future__ import annotations

import warnings

import numpy as np


def _check_imax(a, b, imax):
    mm = float(min(np.max(a), np.max(b)))
    if np.isclose(imax, 255.0) and mm < 10.0:
        warnings.warn("[compute_psnrs] imax = 255 but images.max ~= 1.")
    elif np.isclose(imax, 1.0) and mm > 10.0:
        warnings.warn("[compute_psnrs] imax = 1. but images.max ~= 255.")


def compute_psnrs(deno, clean, imax: float = 255.0) -> np.ndarray:
    """Per-frame PSNR in dB over (..., c, h, w)."""
    deno = np.asarray(deno, dtype=np.float64)
    clean = np.asarray(clean, dtype=np.float64)
    _check_imax(deno, clean, imax)
    mse = ((deno / imax - clean / imax) ** 2).mean(axis=(-3, -2, -1))
    return -10.0 * np.log10(np.maximum(mse, 1e-20))


def compute_psnr(deno, clean, imax: float = 255.0) -> float:
    """Mean PSNR over frames."""
    return float(compute_psnrs(deno, clean, imax).mean())
