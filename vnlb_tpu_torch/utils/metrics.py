"""PSNR and SSIM (numpy copy of vnlb_tpu/utils/metrics.py:18-78).  SSIM
follows Wang et al. 2004 with the standard 11x11 Gaussian window."""

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


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g)


def _filter2_valid(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """'valid' 2-D correlation via stride tricks (small window)."""
    kh, kw = win.shape
    h, w = img.shape
    s0, s1 = img.strides
    shape = (h - kh + 1, w - kw + 1, kh, kw)
    patches = np.lib.stride_tricks.as_strided(
        img, shape=shape, strides=(s0, s1, s0, s1), writeable=False)
    return np.tensordot(patches, win, axes=([2, 3], [0, 1]))


def compute_ssim(deno, clean, imax: float = 255.0) -> float:
    """Mean SSIM over frames and channels ((t, c, h, w) inputs)."""
    deno = np.asarray(deno, dtype=np.float64)
    clean = np.asarray(clean, dtype=np.float64)
    if deno.ndim == 3:
        deno, clean = deno[None], clean[None]
    win = _gaussian_window()
    c1 = (0.01 * imax) ** 2
    c2 = (0.03 * imax) ** 2
    vals = []
    for ti in range(deno.shape[0]):
        for ci in range(deno.shape[1]):
            x, y = deno[ti, ci], clean[ti, ci]
            mu_x = _filter2_valid(x, win)
            mu_y = _filter2_valid(y, win)
            mu_xx = _filter2_valid(x * x, win) - mu_x ** 2
            mu_yy = _filter2_valid(y * y, win) - mu_y ** 2
            mu_xy = _filter2_valid(x * y, win) - mu_x * mu_y
            num = (2 * mu_x * mu_y + c1) * (2 * mu_xy + c2)
            den = (mu_x ** 2 + mu_y ** 2 + c1) * (mu_xx + mu_yy + c2)
            vals.append((num / den).mean())
    return float(np.mean(vals))
