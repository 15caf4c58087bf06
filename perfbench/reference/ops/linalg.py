"""Batched Cholesky inverse, the plain PyTorch version of
vnlb_tpu/ops/linalg.py (used by the rational filter, ops/spectral.py).

The same vectorized recurrences as the JAX original: a column-by-column
Cholesky factor and a row-by-row forward substitution, each step a
full-width masked update over the whole batch, then A^-1 = L^-T L^-1.
The port keeps the batch leading, (G, n, n).
"""

from __future__ import annotations

import torch


def cholesky_vec(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (G, n, n) SPD matrices."""
    n = a.shape[1]
    idx = torch.arange(n, device=a.device)
    L = torch.zeros_like(a)
    for j in range(n):
        # s[i] = sum_{k<j} L[i,k] L[j,k]   (full width, masked k < j)
        lrow_j = L[:, j, :] * (idx < j).to(a.dtype)
        s = torch.bmm(L, lrow_j[:, :, None])[:, :, 0]
        col = a[:, :, j] - s
        dj = torch.sqrt(torch.clamp(col[:, j], min=1e-20))
        col = col / dj[:, None]
        L[:, :, j] = col * (idx >= j).to(a.dtype)
    return L


def lower_inverse_vec(L: torch.Tensor) -> torch.Tensor:
    """Inverse of (G, n, n) lower-triangular matrices."""
    n = L.shape[1]
    idx = torch.arange(n, device=L.device)
    X = torch.zeros_like(L)
    for i in range(n):
        lrow = L[:, i, :] * (idx < i).to(L.dtype)
        s = torch.bmm(lrow[:, None, :], X)[:, 0, :]
        e = (idx == i).to(L.dtype)
        X[:, i, :] = (e - s) / L[:, i, i][:, None]
    return X


def chol_inverse(mats: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD matrices, (G, n, n) -> (G, n, n)."""
    linv = lower_inverse_vec(cholesky_vec(mats))
    return torch.bmm(linv.transpose(1, 2), linv)
