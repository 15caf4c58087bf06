"""Batched symmetric eigendecomposition by cyclic Jacobi, the plain PyTorch
version of vnlb_tpu/ops/eigh.py (``eig_method="jacobi"``).

The same algorithm as the JAX original, step for step: batch-trailing
(n, n, G) layout, the round-robin schedule of n/2 disjoint rotations per
round (n-1 rounds per sweep), LAPACK's rotation angle, rows and columns
updated with static gathers and an inverse permutation, an odd n padded
with a decoupled zero row and column.  Eigenvalues come back descending.
"""

from __future__ import annotations

import numpy as np
import torch


def _round_robin_schedule(n: int) -> np.ndarray:
    """(n-1, 2, n/2) int32: disjoint (p, q) pairs per round, visiting every
    unordered pair exactly once (circle method; player 0 fixed)."""
    assert n % 2 == 0
    m = n // 2
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        ps = [0] + others[:m - 1]
        qs = others[m - 1:][::-1]
        pairs = np.array([ps, qs])
        pairs = np.sort(pairs, axis=0)  # ensure p < q
        rounds.append(pairs)
        others = [others[-1]] + others[:-1]
    return np.stack(rounds).astype(np.int32)


def jacobi_eigh(mats: torch.Tensor, sweeps: int = 8):
    """(G, n, n) f32 symmetric -> (evals (G, n) descending, evecs (G, n, n),
    evecs[g, :, i] the eigenvector of evals[g, i])."""
    g, n, n2 = mats.shape
    assert n == n2, mats.shape
    dev = mats.device
    pad = n % 2
    m = n + pad
    a = mats.permute(1, 2, 0)                              # (n, n, G)
    if pad:
        a = torch.nn.functional.pad(a, (0, 0, 0, 1, 0, 1))
    v = torch.eye(m, dtype=mats.dtype, device=dev)[:, :, None].expand(
        m, m, g).contiguous()
    sched = _round_robin_schedule(m)
    rounds = []
    for r in range(m - 1):
        perm = np.concatenate([sched[r, 0], sched[r, 1]])
        inv = np.empty(m, np.int64)
        inv[perm] = np.arange(m)
        rounds.append(tuple(torch.as_tensor(x, dtype=torch.long, device=dev)
                            for x in (sched[r, 0], sched[r, 1], inv)))

    for _ in range(sweeps):
        for p, q, inv in rounds:
            app = a[p, p, :]                               # (npairs, G)
            aqq = a[q, q, :]
            apq = a[p, q, :]
            small = apq.abs() < 1e-30
            apq_safe = torch.where(small, torch.ones_like(apq), apq)
            tau = (aqq - app) / (2.0 * apq_safe)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0.0, torch.ones_like(t), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            c = torch.where(small, torch.ones_like(c), c)
            s = torch.where(small, torch.zeros_like(s), s)

            cb, sb = c[:, None, :], s[:, None, :]
            ap, aq = a[p], a[q]                            # row rotation
            a = torch.cat([cb * ap - sb * aq, sb * ap + cb * aq], 0)[inv]
            cc, sc = c[None], s[None]
            ap, aq = a[:, p], a[:, q]                      # column rotation
            a = torch.cat([cc * ap - sc * aq, sc * ap + cc * aq], 1)[:, inv]
            vp, vq = v[:, p], v[:, q]                      # V <- V J
            v = torch.cat([cc * vp - sc * vq, sc * vp + cc * vq], 1)[:, inv]

    idx = torch.arange(m, device=dev)
    evals = a[idx, idx, :].T                               # (G, m)
    evecs = v.permute(2, 0, 1)                             # (G, m, m)
    if pad:
        evals = evals[:, :n]
        evecs = evecs[:, :n, :n]
    order = torch.argsort(-evals, dim=1, stable=True)      # descending
    evals = torch.take_along_dim(evals, order, dim=1)
    evecs = torch.take_along_dim(evecs, order[:, None, :], dim=2)
    return evals, evecs
