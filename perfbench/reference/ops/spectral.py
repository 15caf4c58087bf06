"""Rational spectral Wiener filter (``eig_method="rational"``), the plain
PyTorch version of vnlb_tpu/ops/spectral.py.

The clipped Wiener transfer is evaluated with matrix rationals of the
group covariance (K >= p) or Gram matrix (K < p), normalized per group by
tr/n + s2: a Wiener factor (A - sb2)(A + r2)^-1 and a gate
[1.25 b^2 (b^2 + 1/4)^-1]^m with b = A (A + tau_g)^-1, every inverse a
batched Cholesky inverse (ops/linalg.py).  In the Gram domain the 1/mu of
the shared-SVD identity cancels against the gate analytically.
"""

from __future__ import annotations

import torch

from .linalg import chol_inverse


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.transpose(1, 2))


def rational_filter(xc2: torch.Tensor, xn2: torch.Tensor, cfg
                    ) -> torch.Tensor:
    """Spectrally-filtered patches, (G, K, p) in -> (G, K, p) out."""
    g, k, p = xc2.shape
    m = cfg.gate_power
    if m not in (1, 2):
        raise ValueError(f"gate_power must be 1 or 2, got {m}")

    gram = k < p
    if gram:
        a = torch.bmm(xc2, xc2.transpose(1, 2)) / k
    else:
        a = torch.bmm(xc2.transpose(1, 2), xc2) / k
    n = a.shape[1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)

    # per-group scale normalization (the filter depends on ratios only)
    scale = torch.diagonal(a, dim1=1, dim2=2).sum(dim=1) / n + cfg.sigma2
    a = a / scale[:, None, None]
    s2 = cfg.sigma2 / scale
    sb2 = cfg.sigmab2 / scale
    tau_g = (cfg.thresh * cfg.sigma2 + cfg.sigmab2) * cfg.gate_scale / scale
    r2 = torch.maximum(s2 - sb2, 0.1 * s2)

    def diag_add(mat, vec):
        return mat + vec[:, None, None] * eye

    e_inv = chol_inverse(diag_add(a, tau_g))              # (A + tau_g)^-1
    b = _sym(torch.bmm(a, e_inv))
    s_mat = torch.bmm(b, b)
    f_inv = chol_inverse(s_mat + 0.25 * eye)              # kappa <= 5
    gate1 = 1.25 * _sym(torch.bmm(s_mat, f_inv))
    w_inv = chol_inverse(diag_add(a, r2))
    wien = _sym(torch.bmm(diag_add(a, -sb2), w_inv))

    if gram:
        # Xn Xc^T [gate^m(G) wien(G) / (K G)] Xc, gate/G pole-free
        mx = torch.bmm(xn2, xc2.transpose(1, 2))
        ae = torch.bmm(a, e_inv)
        h = 1.25 * torch.bmm(f_inv, torch.bmm(ae, e_inv))
        if m == 2:
            h = torch.bmm(gate1, h)
        z = torch.bmm(torch.bmm(h, wien), xc2)
        return torch.bmm(mx / (k * scale)[:, None, None], z)

    f = torch.bmm(gate1, wien)
    if m == 2:
        f = torch.bmm(gate1, f)
    return torch.bmm(xn2, f)
