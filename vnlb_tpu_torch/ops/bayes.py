"""Empirical-Bayes patch-group filter (vnlb_tpu/ops/bayes.py:54-269), every
branch of its dispatch.

Groups are per channel, (B, c, K, p) -> G = B*c groups of (K, p), or one
joint group of (K, c*p) per site with ``couple_channels``.  Noisy groups
are centred on their own mean, except flat groups in the second pass,
which are centred on the basic mean; the covariance source is the noisy
(first pass) or basic (second pass) group.  The spectral filter:

* ``eig_method="poly"``: the econ filter (kernel K2, ops/econ_filter.py)
  for ``poly_impl="fused"`` and ``poly_econ`` (its left regime, K < p
  without ``poly_gram``, as torch ops on every device); the two-factor
  filter (kernel K5, ops/poly_filter.py) for ``poly_impl="pallas"`` and,
  without ``poly_econ``, for K >= p or without ``poly_fused``; else the
  fused single series (ops/polyspec.poly_filter_fused);
* ``"rational"``: matrix rationals (ops/spectral.py);
* ``"xla"`` / ``"jacobi"``: an eigendecomposition of the covariance
  (K >= p) or Gram matrix (K < p), clipped shrinkage and the Wiener gate
  on the top ``rank`` eigenvalues (``_spectral_filter``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import StageConfig
from ..utils.timer import span
from .econ_filter import econ_filter
from .eigh import jacobi_eigh
from .poly_filter import poly_filter
from .polyspec import poly_filter_fused
from .spectral import rational_filter


def _from_bcnp(x: torch.Tensor, pt: int, ps: int) -> torch.Tensor:
    """(B, c, K, p) -> (B, K, pt, c, ps, ps) public layout."""
    b, c, k, _ = x.shape
    return x.reshape(b, c, k, pt, ps, ps).permute(0, 2, 3, 1, 4, 5)


def _poly(xc2, xn2, k, cfg, econ_fn, poly_fn):
    """The ``eig_method="poly"`` dispatch (vnlb_tpu/ops/bayes.py:117-154)."""
    g_f, k_f, p_f = xc2.shape
    use_fused = (cfg.poly_impl == "fused" and cfg.poly_econ
                 and cfg.poly_pack2 and g_f % 2 == 0 and g_f >= 2
                 and ((k_f < p_f and cfg.poly_gram and 2 * k_f <= 128)
                      or (k_f >= p_f and 2 * p_f <= 128)))
    if use_fused:
        return econ_fn(xc2, xn2, cfg)
    if cfg.poly_impl == "pallas":
        return poly_fn(xc2, xn2, cfg)
    if cfg.poly_econ:
        return econ_fn(xc2, xn2, cfg)
    if cfg.poly_fused and k < p_f:
        return poly_filter_fused(xc2, xn2, cfg)
    return poly_fn(xc2, xn2, cfg)


def bayes_denoise(pnoisy: torch.Tensor, pbasic: Optional[torch.Tensor],
                  flat: Optional[torch.Tensor], cfg: StageConfig,
                  econ_fn: Callable = econ_filter,
                  poly_fn: Callable = poly_filter
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter noisy patch groups given as c-major rows (B, K, c,
    pt*ps*ps); returns (filtered (B, K, pt, c, ps, ps), rank_var (B,)).
    ``econ_fn`` / ``poly_fn`` are the econ and two-factor filters (the
    device-dispatching wrappers of K2 and K5 by default)."""
    b, k, c, p = pnoisy.shape
    pt, ps = cfg.pt, cfg.ps
    step2 = cfg.step == 1

    with span("vnlb.filter.prep"):
        # (B, K, c, p) -> (B, c, K, p) groups
        xn = pnoisy.permute(0, 2, 1, 3).to(torch.float32)
        cnoisy = xn.mean(dim=2, keepdim=True)
        if step2:
            if pbasic is None or flat is None:
                raise ValueError("the second pass needs basic patches and "
                                 "flags")
            xb = pbasic.permute(0, 2, 1, 3).to(torch.float32)
            cbasic = xb.mean(dim=2, keepdim=True)
            cnoisy = torch.where(flat[:, None, None, None], cbasic, cnoisy)
            xb = xb - cbasic
        xn = xn - cnoisy

        if cfg.cpatches == "noisy":
            xc = xn
        elif cfg.cpatches == "basic":
            if not step2:
                raise ValueError("cpatches='basic' requires step 2")
            xc = xb
        else:
            raise ValueError(f"unknown cpatches [{cfg.cpatches}]")

        if cfg.couple_channels:
            # one joint prior over the channels: groups of dimension c*p
            def join(x):
                return x.permute(0, 2, 1, 3).reshape(b, k, c * p)

            xc2, xn2, gc = join(xc), join(xn), 1
            rank = min(cfg.rank, c * p)
        else:
            xc2, xn2 = xc.reshape(b * c, k, p), xn.reshape(b * c, k, p)
            gc, rank = c, min(cfg.rank, p)

    def unjoin(xf):
        """(b*gc, k, p_eff) -> (B, c, K, p)."""
        if cfg.couple_channels:
            return xf.reshape(b, k, c, p).permute(0, 2, 1, 3)
        return xf.reshape(b, c, k, p)

    if cfg.eig_method in ("rational", "poly"):
        if cfg.eig_method == "poly":
            xf = _poly(xc2, xn2, k, cfg, econ_fn, poly_fn)
        else:
            xf = rational_filter(xc2, xn2, cfg)
        with span("vnlb.filter.finish"):
            # rank_var = full eigenvalue mass = trace(C) = ||Xc||^2 / K
            trace = (xc2 * xc2).sum(dim=(1, 2)) / k
            rank_var = trace.reshape(b, gc).mean(dim=1)
            return _from_bcnp(unjoin(xf) + cnoisy, pt, ps), rank_var

    lam, coeff, basis, domain = _spectral_filter(xc2, cfg, rank)
    rank_var = lam.reshape(b, gc, -1).sum(dim=2).mean(dim=1)
    if domain == "gram":
        # shared-SVD identity: Xn U_r diag(c) U_r^T =
        # Xn Xc^T V_r diag(c / (K mu)) V_r^T Xc, all in the K-dim domain
        mu_r = torch.clamp(lam[:, :rank], min=0.0)
        w = torch.where(mu_r > 1e-8,
                        coeff / torch.clamp(k * mu_r, min=1e-10),
                        torch.zeros_like(mu_r))
        m = torch.bmm(xn2, xc2.transpose(1, 2))
        t1 = torch.bmm(m, basis)
        t2 = torch.bmm(t1 * w[:, None, :], basis.transpose(1, 2))
        xf = torch.bmm(t2, xc2)
    else:
        z = torch.bmm(xn2, basis)
        xf = torch.bmm(z * coeff[:, None, :], basis.transpose(1, 2))
    with span("vnlb.filter.finish"):
        return _from_bcnp(unjoin(xf) + cnoisy, pt, ps), rank_var


def _wiener_coeff(lam: torch.Tensor, cfg: StageConfig) -> torch.Tensor:
    """Eigenvalue shrinkage + Wiener gate (vnlb_tpu/ops/bayes.py:202-211)."""
    if cfg.mod_sel == "clipped":
        lam = lam - torch.minimum(lam, torch.full_like(lam, cfg.sigmab2))
    elif cfg.mod_sel != "paul":
        raise ValueError(f"unknown eigen modifier [{cfg.mod_sel}]")
    gate = lam > (cfg.thresh * cfg.sigma2)
    safe = torch.where(gate, lam, torch.ones_like(lam))
    return torch.where(gate, 1.0 / (1.0 + cfg.sigma2 / safe),
                       torch.zeros_like(lam))


def _spectral_filter(xc2: torch.Tensor, cfg: StageConfig, rank: int):
    """(lam_full_desc, coeff (G, rank), basis, domain) of the group
    covariance (p <= K, ``cov``) or Gram matrix (K < p, ``gram``)."""
    g, k, p = xc2.shape
    if k < p:
        gram = torch.bmm(xc2, xc2.transpose(1, 2)) / k
        mu, v = _eigh(gram, cfg)
        return mu, _wiener_coeff(mu[:, :rank], cfg), v[:, :, :rank], "gram"
    cov = torch.bmm(xc2.transpose(1, 2), xc2) / k
    lam, u = _eigh(cov, cfg)
    return lam, _wiener_coeff(lam[:, :rank], cfg), u[:, :, :rank], "cov"


def _eigh(mats: torch.Tensor, cfg: StageConfig):
    """Batched symmetric eigh, eigenvalues descending: ``"xla"`` is the
    library eigh (``torch.linalg.eigh``), anything else the batched
    Jacobi of ops/eigh.py."""
    if cfg.eig_method == "xla":
        w, v = torch.linalg.eigh(mats)
        return w.flip(1), v.flip(2)
    return jacobi_eigh(mats, sweeps=cfg.eig_sweeps)


def ave_denoise(pnoisy: torch.Tensor, cfg: StageConfig) -> torch.Tensor:
    """``deno="ave"`` (vnlb_tpu/ops/bayes.py:260-269): the raw noisy
    patches, as the reference's effective behaviour aggregates them, moved
    from c-major rows (B, K, c, pt*ps*ps) to the public (B, K, pt, c, ps,
    ps) layout (vnlb_tpu/pipeline.py:210-220)."""
    b, k, c, _ = pnoisy.shape
    x = pnoisy.to(torch.float32).reshape(b, k, c, cfg.pt, cfg.ps * cfg.ps)
    return x.permute(0, 1, 3, 2, 4).reshape(b, k, cfg.pt, c, cfg.ps, cfg.ps)
