"""Empirical-Bayes patch-group filter, ``eig_method="poly"`` econ branch
(vnlb_tpu/ops/bayes.py:54-163).

Groups are per channel: (B, c, K, p) -> G = B*c groups of (K, p).  Noisy
groups are centred on their own mean, except flat groups in the second
pass, which are centred on the basic mean; the covariance source is the
noisy (first pass) or basic (second pass) group.  The spectral filter is
the econ filter, kernel K2 on the card (ops/econ_filter.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import StageConfig
from .econ_filter import econ_filter


def _from_bcnp(x: torch.Tensor, pt: int, ps: int) -> torch.Tensor:
    """(B, c, K, p) -> (B, K, pt, c, ps, ps) public layout."""
    b, c, k, _ = x.shape
    return x.reshape(b, c, k, pt, ps, ps).permute(0, 2, 3, 1, 4, 5)


def bayes_denoise(pnoisy: torch.Tensor, pbasic: Optional[torch.Tensor],
                  flat: Optional[torch.Tensor], cfg: StageConfig,
                  filter_fn: Callable = econ_filter
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter noisy patch groups given as c-major rows (B, K, c,
    pt*ps*ps); returns (filtered (B, K, pt, c, ps, ps), rank_var (B,)).
    ``filter_fn`` is the econ filter (the device-dispatching wrapper by
    default)."""
    b, k, c, p = pnoisy.shape
    pt, ps = cfg.pt, cfg.ps
    step2 = cfg.step == 1

    # (B, K, c, p) -> (B, c, K, p) groups
    xn = pnoisy.permute(0, 2, 1, 3).to(torch.float32)
    cnoisy = xn.mean(dim=2, keepdim=True)
    if step2:
        if pbasic is None or flat is None:
            raise ValueError("the second pass needs basic patches and flags")
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

    xc2 = xc.reshape(b * c, k, p)
    xn2 = xn.reshape(b * c, k, p)
    xf = filter_fn(xc2, xn2, cfg)
    trace = (xc2 * xc2).sum(dim=(1, 2)) / k
    rank_var = trace.reshape(b, c).mean(dim=1)
    out = xf.reshape(b, c, k, p) + cnoisy
    return _from_bcnp(out, pt, ps), rank_var
