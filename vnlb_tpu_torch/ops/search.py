"""Search helpers on the main path (vnlb_tpu/ops/search.py:53-61, 262-267,
415-425).  The per-site gather search with flow-tracked windows
(``exec_search``) is not ported yet."""

from __future__ import annotations

import torch

from ..config import StageConfig


def eff_dt_range(cfg: StageConfig, t_len: int):
    """Static clamp of the temporal offset range: dt can only be valid when
    some site has 0 <= t+dt <= T-pt."""
    return (max(-cfg.nwt_b, -(t_len - cfg.pt)),
            min(cfg.nwt_f, t_len - cfg.pt))


def _avg_pool2(video: torch.Tensor) -> torch.Tensor:
    """2x spatial average pooling of (T, C, H, W); odd sizes truncate."""
    t, c, h, w = video.shape
    h2, w2 = h // 2, w // 2
    v = video[:, :, :h2 * 2, :w2 * 2].reshape(t, c, h2, 2, w2, 2)
    return v.mean(dim=(3, 5))


def _apply_tau(vals: torch.Tensor, inds: torch.Tensor, cfg: StageConfig):
    """Similarity threshold: when ``cfg.tau`` > 0, candidates whose
    normalized distance exceeds tau/255^2 - offset get index -1."""
    if cfg.tau <= 0:
        return inds
    tau_n = cfg.tau / (255.0 ** 2) - cfg.offset
    return torch.where(vals > tau_n, torch.full_like(inds, -1), inds)
