"""Analytic useful-work model of the pipeline phases (copy of
vnlb_tpu/utils/flops.py).

Counts ALGORITHMIC work (the useful-FLOP yardstick a utilization is
defined against), not implementation work: padding lanes, discarded
candidate planes and recomputed box sums count as overhead, which is
exactly what such a number is meant to expose.  The peaks are the NVIDIA
H100 SXM data sheet's: f32 on the CUDA cores, bf16 on the tensor cores
(dense), HBM3 bandwidth; a card set below its 700 W limit runs below them.

Phases: search (patch-distance MACs over all (site, candidate) pairs,
every needle level), bayes (covariance + polynomial matmul chain +
application), agg (scatter adds + dense fold adds).  Gather is bandwidth,
not FLOPs: reported as bytes.
"""

from __future__ import annotations

from ..config import StageConfig

PEAK_F32, PEAK_BF16, HBM_BPS = 67e12, 989e12, 3.35e12


def _econ_matmuls(cfg: StageConfig, k: int, p: int):
    """(n_pp_matmuls, n_kp_matmuls) of the econ poly evaluator."""
    import math
    deg = cfg.poly_deg_fused
    s = min(4, max(2, int(round(math.sqrt(deg + 1)))))
    m = -(-(deg + 1) // s)
    powers = {4: 3, 3: 2, 2: 1}[s]
    if k < p:          # left regime: zs (s-1 lmm) + clenshaw (m lmm)
        return powers, (s - 1) + m
    return powers + m, 1


def search_flops(shape, cfg: StageConfig, n_sites: int) -> float:
    """Patch-distance MACs: every (site, candidate) pair at every level."""
    t, c, h, w = shape
    per_pair = cfg.ps * cfg.ps * cfg.pt * cfg.dist_chnls * 2
    n_levels = 1
    if cfg.stype == "needle":
        r = cfg.w_s + cfg.ps - 1
        lh, lw = h, w
        for _ in range(1, cfg.needle_scales):
            lh, lw = lh // 2, lw // 2
            if lh < r or lw < r:
                break
            n_levels += 1
    return float(n_sites) * cfg.n_cands * per_pair * n_levels


def bayes_flops(cfg: StageConfig, n_sites: int) -> float:
    """Covariance + polynomial chain + application, per channel group."""
    c = 3
    k = cfg.npatches
    p = cfg.pdim * (c if cfg.couple_channels else 1)
    g = n_sites * (1 if cfg.couple_channels else c)
    cov = 2.0 * k * p * p
    if cfg.eig_method == "poly":
        if k < p and cfg.poly_gram:
            # GRAM route: gram + Xn Xc^T + K-dim chain + apply
            import math
            deg = cfg.poly_deg_fused
            s = min(4, max(2, int(round(math.sqrt(deg + 1)))))
            m = -(-(deg + 1) // s)
            n_kk = {4: 3, 3: 2, 2: 1}[s] + m + 1      # powers+clenshaw+t
            chain = 3.0 * 2.0 * k * k * p + n_kk * 2.0 * k ** 3
            return g * chain
        n_pp, n_kp = _econ_matmuls(cfg, k, p)
        chain = n_pp * 2.0 * p ** 3 + n_kp * 2.0 * k * p * p
    else:               # eigh ~ 10 p^3 + two projections
        chain = 10.0 * p ** 3 + 4.0 * k * p * p
    return g * (cov + chain)


def agg_flops(cfg: StageConfig, n_sites: int) -> float:
    """Scatter adds (patch rows) + the dense fold's shifted adds."""
    c = 3
    k_agg = cfg.agg_k or cfg.npatches
    d = cfg.pt * c * cfg.ps * cfg.ps + 1
    return float(n_sites) * k_agg * d          # fold adds are per-pixel, small


def gather_bytes(cfg: StageConfig, n_sites: int) -> float:
    c = 3
    row = cfg.pt * c * cfg.ps * cfg.ps * (2 if cfg.cols_bf16 else 4)
    return float(n_sites) * cfg.npatches * row


def pass_flops(shape, cfg: StageConfig, n_sites: int) -> dict:
    return {
        "search": search_flops(shape, cfg, n_sites),
        "bayes": bayes_flops(cfg, n_sites),
        "agg": agg_flops(cfg, n_sites),
        "gather_bytes": gather_bytes(cfg, n_sites),
    }


def two_pass_flops(shape, vnlb_cfg, n_sites0: int, n_sites1: int) -> float:
    """Total algorithmic FLOPs of a two-pass denoise (for bench MFU)."""
    f0 = pass_flops(shape, vnlb_cfg.stage(0), n_sites0)
    f1 = pass_flops(shape, vnlb_cfg.stage(1), n_sites1)
    return sum(f0[k] for k in ("search", "bayes", "agg")) + \
        sum(f1[k] for k in ("search", "bayes", "agg"))
