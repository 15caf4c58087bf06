"""Frozen work models of the port's kernels (copied from chip_smoke.py's
``bound``, ``k1_work``, ``sym``, ``econ_work`` and ``poly_work``, with the
scalar logic of ``econ_params`` / ``poly_params`` they import from
vnlb_tpu_torch/ops/polyspec.py), so a later change to the program cannot
move the yardstick.

Each counts the algorithm's work from a call's shapes, whatever design
runs it: every input byte read once and every output byte written once,
and the operations by the precision of their operands.  ``bound`` turns
that into the least time an NVIDIA H100 SXM could take at its published
dense peaks.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense: f32 on CUDA cores, bf16 and TF32 on
# tensor cores, HBM3
PEAK_F32, PEAK_BF16, PEAK_TF32, HBM_BPS = 67e12, 989e12, 494.7e12, 3.35e12


def bound(f32_flops, bf16_flops, nbytes, x3_flops=0):
    """(least ms the card could take, what bounds it); ``x3_flops`` are f32
    products that take the lesser of f32 CUDA cores and split TF32 (three
    TF32 products each; the lesser is split TF32)."""
    t_ops = (f32_flops / PEAK_F32 + bf16_flops / PEAK_BF16
             + min(x3_flops / PEAK_F32, 3 * x3_flops / PEAK_TF32))
    t_mem = nbytes / HBM_BPS
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def k1_work(n_sites, site_bytes, vid_numel, c, pt, ps, w_s, starts=0,
            planes=7, cands=None):
    """bound() of K1 over ``planes`` dt planes of ``n_sites`` query sites:
    per (site, dt, candidate, pixel) a subtraction and a multiply-add in
    f32, for ``cands`` computed (site, dt, candidate) triples (all of them
    by default); the video (``vid_numel`` f32 values of ``c`` channels)
    and the sites' coordinates (``site_bytes``; and ``starts`` (planes, S)
    int32 window-start tensors) read once, the distances written once."""
    if cands is None:
        cands = n_sites * planes * w_s ** 2
    flops = 3 * cands * pt * c * ps ** 2
    nbytes = (vid_numel * 4 + site_bytes + starts * planes * n_sites * 4
              + n_sites * planes * w_s ** 2 * 4)
    return bound(flops, 0, nbytes)


def sym(q):
    """Multiply-adds of a q x q product whose result is symmetric, over
    those of the full product: the outputs on and above the diagonal."""
    return (q + 1) / (2 * q)


def ps_split(deg: int):
    """(m, s) with m*s >= deg+1, s ~ sqrt(deg) (polyspec ``_ps_split``)."""
    s = min(4, max(2, int(round(math.sqrt(deg + 1)))))
    m = -(-(deg + 1) // s)
    return m, s


def sign_schedule(ns_iters: int, n_polish: int = 3):
    """(n_aggressive, n_polish) of the matrix-sign gate (polyspec
    ``_sign_schedule``)."""
    target = 1.5 ** ns_iters / 1.5 ** n_polish
    n_aggr = max(1, math.ceil(math.log(max(target, 1.001))
                              / math.log(3.4445)))
    return n_aggr, n_polish


def econ_work(g, k, p, scfg):
    """(f32 flops, bf16-operand flops, bytes, split-TF32 flops) of K2 on g
    groups of (k, p): the covariance or Gram (symmetric) and xn xc^T take
    f32 operands, the chain and the applications bf16-rounded ones (all f32
    without poly_bf16); every f32 product is bounded as split TF32.
    Without poly_bf16 the chain's products, polynomials in the symmetric
    covariance or Gram, are symmetric too."""
    m, s = ps_split(scfg.poly_deg_fused)
    rnd = bool(scfg.poly_bf16)
    chain = {4: 3, 3: 2, 2: 1}[s] + m - 1
    q = k if k < p else p
    f32 = k * k * p * (sym(k) + 1) if k < p else k * p * p * sym(p)
    chain_q = chain * q ** 3 * (1 if rnd else sym(q))
    if k < p:
        low = chain_q + k ** 3 + k * k * p
    else:
        low = chain_q + k * p * p
    if not rnd:
        return 0, 0, 3 * g * k * p * 4, 2 * g * (f32 + low)
    return 0, 2 * g * low, 3 * g * k * p * 4, 2 * g * f32


def poly_work(g, k, p, scfg):
    """(f32 flops, bf16-operand flops, bytes, split-TF32 flops) of K5 on g
    groups of (k, p): the covariance (symmetric) and the xn-side product
    take f32 operands; the sign gate, the T_j products and F = W Q
    bf16-rounded ones (all f32 without poly_bf16); every f32 product is
    bounded as split TF32."""
    n_aggr, n_polish = sign_schedule(scfg.ns_iters)
    wdeg, rnd = scfg.poly_deg, bool(scfg.poly_bf16)
    s = 1 if rnd else sym(p)
    gate = (3 * n_aggr + 2 * n_polish) * p ** 3 * s
    f32 = k * p * p * (sym(p) + 1)
    if k >= p:
        low = gate + wdeg * p ** 3 * s
    else:
        low = gate + wdeg * k * p * p
    if not rnd:
        return 0, 0, 3 * g * k * p * 4, 2 * g * (f32 + low)
    return 0, 2 * g * low, 3 * g * k * p * 4, 2 * g * f32
