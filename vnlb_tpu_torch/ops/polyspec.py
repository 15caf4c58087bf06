"""Economized polynomial spectral Wiener filter: numpy constants and the
plain PyTorch version of ``poly_filter_econ``.

The constant builders are copies of vnlb_tpu/ops/polyspec.py:67-344 and
must match them exactly (pinned by tests/test_torch_spec.py).  The plain
filter evaluates, per patch group, the same function as the production
routes ``_poly_econ_packed`` (K >= p, polyspec.py:612-671) and
``_poly_econ_gram_packed`` (K < p, :545-609).  Their two-groups-per-tile
packing is a TPU layout device and is dropped: a group's result is the same
packed or alone.  Cast points are polyspec's: covariance, Gram and
``Xn Xc^T`` in f32; every chain product and the final products with
bf16-rounded operands (``st``) accumulated in f32.

ops/econ_filter.py runs this function as a CUDA kernel on the card; this
module is its plain twin (CPU tests, on-card comparisons).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct_matrix(deg: int, nodes: int):
    """Constant (nodes, deg+1) projection: node values -> Chebyshev coeffs."""
    jj = np.arange(deg + 1)
    m = np.cos(np.pi * jj[:, None] * (np.arange(nodes) + 0.5)[None, :]
               / nodes) * (2.0 / nodes)
    m[0] *= 0.5
    return m.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cheb_nodes(nodes: int):
    return np.cos(np.pi * (np.arange(nodes) + 0.5) / nodes).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ps_split(deg: int):
    """(m, s) with m*s >= deg+1, s ~ sqrt(deg)."""
    s = min(4, max(2, int(round(math.sqrt(deg + 1)))))
    m = -(-(deg + 1) // s)
    return m, s


@functools.lru_cache(maxsize=None)
def _gram_maps(m: int, s: int, nodes: int):
    """Gram-route maps: gamma_flat = fvals @ gmap (econ coefficients of
    g_hat = (f_hat - f_hat(-1)) / (x + 1)), f0 = fvals @ v0."""
    d_deg = m * s
    proj = _dct_matrix(d_deg, nodes).T
    w0 = np.array([(-1.0) ** j for j in range(d_deg + 1)])
    e0 = np.zeros((d_deg + 1,))
    e0[0] = 1.0
    sub = np.eye(d_deg + 1) - np.outer(e0, w0)
    lmat = np.zeros((d_deg + 1, d_deg))
    for j in range(d_deg):
        lmat[j, j] += 1.0
        if j == 0:
            lmat[1, 0] += 1.0
        else:
            lmat[j + 1, j] += 0.5
            lmat[j - 1, j] += 0.5
    div = np.linalg.pinv(lmat)
    xs = np.cos(np.pi * (np.arange(nodes) + 0.5) / nodes)
    t2 = np.stack([np.cos(j * np.arccos(xs)) for j in range(d_deg)],
                  axis=0)
    pphi = _ps_basis_pinv(m, s, nodes)
    gmap = (pphi.T @ t2.T @ div @ sub @ proj).T
    v0 = (w0 @ proj)
    return gmap.astype(np.float32), v0.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ps_basis_pinv(m: int, s: int, nodes: int):
    """(nodes, m*s) pseudo-inverse-transpose: node values -> gamma[i,r]."""
    xs = np.cos(np.pi * (np.arange(nodes) + 0.5) / nodes)

    def cheb_t(j, x):
        return np.cos(j * np.arccos(np.clip(x, -1.0, 1.0)))

    ts = cheb_t(s, xs)
    phi = np.stack([cheb_t(i, ts) * cheb_t(r, xs)
                    for i in range(m) for r in range(s)], axis=1)
    return np.linalg.pinv(phi).T.astype(np.float32)


def econ_params(cfg):
    """Scalars and constant tables of the econ filter for one stage."""
    s2, sb2 = cfg.sigma2, cfg.sigmab2
    tau = cfg.thresh * s2 + sb2
    m, s = _ps_split(cfg.poly_deg_fused)
    deg = m * s - 1
    nodes = max(64, 2 * (deg + 1))
    return dict(tau=tau, s2=s2, sb2=sb2, m=m, s=s, deg=deg, nodes=nodes,
                xs=_cheb_nodes(nodes), pinv=_ps_basis_pinv(m, s, nodes),
                gram_maps=_gram_maps(m, s, nodes),
                cwg=1.2 * (np.pi / deg), rnd=bool(cfg.poly_bf16))


def _lub(mat: torch.Tensor, tau: float) -> torch.Tensor:
    tr = torch.diagonal(mat, dim1=1, dim2=2).sum(dim=1)
    rowsum = mat.abs().sum(dim=2).amax(dim=1)
    return torch.clamp(torch.minimum(tr, rowsum), min=1.5 * tau) * 1.02


def _transfer_vals(lub: torch.Tensor, ep) -> torch.Tensor:
    """Smoothed gate x Wiener target at the per-group scaled nodes."""
    tau, sb2, s2 = ep["tau"], ep["sb2"], ep["s2"]
    xs = torch.as_tensor(ep["xs"], device=lub.device)
    lam_i = (xs[None, :] + 1.0) * 0.5 * lub[:, None]
    wg = ep["cwg"] * torch.sqrt(tau * lub)
    gate = torch.sigmoid((lam_i - tau) / (wg[:, None] / 4.4))
    lam_s = torch.clamp(lam_i - sb2, min=0.0)
    return gate * lam_s / (lam_s + s2)


def _chain(ah: torch.Tensor, gam: torch.Tensor, m: int, s: int, st):
    """T_s-substitution + Clenshaw: sum_i T_i(T_s(A)) sum_r gam[i,r] T_r(A)
    for a batch of (q, q) matrices ``ah``; gam (G, m, s)."""
    q = ah.shape[-1]
    eye = torch.eye(q, dtype=ah.dtype, device=ah.device)

    def mmm(a, b):
        return torch.bmm(st(a), st(b))

    a2 = mmm(ah, ah)
    if s == 4:
        a4 = mmm(a2, a2)
        b_mat = 8.0 * a4 - 8.0 * a2 + eye
        t3 = mmm(4.0 * a2 - 3.0 * eye, ah)
        t_mats = [None, ah, 2.0 * a2 - eye, t3]
    elif s == 3:
        b_mat = mmm(4.0 * a2 - 3.0 * eye, ah)
        t_mats = [None, ah, 2.0 * a2 - eye]
    elif s == 2:
        b_mat = 2.0 * a2 - eye
        t_mats = [None, ah]
    else:
        raise NotImplementedError(f"ps split s={s}")

    def t_of(r):
        return eye.expand_as(ah) if r == 0 else t_mats[r]

    v_mats = [sum(gam[:, i, r, None, None] * t_of(r) for r in range(s))
              for i in range(m)]
    b_hi = torch.zeros_like(ah)
    b_lo = torch.zeros_like(ah)
    for i in range(m - 1, 0, -1):
        b_new = v_mats[i] + 2.0 * mmm(b_hi, b_mat) - b_lo
        b_lo, b_hi = b_hi, b_new
    return v_mats[0] + mmm(b_hi, b_mat) - b_lo


def poly_filter_econ(xc2: torch.Tensor, xn2: torch.Tensor, cfg
                     ) -> torch.Tensor:
    """Econ spectral filter, (G, K, p) f32 centred patches -> (G, K, p).
    K >= p takes the matrix route, K < p the Gram route."""
    g, k, p = xc2.shape
    ep = econ_params(cfg)
    m, s = ep["m"], ep["s"]
    if ep["rnd"]:
        def st(x):
            return x.to(torch.bfloat16).to(torch.float32)
    else:
        def st(x):
            return x
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32)
    dev = xc2.device

    if k < p:
        gram = torch.bmm(xc2, xc2.transpose(1, 2)) * inv_k.to(dev)
        lub = _lub(gram, ep["tau"])
        fv = _transfer_vals(lub, ep)
        gmap, v0 = ep["gram_maps"]
        gam = (fv @ torch.as_tensor(gmap, device=dev)).reshape(g, m, s)
        f0 = fv @ torch.as_tensor(v0, device=dev)
        eye = torch.eye(k, dtype=torch.float32, device=dev)
        gh = gram * (2.0 / lub)[:, None, None] - eye
        g_mat = _chain(gh, gam, m, s, st)
        mh = torch.bmm(xn2, xc2.transpose(1, 2))
        t_m = torch.bmm(st(mh), st(g_mat))
        y = torch.bmm(st(t_m), st(xc2))
        return f0[:, None, None] * xn2 + y * (2.0 / (k * lub))[:, None, None]

    cov = torch.bmm(xc2.transpose(1, 2), xc2) * inv_k.to(dev)
    lub = _lub(cov, ep["tau"])
    fv = _transfer_vals(lub, ep)
    gam = (fv @ torch.as_tensor(ep["pinv"], device=dev)).reshape(g, m, s)
    eye = torch.eye(p, dtype=torch.float32, device=dev)
    ah = cov * (2.0 / lub)[:, None, None] - eye
    f_mat = _chain(ah, gam, m, s, st)
    return torch.bmm(st(xn2), st(f_mat))
