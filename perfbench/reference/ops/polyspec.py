"""Polynomial spectral Wiener filters: numpy constants and the plain
PyTorch versions of vnlb_tpu/ops/polyspec.py's three evaluators.

The functions that make the constant tables (``_dct_matrix`` ...
``_ps_basis_pinv``), ``_AGGR`` and ``_sign_schedule`` are copies of
vnlb_tpu/ops/polyspec.py:67-344 and must match them exactly (pinned by
tests/test_torch_spec.py).

* ``poly_filter_econ`` evaluates, per patch group, the same function as the
  production routes ``_poly_econ_packed`` (K >= p, polyspec.py:612-671) and
  ``_poly_econ_gram_packed`` (K < p, :545-609).  Their two-groups-per-tile
  packing is a TPU layout device and is dropped: a group's result is the
  same packed or alone.  Cast points: covariance, Gram and ``Xn Xc^T`` in
  f32; every chain product and the final products with bf16-rounded
  operands (``st``) accumulated in f32.  ops/econ_filter.py runs it as
  kernel K2 on the card.  Without ``poly_gram``, K < p takes the unpacked
  left regime (polyspec.py:412-465), which JAX's Pallas filter never
  takes; the port runs it as these torch ops on every device.
* ``poly_filter`` (polyspec.py:96-190): the two-factor filter, matrix-sign
  gate x Chebyshev Wiener factor, with polyspec's cast points (not the
  Pallas kernel's).  ops/poly_filter.py runs it as kernel K5 on the card.
* ``poly_filter_fused`` (polyspec.py:193-257): one series through the
  left-side recurrence (K < p); batched products on every device, as JAX
  leaves it to XLA.
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


# aggressive quintic sign step (slope 3.4445 at 0), then cubic polish
_AGGR = (3.4445, -4.7750, 2.0315)


def _sign_schedule(ns_iters: int, n_polish: int = 3):
    """(n_aggressive, n_polish) matching the cubic-1.5^ns_iters width."""
    target = 1.5 ** ns_iters / 1.5 ** n_polish
    n_aggr = max(1, math.ceil(math.log(max(target, 1.001))
                              / math.log(_AGGR[0])))
    return n_aggr, n_polish


def _storer(rnd: bool):
    """``st``: bf16 storage rounding of intermediate matrices, or none."""
    if rnd:
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    return lambda x: x


def poly_params(cfg):
    """Scalars and constant tables of the two-factor filter for one stage."""
    tau = cfg.thresh * cfg.sigma2 + cfg.sigmab2
    wdeg = cfg.poly_deg
    nodes = max(64, 2 * (wdeg + 1))
    n_aggr, n_polish = _sign_schedule(cfg.ns_iters)
    return dict(tau=tau, s2=cfg.sigma2, sb2=cfg.sigmab2, wdeg=wdeg,
                nodes=nodes, xs=_cheb_nodes(nodes),
                dct=_dct_matrix(wdeg, nodes), n_aggr=n_aggr,
                n_polish=n_polish, rnd=bool(cfg.poly_bf16))


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


def _mm(st):
    """Batched product of ``st``-rounded operands, accumulated in f32."""
    return lambda a, b: torch.bmm(st(a), st(b))


def _cheb_basis(ah: torch.Tensor, s: int, st):
    """(B, T) for a batch of (q, q) matrices ``ah``: B = T_s(A) from the
    even power identities and T = [None, T_1(A), ..., T_{s-1}(A)]."""
    q = ah.shape[-1]
    eye = torch.eye(q, dtype=ah.dtype, device=ah.device)
    mmm = _mm(st)
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
    return b_mat, t_mats


def _chain(ah: torch.Tensor, gam: torch.Tensor, m: int, s: int, st):
    """T_s-substitution + Clenshaw: sum_i T_i(T_s(A)) sum_r gam[i,r] T_r(A)
    for a batch of (q, q) matrices ``ah``; gam (G, m, s)."""
    eye = torch.eye(ah.shape[-1], dtype=ah.dtype, device=ah.device)
    mmm = _mm(st)
    b_mat, t_mats = _cheb_basis(ah, s, st)

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


def _econ_left(xc2: torch.Tensor, xn2: torch.Tensor, ep) -> torch.Tensor:
    """The econ filter's left regime (K < p without ``poly_gram``,
    vnlb_tpu/ops/polyspec.py:412-465): the p x p covariance chain, then
    z_r = xn2 T_r(A) by the T recurrence and a row-space Clenshaw in
    B = T_s(A)."""
    g, k, p = xc2.shape
    m, s = ep["m"], ep["s"]
    st = _storer(ep["rnd"])
    lmm = _mm(st)
    dev = xc2.device
    a_cov = torch.bmm(xc2.transpose(1, 2), xc2) / k
    lub = _lub(a_cov, ep["tau"])
    fv = _transfer_vals(lub, ep)
    gam = (fv @ torch.as_tensor(ep["pinv"], device=dev)).reshape(g, m, s)
    eye = torch.eye(p, dtype=torch.float32, device=dev)
    ah = 2.0 * a_cov / lub[:, None, None] - eye
    b_mat, _ = _cheb_basis(ah, s, st)
    zs = [xn2, lmm(xn2, ah)]
    for _ in range(2, s):
        zs.append(2.0 * lmm(zs[-1], ah) - zs[-2])
    w_rows = [sum(gam[:, i, r, None, None] * zs[r] for r in range(s))
              for i in range(m)]
    b_hi = torch.zeros_like(xn2)
    b_lo = torch.zeros_like(xn2)
    for i in range(m - 1, 0, -1):
        b_new = w_rows[i] + 2.0 * lmm(b_hi, b_mat) - b_lo
        b_lo, b_hi = b_hi, b_new
    return w_rows[0] + lmm(b_hi, b_mat) - b_lo


def poly_filter_econ(xc2: torch.Tensor, xn2: torch.Tensor, cfg
                     ) -> torch.Tensor:
    """Econ spectral filter, (G, K, p) f32 centred patches -> (G, K, p).
    K >= p takes the matrix route; K < p the Gram route under
    ``poly_gram``, else the left regime (``_econ_left``)."""
    g, k, p = xc2.shape
    ep = econ_params(cfg)
    m, s = ep["m"], ep["s"]
    st = _storer(ep["rnd"])
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32)
    dev = xc2.device

    if k < p and not cfg.poly_gram:
        return _econ_left(xc2, xn2, ep)
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


def poly_filter(xc2: torch.Tensor, xn2: torch.Tensor, cfg) -> torch.Tensor:
    """Two-factor spectral filter, (G, K, p) f32 centred patches -> (G, K,
    p): sign gate W ~ H(C - tau) times the Chebyshev Wiener factor Q,
    applied on the right (Xn W Q, K >= p) or through the left-side T_j
    recurrence (K < p)."""
    g, k, p = xc2.shape
    pp = poly_params(cfg)
    tau, s2, sb2, wdeg = pp["tau"], pp["s2"], pp["sb2"], pp["wdeg"]
    st = _storer(pp["rnd"])
    dev = xc2.device
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32, device=dev)

    a_cov = torch.bmm(xc2.transpose(1, 2), xc2) * inv_k
    eye = torch.eye(p, dtype=torch.float32, device=dev)
    lub = _lub(a_cov, tau)

    # matrix sign gate: aggressive quintic steps, then cubic polish
    sc = torch.clamp(lub - tau, min=tau)
    s_mat = st((a_cov - tau * eye) / sc[:, None, None])
    a, b_, c_ = _AGGR
    for _ in range(pp["n_aggr"]):
        s2m = st(torch.bmm(s_mat, s_mat))
        s3m = torch.bmm(s2m, s_mat)
        s5m = torch.bmm(s2m, st(s3m))
        s_mat = st(a * s_mat + b_ * s3m + c_ * s5m)
    for _ in range(pp["n_polish"]):
        s_mat = st(1.5 * s_mat
                   - 0.5 * torch.bmm(s_mat, st(torch.bmm(s_mat, s_mat))))
    w_gate = 0.5 * (s_mat + eye)

    # smooth Wiener factor: per-group Chebyshev coefficients
    xs = torch.as_tensor(pp["xs"], device=dev)
    dct = torch.as_tensor(pp["dct"], device=dev)
    lam_i = (xs[None, :] + 1.0) * 0.5 * lub[:, None]
    lam_c = torch.clamp(lam_i, min=0.9 * tau)
    wv = (lam_c - sb2) / (lam_c - sb2 + s2)
    coef = wv @ dct                                           # (G, wdeg+1)

    ah = st(2.0 * a_cov / lub[:, None, None] - eye)

    if k < p:
        y0 = torch.bmm(xn2, w_gate)
        z_prev = y0
        z_cur = torch.bmm(st(y0), ah)
        acc = coef[:, 0, None, None] * z_prev + coef[:, 1, None, None] * z_cur
        for j in range(2, wdeg + 1):
            z_nxt = 2.0 * torch.bmm(st(z_cur), ah) - z_prev
            acc = acc + coef[:, j, None, None] * z_nxt
            z_prev, z_cur = z_cur, z_nxt
        return acc

    t_prev = eye.expand_as(a_cov)
    t_cur = ah
    q = coef[:, 0, None, None] * t_prev + coef[:, 1, None, None] * t_cur
    for j in range(2, wdeg + 1):
        t_nxt = 2.0 * torch.bmm(ah, st(t_cur)) - t_prev
        q = q + coef[:, j, None, None] * t_nxt
        t_prev, t_cur = t_cur, t_nxt
    f_mat = torch.bmm(st(w_gate), st(q))
    return torch.bmm(xn2, st(f_mat))


def poly_filter_fused(xc2: torch.Tensor, xn2: torch.Tensor, cfg
                      ) -> torch.Tensor:
    """Single-series spectral filter for K < p: the smoothed gate x Wiener
    transfer as one Chebyshev series of degree ``poly_deg_fused``, applied
    through the left-side T_j recurrence on xn2."""
    g, k, p = xc2.shape
    s2, sb2 = cfg.sigma2, cfg.sigmab2
    tau = cfg.thresh * s2 + sb2
    deg = cfg.poly_deg_fused
    nodes = max(64, 2 * (deg + 1))
    st = _storer(bool(cfg.poly_bf16))
    dev = xc2.device
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32, device=dev)

    a_cov = torch.bmm(xc2.transpose(1, 2), xc2) * inv_k
    eye = torch.eye(p, dtype=torch.float32, device=dev)
    lub = _lub(a_cov, tau)

    xs = torch.as_tensor(_cheb_nodes(nodes), device=dev)
    dct = torch.as_tensor(_dct_matrix(deg, nodes), device=dev)
    lam_i = (xs[None, :] + 1.0) * 0.5 * lub[:, None]
    wg = 1.2 * (np.pi / deg) * torch.sqrt(tau * lub)
    gate = torch.sigmoid((lam_i - tau) / (wg[:, None] / 4.4))
    lam_s = torch.clamp(lam_i - sb2, min=0.0)
    fv = gate * lam_s / (lam_s + s2)
    coef = fv @ dct                                           # (G, deg+1)

    ah = st(2.0 * a_cov / lub[:, None, None] - eye)

    z_prev = xn2
    z_cur = torch.bmm(st(xn2), ah)
    acc = coef[:, 0, None, None] * z_prev + coef[:, 1, None, None] * z_cur
    for j in range(2, deg + 1):
        z_nxt = 2.0 * torch.bmm(st(z_cur), ah) - z_prev
        acc = acc + coef[:, j, None, None] * z_nxt
        z_prev, z_cur = z_cur, z_nxt
    return acc
