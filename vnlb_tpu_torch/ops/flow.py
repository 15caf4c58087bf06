"""Pyramidal optical-flow estimators in PyTorch (vnlb_tpu/ops/flow.py):
duality-based TV-L1 (``tvl1_flow``, the algorithm of the reference's
external flow package) and dense iterative Lucas-Kanade (``lk_flow``), so
that ``denoise(noisy, sigma, flows=estimate_flows(noisy))`` runs on the
card alone.  Every step is a torch op on ``device`` (the card unless the
caller asks for the CPU); no kernel of its own.

Kept as JAX computes them:

* ``_box`` sums in f32 cumsums on an edge-padded image;
* ``_warp`` clamps floor(y) to [0, H-2] and the fractions to [0, 1] (not
  ``grid_sample``'s padding) and reads the four neighbours by index;
* the gradient is ``torch.gradient`` (central inside, one-sided at the
  edges, (d/dy, d/dx)), as ``jnp.gradient``;
* pyramid levels pool 2x2 with floor division, so an odd level upsamples
  by slightly more than 2: ``F.interpolate(bilinear, align_corners=False)``
  takes half-pixel centres and clamps at the edges, as
  ``jax.image.resize(..., "bilinear")`` does when it upsamples;
* fixed iteration counts (TV-L1: 5 levels x 5 warps x 25 inner steps).

XLA fuses and contracts each step, so the f32 results drift apart over
the iterations; tests/test_torch_flow_est.py states the tolerances.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    v = x[..., :h2 * 2, :w2 * 2]
    v = v.reshape(x.shape[:-2] + (h2, 2, w2, 2))
    return v.mean(dim=(-3, -1))


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """(H, W) edge-replicated padding."""
    return F.pad(x[None, None], (left, right, top, bottom),
                 mode="replicate")[0, 0]


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) box mean of radius r via cumsum (same-size, edge-padded)."""
    k = 2 * r + 1
    xp = _pad_edge(x, r, r, r, r)
    c = torch.cumsum(xp, dim=0)
    c = torch.cat([c[k - 1:k], c[k:] - c[:-k]], dim=0)
    c2 = torch.cumsum(c, dim=1)
    c2 = torch.cat([c2[:, k - 1:k], c2[:, k:] - c2[:, :-k]], dim=1)
    return c2 / (k * k)


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor
          ) -> torch.Tensor:
    """Bilinear warp: sample img at (y + v, x + u)."""
    h, w = img.shape
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] + v
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] + u
    y0 = torch.clamp(torch.floor(yy), 0, h - 2)
    x0 = torch.clamp(torch.floor(xx), 0, w - 2)
    fy = torch.clamp(yy - y0, 0.0, 1.0)
    fx = torch.clamp(xx - x0, 0.0, 1.0)
    y0 = y0.long()
    x0 = x0.long()
    return (img[y0, x0] * (1 - fy) * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0 + 1, x0 + 1] * fy * fx)


def _upsample(u: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear resize of (h, w) up to ``shape`` (half-pixel centres)."""
    return F.interpolate(u[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False, antialias=False)[0, 0]


def _lk_level(i0, i1, u, v, radius: int, iters: int, eps: float):
    gy, gx = torch.gradient(i0)
    gxx = _box(gx * gx, radius) + eps
    gyy = _box(gy * gy, radius) + eps
    gxy = _box(gx * gy, radius)
    det = gxx * gyy - gxy * gxy
    for _ in range(iters):
        it = _warp(i1, u, v) - i0
        bx = _box(gx * it, radius)
        by = _box(gy * it, radius)
        du = (gyy * bx - gxy * by) / det
        dv = (gxx * by - gxy * bx) / det
        u, v = u - du, v - dv
    return u, v


def _gray(frame, device) -> torch.Tensor:
    """Channel mean of a (c, h, w) frame, f32 on ``device``."""
    if isinstance(frame, torch.Tensor):
        frame = frame.to(device=device, dtype=torch.float32)
    else:
        frame = torch.as_tensor(frame, dtype=torch.float32, device=device)
    return frame.mean(dim=0)


def _coarse_to_fine(pyr, level_fn):
    """Run ``level_fn(i0, i1, u, v)`` from the coarsest level up; the flow
    is upsampled (x2 in value) between levels."""
    u = torch.zeros_like(pyr[-1][0])
    v = torch.zeros_like(pyr[-1][0])
    for a, b in reversed(pyr):
        if u.shape != a.shape:
            u = 2.0 * _upsample(u, a.shape)
            v = 2.0 * _upsample(v, a.shape)
        u, v = level_fn(a, b, u, v)
    return torch.stack([u, v])


def lk_flow(frame0, frame1, levels: int = 3, radius: int = 4,
            iters: int = 3, device="cuda") -> torch.Tensor:
    """Flow from frame0 to frame1; (c, h, w) frames (numpy or torch) ->
    (2, h, w) (u, v) on ``device``."""
    device = torch.device(device)
    g0 = _gray(frame0, device) / 255.0
    g1 = _gray(frame1, device) / 255.0
    pyr = [(g0, g1)]
    for _ in range(1, levels):
        if min(pyr[-1][0].shape) < 2 * (2 * radius + 1):
            break
        pyr.append((_avg_pool(pyr[-1][0]), _avg_pool(pyr[-1][1])))
    return _coarse_to_fine(
        pyr, lambda a, b, u, v: _lk_level(a, b, u, v, radius, iters, 1e-4))


def _blur121(x: torch.Tensor) -> torch.Tensor:
    """Separable [1,4,6,4,1]/16 binomial blur, edge-padded."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=x.device) / 16.0
    h, w = x.shape
    xp = _pad_edge(x, 2, 2, 0, 0)
    x = sum(k[i] * xp[i:i + h] for i in range(5))
    xp = _pad_edge(x, 0, 0, 2, 2)
    return sum(k[i] * xp[:, i:i + w] for i in range(5))


def _fgrad(x: torch.Tensor):
    """Forward differences, zero at the last row/col (Neumann)."""
    gx = F.pad(x[:, 1:] - x[:, :-1], (0, 1))
    gy = F.pad(x[1:] - x[:-1], (0, 0, 0, 1))
    return gx, gy


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Divergence = -adjoint of ``_fgrad``."""
    dx = torch.cat([px[:, :1], px[:, 1:-1] - px[:, :-2], -px[:, -2:-1]],
                   dim=1)
    dy = torch.cat([py[:1], py[1:-1] - py[:-2], -py[-2:-1]], dim=0)
    return dx + dy


def _tvl1_level(i0, i1, u1, u2, lam: float, theta: float, tau: float,
                warps: int, iters: int):
    """One pyramid level of duality-based TV-L1 (fixed iteration counts)."""
    l_t = lam * theta
    tt = tau / theta
    i1y, i1x = torch.gradient(i1)          # (d/dy, d/dx)
    p11 = torch.zeros_like(u1)
    p12, p21, p22 = p11, p11, p11
    for _ in range(warps):
        # the linearized residual stays anchored at this warp's flow u0
        i1w = _warp(i1, u1, u2)
        i1wx = _warp(i1x, u1, u2)
        i1wy = _warp(i1y, u1, u2)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
        for _ in range(iters):
            rho = rho_c + i1wx * u1 + i1wy * u2
            d = -rho / torch.clamp(grad, min=1e-9)
            mag = torch.clamp(d, -l_t, l_t)
            v1 = u1 + mag * i1wx
            v2 = u2 + mag * i1wy
            u1 = v1 + theta * _div(p11, p12)
            u2 = v2 + theta * _div(p21, p22)
            g11, g12 = _fgrad(u1)
            g21, g22 = _fgrad(u2)
            n1 = 1.0 + tt * torch.sqrt(g11 * g11 + g12 * g12)
            n2 = 1.0 + tt * torch.sqrt(g21 * g21 + g22 * g22)
            p11, p12 = (p11 + tt * g11) / n1, (p12 + tt * g12) / n1
            p21, p22 = (p21 + tt * g21) / n2, (p22 + tt * g22) / n2
    return u1, u2


def tvl1_flow(frame0, frame1, levels: int = 5, lam: float = 0.15,
              theta: float = 0.3, tau: float = 0.25, warps: int = 5,
              iters: int = 25, device="cuda") -> torch.Tensor:
    """TV-L1 flow frame0 -> frame1; (c, h, w) frames (numpy or torch) ->
    (2, h, w) (u, v) on ``device``.  The published defaults (lam 0.15 on
    the [0, 255] scale, theta 0.3, tau 0.25, 5 warps); ``iters`` fixes the
    inner primal-dual count."""
    device = torch.device(device)
    g0 = _blur121(_gray(frame0, device))
    g1 = _blur121(_gray(frame1, device))
    pyr = [(g0, g1)]
    for _ in range(1, levels):
        if min(pyr[-1][0].shape) < 16:
            break
        pyr.append((_avg_pool(_blur121(pyr[-1][0])),
                    _avg_pool(_blur121(pyr[-1][1]))))
    return _coarse_to_fine(
        pyr, lambda a, b, u, v: _tvl1_level(a, b, u, v, lam, theta, tau,
                                            warps, iters))


def estimate_flows(video, levels: int = 3, radius: int = 4, iters: int = 3,
                   method: str = "tvl1", device="cuda"):
    """(T, c, h, w) video (numpy or torch) -> (fflow, bflow), each (T, 2,
    h, w) f32 on ``device``: fflow[i] maps frame i -> i+1 (the last
    repeated), bflow[i] maps i -> i-1 (the first repeated), the layout
    ``denoise(..., flows=)`` takes.  ``method``: "tvl1" (default) or "lk";
    LK honours ``levels/radius/iters``, TV-L1 uses its published
    defaults."""
    device = torch.device(device)
    if isinstance(video, torch.Tensor):
        video = video.to(device=device, dtype=torch.float32)
    else:
        video = torch.as_tensor(video, dtype=torch.float32, device=device)
    t = video.shape[0]
    if method == "tvl1":
        f = functools.partial(tvl1_flow, device=device)
    elif method == "lk":
        f = functools.partial(lk_flow, levels=levels, radius=radius,
                              iters=iters, device=device)
    else:
        raise ValueError(f"unknown flow method [{method}]")
    if t < 2:
        z = torch.zeros((1, 2) + tuple(video.shape[2:]), dtype=torch.float32,
                        device=device)
        return z, z.clone()
    fwd = [f(video[i], video[i + 1]) for i in range(t - 1)]
    bwd = [f(video[i + 1], video[i]) for i in range(t - 1)]
    return torch.stack(fwd + [fwd[-1]]), torch.stack([bwd[0]] + bwd)
