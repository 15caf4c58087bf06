"""The plain versions of the port's kernels K1, K3 and K4 (frozen from
vnlb_tpu_torch/ops/patch_dist.py, dense_dist.py and patch_gather.py),
with nothing of the CUDA build."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from .gather import decode_corners

# sites per chunk of K1's plain version (bounds its gathered regions)
_PLAIN_CHUNK = 4096


def _dist_check(vid, qt, qy, qx, n_dt, sy, sx):
    if vid.dim() != 4 or vid.dtype != torch.float32:
        raise ValueError(f"video must be (T, C, H, W) float32, got "
                         f"{tuple(vid.shape)} {vid.dtype}")
    if not (qt.shape == qy.shape == qx.shape and qt.dim() == 1):
        raise ValueError("query coordinates must be three (S,) vectors")
    if (sy is None) != (sx is None):
        raise ValueError("window starts need both sy and sx")
    if sy is not None and not (sy.shape == sx.shape == (n_dt, qt.shape[0])):
        raise ValueError(f"window starts must be (n_dt, S) = "
                         f"{(n_dt, qt.shape[0])}, got {tuple(sy.shape)}")


def patch_dist_plain(vid: torch.Tensor, qt: torch.Tensor, qy: torch.Tensor,
                     qx: torch.Tensor, dt_lo: int, n_dt: int, pt: int,
                     ps: int, w_s: int, sy: Optional[torch.Tensor] = None,
                     sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: gathers each site's search region (zero
    outside the video) and sums squared differences over the ps x ps patch
    offsets."""
    _dist_check(vid, qt, qy, qx, n_dt, sy, sx)
    t_len, c, h, w = vid.shape
    half = (w_s - 1) // 2
    r = w_s + ps - 1
    dev = vid.device
    s_cnt = qt.shape[0]
    out = torch.empty((n_dt, s_cnt, w_s * w_s), dtype=torch.float32,
                      device=dev)
    ar_r = torch.arange(r, device=dev)
    ar_p = torch.arange(ps, device=dev)
    ar_f = torch.arange(pt, device=dev)
    ar_c = torch.arange(c, device=dev)[None, None, :, None, None]
    zero = torch.zeros((), device=dev)

    def grab(tt, yy, xx):
        """(S, pt) frames, (S, ny) rows, (S, nx) columns -> (S, pt, C, ny,
        nx) values, zero outside the video."""
        tt = tt[:, :, None, None, None]
        yy = yy[:, None, None, :, None]
        xx = xx[:, None, None, None, :]
        ok = ((tt >= 0) & (tt < t_len) & (yy >= 0) & (yy < h) & (xx >= 0)
              & (xx < w))
        v = vid[tt.clamp(0, t_len - 1), ar_c, yy.clamp(0, h - 1),
                xx.clamp(0, w - 1)]
        return torch.where(ok, v, zero)

    for s0 in range(0, s_cnt, _PLAIN_CHUNK):
        sl = slice(s0, s0 + _PLAIN_CHUNK)
        t, y, x = qt[sl].long(), qy[sl].long(), qx[sl].long()
        q = grab(t[:, None] + ar_f, y[:, None] + ar_p, x[:, None] + ar_p)
        for di in range(n_dt):
            if sy is None:
                y0, x0 = y - half, x - half
            else:
                y0, x0 = sy[di, sl].long(), sx[di, sl].long()
            reg = grab(t[:, None] + (dt_lo + di) + ar_f, y0[:, None] + ar_r,
                       x0[:, None] + ar_r)
            acc = torch.zeros((t.shape[0], w_s, w_s), dtype=torch.float32,
                              device=dev)
            for i in range(ps):
                for j in range(ps):
                    d = (q[:, :, :, i:i + 1, j:j + 1]
                         - reg[:, :, :, i:i + w_s, j:j + w_s])
                    acc += (d * d).sum(dim=(1, 2))
            out[di, sl] = acc.reshape(t.shape[0], -1)
    return out


def _gather_check(videos, inds):
    if len(videos) not in (1, 2):
        raise ValueError(f"one or two videos, got {len(videos)}")
    shape = videos[0].shape
    for v in videos:
        if v.dim() != 4 or v.dtype != torch.float32 or v.shape != shape:
            raise ValueError(f"videos must be (T, C, H, W) float32 of one "
                             f"shape, got {tuple(v.shape)} {v.dtype}")
    if inds.dim() != 2:
        raise ValueError(f"inds must be (B, K), got {tuple(inds.shape)}")


def patch_offsets(shape, ps: int, pt: int, device) -> torch.Tensor:
    """(C, pt*ps*ps) flat video offsets of a patch's pixels from its corner,
    in c-major (c, j, dy, dx) order."""
    t_len, c, h, w = shape
    ci = torch.arange(c, device=device)[:, None, None, None]
    j = torch.arange(pt, device=device)[None, :, None, None]
    dy = torch.arange(ps, device=device)[None, None, :, None]
    dx = torch.arange(ps, device=device)[None, None, None, :]
    off = (j * c + ci) * (h * w) + dy * w + dx
    return off.reshape(c, pt * ps * ps)


def patch_gather_plain(videos: Sequence[torch.Tensor], inds: torch.Tensor,
                       ps: int, pt: int, bf16: bool) -> List[torch.Tensor]:
    """Plain PyTorch version: one int64 (B, K, C, pt*ps*ps) index into the
    flattened video, shared by both videos."""
    _gather_check(videos, inds)
    shape = videos[0].shape
    t_len, c, h, w = shape
    f, y, x = decode_corners(inds, shape, ps, pt)
    base = f * (c * h * w) + y * w + x                        # (B, K)
    off = patch_offsets(shape, ps, pt, inds.device)            # (C, p)
    idx = base[:, :, None, None] + off[None, None]
    outs = []
    for v in videos:
        out = v.reshape(-1)[idx]
        if bf16:
            out = out.to(torch.bfloat16).to(torch.float32)
        outs.append(out)
    return outs


def frame_range(t_len: int, pt: int, dt: int):
    """Output frames [f_lo, f_hi) of offset ``dt``: those with 0 <= f and
    f + dt <= T - pt."""
    f_cnt = t_len - pt + 1
    return max(0, -dt), min(f_cnt, f_cnt - dt)


def _dense_check(vid, dt, pt, ps, w_s):
    if vid.dim() != 4 or vid.dtype != torch.float32:
        raise ValueError(f"video must be (T, C, H, W) float32, got "
                         f"{tuple(vid.shape)} {vid.dtype}")
    t_len, _, h, w = vid.shape
    if h < ps or w < ps or pt > t_len:
        raise ValueError(f"video {tuple(vid.shape)} smaller than a "
                         f"({pt}, {ps}, {ps}) patch")
    f_lo, f_hi = frame_range(t_len, pt, dt)
    if f_hi <= f_lo:
        raise ValueError(f"dt={dt} leaves no valid frame of {t_len}")
    return f_lo, f_hi


def _box_ps(x: torch.Tensor, ps: int) -> torch.Tensor:
    """Separable ps x ps box sum, VALID, as the cumsum difference of
    vnlb_tpu/ops/search_dense.py:41-49.  The running sums are taken in f64:
    an f32 prefix over a 480x854 frame loses more than the 1e-5 of q2 + b2
    that the kernel is held to (chip_smoke.py prints the f32 loss)."""
    xr = torch.cumsum(x.to(torch.float64), dim=-1)
    xr = torch.cat([xr[..., ps - 1:ps], xr[..., ps:] - xr[..., :-ps]], dim=-1)
    xc = torch.cumsum(xr, dim=-2)
    xc = torch.cat([xc[..., ps - 1:ps, :], xc[..., ps:, :] - xc[..., :-ps, :]],
                   dim=-2)
    return xc.to(torch.float32)


def dense_dist_plain(vid: torch.Tensor, dt: int, pt: int, ps: int,
                     w_s: int) -> torch.Tensor:
    """Plain PyTorch version, the XLA branch of ``_level_dense``: one
    elementwise product and one box sum per offset."""
    f_lo, f_hi = _dense_check(vid, dt, pt, ps, w_s)
    t_len, _, h, w = vid.shape
    n_f = f_hi - f_lo
    half = (w_s - 1) // 2
    hp, wp = h - ps + 1, w - ps + 1
    f_cnt = t_len - pt + 1
    v2 = (vid * vid).sum(dim=1)                             # (T, H, W)
    box_v2 = _box_ps(sum(v2[p:p + f_cnt] for p in range(pt)), ps)
    q2 = box_v2[f_lo:f_hi]
    b2 = F.pad(box_v2[f_lo + dt:f_hi + dt], (half, half, half, half))
    vq = vid[f_lo:f_hi + pt - 1]
    vd = F.pad(vid[f_lo + dt:f_hi + dt + pt - 1], (half, half, half, half))
    out = torch.empty((n_f, hp, wp, w_s * w_s), dtype=torch.float32,
                      device=vid.device)
    for a in range(w_s):
        for b in range(w_s):
            prod = (vq * vd[:, :, a:a + h, b:b + w]).sum(dim=1)
            cross = _box_ps(sum(prod[p:p + n_f] for p in range(pt)), ps)
            out[..., a * w_s + b] = (q2 + b2[:, a:a + hp, b:b + wp]
                                     - 2.0 * cross)
    return out
