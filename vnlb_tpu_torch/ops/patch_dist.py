"""K1: per-site patch distances as a CUDA kernel (csrc/patch_dist.cu).

For each query site (t, y, x), each temporal offset dt in [dt_lo, dt_lo +
n_dt) and each of the w_s x w_s candidate offsets (a, b):

    D[dt, s, a*w_s+b] = sum_{f<pt, c<C, i<ps, j<ps}
        (V[t+f, c, y+i, x+j] - V[t+dt+f, c, y-half+a+i, x-half+b+j])^2

with zero read outside the video.  One function covers level 0 and the
coarse needle levels: only the query coordinates differ.  Output is f32;
the caller rounds (search_bf16) and normalizes.

``patch_dist`` dispatches by device: a CPU tensor takes the plain version
``patch_dist_plain``; a CUDA tensor launches the kernel, and a build or
launch failure raises.  ``patch_dist.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["patch_dist", "patch_dist_plain", "patch_dist_kernel"]

# sites per chunk of the plain version (bounds its gathered regions)
_PLAIN_CHUNK = 4096


def _check(vid, qt, qy, qx):
    if vid.dim() != 4 or vid.dtype != torch.float32:
        raise ValueError(f"video must be (T, C, H, W) float32, got "
                         f"{tuple(vid.shape)} {vid.dtype}")
    if not (qt.shape == qy.shape == qx.shape and qt.dim() == 1):
        raise ValueError("query coordinates must be three (S,) vectors")


def patch_dist_plain(vid: torch.Tensor, qt: torch.Tensor, qy: torch.Tensor,
                     qx: torch.Tensor, dt_lo: int, n_dt: int, pt: int,
                     ps: int, w_s: int) -> torch.Tensor:
    """Plain PyTorch version: gathers each site's zero-padded search region
    and sums squared differences over the ps x ps patch offsets."""
    _check(vid, qt, qy, qx)
    t_len, c, h, w = vid.shape
    half = (w_s - 1) // 2
    r = w_s + ps - 1
    dev = vid.device
    s_cnt = qt.shape[0]
    # zero padding: ``half`` pixels around the frame, and a zero frame that
    # out-of-range frame indices are redirected to
    vp = torch.nn.functional.pad(vid, (half, half + ps, half, half + ps))
    vp = torch.cat([vp, torch.zeros_like(vp[:1])], dim=0)
    out = torch.empty((n_dt, s_cnt, w_s * w_s), dtype=torch.float32,
                      device=dev)
    ar_r = torch.arange(r, device=dev)
    ar_p = torch.arange(ps, device=dev)
    ar_f = torch.arange(pt, device=dev)
    ar_c = torch.arange(c, device=dev)
    for s0 in range(0, s_cnt, _PLAIN_CHUNK):
        t = qt[s0:s0 + _PLAIN_CHUNK].long()
        y = qy[s0:s0 + _PLAIN_CHUNK].long() + half
        x = qx[s0:s0 + _PLAIN_CHUNK].long() + half

        def frames(tt):
            ok = (tt >= 0) & (tt < t_len)
            return torch.where(ok, tt, t_len)

        def grab(tt, yy, xx):                 # -> (S, pt, C, ny, nx)
            return vp[tt[:, :, None, None, None], ar_c[None, None, :, None, None],
                      yy[:, None, None, :, None], xx[:, None, None, None, :]]

        tq = frames(t[:, None] + ar_f[None, :])
        q = grab(tq, y[:, None] + ar_p[None, :], x[:, None] + ar_p[None, :])
        ry = y[:, None] - half + ar_r[None, :]
        rx = x[:, None] - half + ar_r[None, :]
        for di in range(n_dt):
            td = frames(t[:, None] + (dt_lo + di) + ar_f[None, :])
            reg = grab(td, ry, rx)
            acc = torch.zeros((t.shape[0], w_s, w_s), dtype=torch.float32,
                              device=dev)
            for i in range(ps):
                for j in range(ps):
                    d = (q[:, :, :, i:i + 1, j:j + 1]
                         - reg[:, :, :, i:i + w_s, j:j + w_s])
                    acc += (d * d).sum(dim=(1, 2))
            out[di, s0:s0 + t.shape[0]] = acc.reshape(t.shape[0], -1)
    return out


def patch_dist_kernel(vid: torch.Tensor, qt: torch.Tensor, qy: torch.Tensor,
                      qx: torch.Tensor, dt_lo: int, n_dt: int, pt: int,
                      ps: int, w_s: int) -> torch.Tensor:
    """Launch the CUDA kernel; all tensors on one CUDA device."""
    _check(vid, qt, qy, qx)
    if not (vid.is_cuda and qt.is_cuda and qy.is_cuda and qx.is_cuda):
        raise ValueError("patch_dist_kernel needs CUDA tensors")
    t_len, c, h, w = vid.shape
    vid = vid.contiguous()
    qt, qy, qx = (v.to(torch.int32).contiguous() for v in (qt, qy, qx))
    s_cnt = qt.shape[0]
    out = torch.empty((n_dt, s_cnt, w_s * w_s), dtype=torch.float32,
                      device=vid.device)
    lib = _build.library()
    err = lib.vnlb_patch_dist(
        vid.data_ptr(), t_len, c, h, w, qt.data_ptr(), qy.data_ptr(),
        qx.data_ptr(), s_cnt, dt_lo, n_dt, pt, ps, w_s, out.data_ptr(),
        torch.cuda.current_stream(vid.device).cuda_stream)
    _build.check(err, "patch_dist kernel")
    patch_dist.launches += 1
    return out


def patch_dist(vid: torch.Tensor, qt: torch.Tensor, qy: torch.Tensor,
               qx: torch.Tensor, dt_lo: int, n_dt: int, pt: int, ps: int,
               w_s: int) -> torch.Tensor:
    """(n_dt, S, w_s*w_s) raw squared patch distances: the plain version for
    a CPU video, the CUDA kernel for a CUDA video."""
    if vid.device.type == "cpu":
        return patch_dist_plain(vid, qt, qy, qx, dt_lo, n_dt, pt, ps, w_s)
    if vid.device.type == "cuda":
        return patch_dist_kernel(vid, qt, qy, qx, dt_lo, n_dt, pt, ps, w_s)
    raise ValueError(f"unsupported device {vid.device}")


patch_dist.launches = 0
