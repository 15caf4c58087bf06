"""K3: dense candidate distances of the all-rows zero-flow search as a CUDA
kernel (csrc/dense_dist.cu).

For one temporal offset dt and every query corner (y, x) of every frame f
whose candidate frame is valid (``frame_range``), and every offset (a, b)
of the w_s x w_s window:

    D[f, y, x, a*w_s+b] = q2(f, y, x) + b2(f+dt, y+a-half, x+b-half)
                          - 2 * box_ps(sum_p V_p[f] * V_p[f+dt](. + delta))

with q2 / b2 the ps x ps box sums of the squared pt-frame stacks, b2 zero
where the candidate corner lies outside the frame and V read as zero
outside the frame (vnlb_tpu/ops/search_dense.py:52-123, ``_level_dense``).
JAX computes every frame of a rolled video and leaves the rows of invalid
frames as garbage for the caller to mask; the port computes only the
frames [f_lo, f_hi) whose candidate frames exist.  The layout is
site-major (n_f, H', W', w_s^2): a site's candidates are one row.

``dense_dist`` dispatches by device: a CPU tensor takes the plain version
``dense_dist_plain``; a CUDA tensor launches the kernel, and a build or
launch failure raises.  ``dense_dist.launches`` counts kernel launches.

``plan`` mirrors the kernel's launch arithmetic (column strips with a
sliding box in registers; the design is described in csrc/dense_dist.cu);
``card_plan`` asks the kernel library for the same plan and the occupancy
the card grants.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["dense_dist", "dense_dist_plain", "dense_dist_kernel",
           "frame_range", "plan", "tasks_of_warp", "card_plan",
           "PLAN_FIELDS"]

# patch sizes the kernel is instantiated for
KERNEL_PS = (3, 5, 7, 9)

# the kernel's constants (csrc/dense_dist.cu)
THREADS = 256
BLOCKS_PER_SM = 2                 # __launch_bounds__ minimum
STRIP_W = 8                       # outputs of a column strip
TILE_H = 16
TILE_W = (32, 16, 8)              # widest first
SM_SMEM = 233472                  # 228 KB per SM on the H100
BLOCK_SMEM_MAX = 232448           # 227 KB per block
RESERVED = 1024                   # per resident block
PLAN_FIELDS = ("threads", "tile_h", "tile_w", "strip_w", "strips", "items",
               "full_chunks", "tail_tasks", "warp_tasks", "query_pitch",
               "cand_rows", "cand_pitch", "b2_pitch", "smem_bytes",
               "blocks_per_sm", "grid_x", "grid_y", "grid_z")


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _bank_pitch(width: int, w_s: int) -> int:
    """Smallest pitch >= width congruent to w_s modulo 32."""
    return width + (w_s - width) % 32


def _tile_plan(ps: int, w_s: int, ptc: int, tw: int) -> dict:
    th, strips, ws2 = TILE_H, tw // STRIP_W, w_s * w_s
    tail_tasks = -(-strips * (ws2 % 32) // 32)
    qrows, qpitch = th + ps - 1, tw - STRIP_W + _round4(STRIP_W + ps - 1)
    drows, dw = qrows + w_s - 1, tw + ps - 1 + w_s - 1
    bh, bw = th + w_s - 1, tw + w_s - 1
    dpitch, bpitch = _bank_pitch(dw, w_s), _bank_pitch(bw, w_s)
    floats = (_round4(ptc * qrows * qpitch) + _round4(ptc * drows * dpitch)
              + _round4(bh * bpitch) + _round4(th * tw) + _round4(drows * bw)
              + _round4(qrows * tw))
    smem = floats * 4
    return dict(threads=THREADS, tile_h=th, tile_w=tw, strip_w=STRIP_W,
                strips=strips, items=strips * ws2, full_chunks=ws2 // 32,
                tail_tasks=tail_tasks,
                warp_tasks=strips * (ws2 // 32) + tail_tasks,
                query_pitch=qpitch, cand_rows=drows, cand_pitch=dpitch,
                b2_pitch=bpitch, smem_bytes=smem,
                blocks_per_sm=min(SM_SMEM // (smem + RESERVED),
                                  BLOCKS_PER_SM))


def plan(ps: int, w_s: int, ptc: int, h: int, w: int, n_f: int) -> dict:
    """The kernel's launch plan (csrc/dense_dist.cu ``make_plan``) for a
    (T, C, h, w) level with ptc = pt*C planes and n_f output frames: a
    block holds a tile_h x tile_w output tile (tile_w the widest of
    ``TILE_W`` that lets BLOCKS_PER_SM blocks share an SM), cut into
    column strips of strip_w outputs; an item is one (strip, offset) pair.
    A warp task is 32 items: ``full_chunks`` whole warps of each strip's
    offsets, then ``tail_tasks`` warps that pack the last w_s^2 mod 32
    offsets of every strip (``warp_tasks`` in all; ``tasks_of_warp`` gives
    a warp's share).  The grid is (tiles across, tiles down, frames).
    Raises ValueError for a shape the kernel does not take."""
    if ps not in KERNEL_PS:
        raise ValueError(f"dense_dist kernel: ps={ps} not in {KERNEL_PS}")
    if w_s < 1 or ptc < 1 or h < ps or w < ps:
        raise ValueError(f"dense_dist kernel: no plan for w_s={w_s}, "
                         f"ptc={ptc}, {h}x{w}")
    for tw in TILE_W:
        pl = _tile_plan(ps, w_s, ptc, tw)
        if pl["blocks_per_sm"] >= BLOCKS_PER_SM:
            break
    if pl["smem_bytes"] > BLOCK_SMEM_MAX or pl["blocks_per_sm"] < 1:
        raise ValueError(f"dense_dist kernel: a tile of w_s={w_s}, "
                         f"ptc={ptc} needs {pl['smem_bytes']} B of shared "
                         f"memory")
    pl.update(grid_x=-(-(w - ps + 1) // pl["tile_w"]),
              grid_y=-(-(h - ps + 1) // pl["tile_h"]), grid_z=n_f)
    return pl


def tasks_of_warp(pl: dict, warp: int) -> list:
    """Warp ``warp``'s work in the kernel's order: for each lane a list of
    (strip, offset) items, None for an idle lane.  Chunks warp, warp +
    W, ... of 32 offsets of strip 0, then of strip 1, ...; then tail tasks
    (warp - full_chunks) mod W, + W, ... (W = threads / 32)."""
    n_w, full = pl["threads"] // 32, pl["full_chunks"]
    ws2 = pl["items"] // pl["strips"]
    tl = ws2 - 32 * full
    work = []
    for s in range(pl["strips"]):
        for c in range(warp, full, n_w):
            work.append([(s, 32 * c + lane) for lane in range(32)])
    for t in range((warp - full) % n_w, pl["tail_tasks"], n_w):
        its = [32 * t + lane for lane in range(32)]
        work.append([(it // tl, 32 * full + it % tl)
                     if it < pl["strips"] * tl else None for it in its])
    return work


def card_plan(ps: int, w_s: int, ptc: int, h: int, w: int, n_f: int
              ) -> tuple[dict, int]:
    """(the kernel library's plan, the blocks per SM the card grants the
    kernel at it); needs the CUDA build."""
    buf = (ctypes.c_int * 19)()
    _build.check(_build.library().vnlb_dense_dist_plan(ps, w_s, ptc, h, w,
                                                       n_f, buf),
                 "dense_dist plan")
    return dict(zip(PLAN_FIELDS, buf[:18])), buf[18]


def frame_range(t_len: int, pt: int, dt: int):
    """Output frames [f_lo, f_hi) of offset ``dt``: those with 0 <= f and
    f + dt <= T - pt."""
    f_cnt = t_len - pt + 1
    return max(0, -dt), min(f_cnt, f_cnt - dt)


def _check(vid, dt, pt, ps, w_s):
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
    f_lo, f_hi = _check(vid, dt, pt, ps, w_s)
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


def dense_dist_kernel(vid: torch.Tensor, dt: int, pt: int, ps: int,
                      w_s: int) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA video."""
    f_lo, f_hi = _check(vid, dt, pt, ps, w_s)
    if not vid.is_cuda:
        raise ValueError("dense_dist_kernel needs a CUDA tensor")
    if ps not in KERNEL_PS:
        raise NotImplementedError(f"the K3 kernel is built for ps in "
                                  f"{KERNEL_PS}, got {ps}")
    t_len, c, h, w = vid.shape
    plan(ps, w_s, pt * c, h, w, f_hi - f_lo)
    vid = vid.contiguous()
    out = torch.empty((f_hi - f_lo, h - ps + 1, w - ps + 1, w_s * w_s),
                      dtype=torch.float32, device=vid.device)
    err = _build.library().vnlb_dense_dist(
        vid.data_ptr(), t_len, c, h, w, pt, ps, w_s, dt, f_lo, f_hi - f_lo,
        out.data_ptr(), torch.cuda.current_stream(vid.device).cuda_stream)
    _build.check(err, "dense_dist kernel")
    dense_dist.launches += 1
    return out


def dense_dist(vid: torch.Tensor, dt: int, pt: int, ps: int,
               w_s: int) -> torch.Tensor:
    """(f_hi-f_lo, H', W', w_s*w_s) raw distances of offset ``dt`` (frames
    from ``frame_range``): the plain version for a CPU video, the CUDA
    kernel for a CUDA video."""
    if vid.device.type == "cpu":
        return dense_dist_plain(vid, dt, pt, ps, w_s)
    if vid.device.type == "cuda":
        return dense_dist_kernel(vid, dt, pt, ps, w_s)
    raise ValueError(f"unsupported device {vid.device}")


dense_dist.launches = 0
