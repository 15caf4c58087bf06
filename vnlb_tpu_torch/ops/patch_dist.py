"""K1: per-site patch distances as a CUDA kernel (csrc/patch_dist.cu).

For each query site (t, y, x), each temporal offset dt in [dt_lo, dt_lo +
n_dt) and each of the w_s x w_s candidate offsets (a, b):

    D[dt, s, a*w_s+b] = sum_{f<pt, c<C, i<ps, j<ps}
        (V[t+f, c, y+i, x+j] - V[t+dt+f, c, y0+a+i, x0+b+j])^2

with zero read outside the video.  The window starts at (y0, x0) = (y -
half, x - half) for the dense search, or at the per-(dt, site) starts
``sy, sx`` (n_dt, S) that the gather search gives (flow-tracked, sliding
windows).  One function covers level 0 and the coarse needle levels: only
the query coordinates and window starts differ.  Output is f32; the caller
rounds (search_bf16) and normalizes.

The tile entry ``patch_dist_tile`` (vnlb_tpu/ops/pallas_smat.py:526,
``smat_distances_dt_tile``) computes the same distances on a halo strip
tile of the H-sharded pass: the queries are tile coordinates, tile row 0 is
global row ``base_row``, and a candidate whose GLOBAL corner lies outside
[0, hp_g-1] x [0, wp_g-1] is +inf (its arithmetic skipped in the kernel).

``patch_dist`` and ``patch_dist_tile`` dispatch by device: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel, and a build or
launch failure raises.  ``patch_dist.launches`` and
``patch_dist_tile.launches`` count kernel launches.

``plan`` mirrors the kernel's launch arithmetic (register-tiled
candidates, several (site, dt) pairs per block, double-buffered planes;
the design is described in csrc/patch_dist.cu); ``card_plan`` asks the
kernel library for the same plan and the occupancy the card grants.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

__all__ = ["patch_dist", "patch_dist_plain", "patch_dist_kernel",
           "patch_dist_tile", "patch_dist_tile_plain", "tile_oob", "plan",
           "card_plan", "PLAN_FIELDS"]

# sites per chunk of the plain version (bounds its gathered regions)
_PLAIN_CHUNK = 4096

# the kernel's constants (csrc/patch_dist.cu)
MICRO_ROWS, MICRO_COLS = 3, 5     # candidates of a thread's micro-tile
MAX_THREADS = 256
BLOCKS_PER_SM = 2                 # __launch_bounds__ minimum
MAX_SITES_PER_GROUP = 4
WAVE_BLOCKS = 132 * BLOCKS_PER_SM * 4
PATCH_SIZES = (3, 5, 7)           # ps the kernel is instantiated for
PLAN_FIELDS = ("threads", "lanes", "pairs_per_block", "sites_per_group",
               "micro_rows", "micro_cols", "tiles_down", "tiles_across",
               "region_rows", "region_cols", "smem_bytes", "blocks_per_sm",
               "grid_x")


def plan(ps: int, w_s: int, s_cnt: int, n_dt: int) -> dict:
    """The kernel's launch plan (csrc/patch_dist.cu ``make_plan``) for
    ``s_cnt`` sites and ``n_dt`` planes: a group of ``lanes`` threads
    (tiles_down x tiles_across of them owning a micro_rows x micro_cols
    tile of candidates, all of them copying) serves one (site, dt) pair; a
    block holds pairs_per_block groups and each group walks
    sites_per_group sites; blockIdx.y is the dt plane.  Shared memory
    holds a double buffer of one padded region plane and one query patch
    per group, whatever pt*C is.  Raises ValueError for a shape the kernel
    does not take."""
    if ps not in PATCH_SIZES:
        raise ValueError(f"patch_dist kernel: ps={ps} not in {PATCH_SIZES}")
    n_a = -(-w_s // MICRO_ROWS)
    n_b = -(-w_s // MICRO_COLS)
    if w_s < 1 or n_a * n_b > MAX_THREADS:
        raise ValueError(f"patch_dist kernel: w_s={w_s} needs more than "
                         f"{MAX_THREADS} threads per pair")
    lanes = 16 if n_a * n_b <= 16 else -(-n_a * n_b // 32) * 32
    groups = MAX_THREADS // lanes
    rows, cols = n_a * MICRO_ROWS + ps - 1, n_b * MICRO_COLS + ps - 1
    if cols > 2 * lanes:      # a lane copies at most two columns of a row
        raise ValueError(f"patch_dist kernel: w_s={w_s} gives region rows "
                         f"of {cols} > 2 x {lanes} lanes")
    m = min(max(s_cnt * n_dt // (groups * WAVE_BLOCKS), 1),
            MAX_SITES_PER_GROUP)
    stride = (rows * cols + -(-ps * ps // 4) * 4 + 15) // 32 * 32 + 16
    return dict(threads=groups * lanes, lanes=lanes, pairs_per_block=groups,
                sites_per_group=m, micro_rows=MICRO_ROWS,
                micro_cols=MICRO_COLS, tiles_down=n_a, tiles_across=n_b,
                region_rows=rows, region_cols=cols,
                smem_bytes=2 * groups * stride * 4,
                blocks_per_sm=BLOCKS_PER_SM,
                grid_x=-(-s_cnt // (groups * m)))


def card_plan(ps: int, w_s: int, s_cnt: int, n_dt: int
              ) -> tuple[dict, int]:
    """(the kernel library's plan, the blocks per SM the card grants the
    dense entry at it); needs the CUDA build."""
    buf = (ctypes.c_int * 14)()
    _build.check(_build.library().vnlb_patch_dist_plan(ps, w_s, s_cnt, n_dt,
                                                       buf),
                 "patch_dist plan")
    return dict(zip(PLAN_FIELDS, buf[:13])), buf[13]


def _check(vid, qt, qy, qx, n_dt, sy, sx):
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
    _check(vid, qt, qy, qx, n_dt, sy, sx)
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


def patch_dist_kernel(vid: torch.Tensor, qt: torch.Tensor, qy: torch.Tensor,
                      qx: torch.Tensor, dt_lo: int, n_dt: int, pt: int,
                      ps: int, w_s: int, sy: Optional[torch.Tensor] = None,
                      sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel; all tensors on one CUDA device."""
    _check(vid, qt, qy, qx, n_dt, sy, sx)
    ints = [qt, qy, qx] + ([] if sy is None else [sy, sx])
    if not (vid.is_cuda and all(v.is_cuda for v in ints)):
        raise ValueError("patch_dist_kernel needs CUDA tensors")
    plan(ps, w_s, qt.shape[0], n_dt)
    t_len, c, h, w = vid.shape
    vid = vid.contiguous()
    ints = [v.to(torch.int32).contiguous() for v in ints]
    starts = (ints[3].data_ptr(), ints[4].data_ptr()) if sy is not None \
        else (None, None)
    s_cnt = qt.shape[0]
    out = torch.empty((n_dt, s_cnt, w_s * w_s), dtype=torch.float32,
                      device=vid.device)
    lib = _build.library()
    err = lib.vnlb_patch_dist(
        vid.data_ptr(), t_len, c, h, w, ints[0].data_ptr(),
        ints[1].data_ptr(), ints[2].data_ptr(), *starts, s_cnt, dt_lo, n_dt,
        pt, ps, w_s, out.data_ptr(),
        torch.cuda.current_stream(vid.device).cuda_stream)
    _build.check(err, "patch_dist kernel")
    patch_dist.launches += 1
    return out


def patch_dist(vid: torch.Tensor, qt: torch.Tensor, qy: torch.Tensor,
               qx: torch.Tensor, dt_lo: int, n_dt: int, pt: int, ps: int,
               w_s: int, sy: Optional[torch.Tensor] = None,
               sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_dt, S, w_s*w_s) raw squared patch distances: the plain version for
    a CPU video, the CUDA kernel for a CUDA video."""
    if vid.device.type == "cpu":
        return patch_dist_plain(vid, qt, qy, qx, dt_lo, n_dt, pt, ps, w_s,
                                sy, sx)
    if vid.device.type == "cuda":
        return patch_dist_kernel(vid, qt, qy, qx, dt_lo, n_dt, pt, ps, w_s,
                                 sy, sx)
    raise ValueError(f"unsupported device {vid.device}")


patch_dist.launches = 0


def tile_oob(qy: torch.Tensor, qx: torch.Tensor, w_s: int, base_row: int,
             hp_g: int, wp_g: int) -> torch.Tensor:
    """(S, w_s*w_s) bool: candidate corners (tile row qy - half + a, column
    qx - half + b) outside the global frame [0, hp_g-1] x [0, wp_g-1]."""
    half = (w_s - 1) // 2
    d = torch.arange(w_s, device=qy.device)
    cy = qy.long()[:, None, None] - half + d[None, :, None] + base_row
    cx = qx.long()[:, None, None] - half + d[None, None, :]
    bad = (cy < 0) | (cy > hp_g - 1) | (cx < 0) | (cx > wp_g - 1)
    return bad.reshape(qy.shape[0], w_s * w_s)


def patch_dist_tile_plain(vid: torch.Tensor, qt: torch.Tensor,
                          qy: torch.Tensor, qx: torch.Tensor, dt_lo: int,
                          n_dt: int, pt: int, ps: int, w_s: int,
                          base_row: int, hp_g: int,
                          wp_g: int) -> torch.Tensor:
    """Plain version of the tile entry: ``patch_dist_plain``, then +inf at
    the candidates outside the global frame."""
    out = patch_dist_plain(vid, qt, qy, qx, dt_lo, n_dt, pt, ps, w_s)
    bad = tile_oob(qy, qx, w_s, base_row, hp_g, wp_g)
    return out.masked_fill_(bad[None], float("inf"))


def patch_dist_tile_kernel(vid: torch.Tensor, qt: torch.Tensor,
                           qy: torch.Tensor, qx: torch.Tensor, dt_lo: int,
                           n_dt: int, pt: int, ps: int, w_s: int,
                           base_row: int, hp_g: int,
                           wp_g: int) -> torch.Tensor:
    """Launch the tile entry's CUDA kernel; all tensors on one CUDA
    device."""
    _check(vid, qt, qy, qx, n_dt, None, None)
    if not (vid.is_cuda and qt.is_cuda and qy.is_cuda and qx.is_cuda):
        raise ValueError("patch_dist_tile_kernel needs CUDA tensors")
    plan(ps, w_s, qt.shape[0], n_dt)
    t_len, c, h, w = vid.shape
    vid = vid.contiguous()
    ints = [v.to(torch.int32).contiguous() for v in (qt, qy, qx)]
    s_cnt = qt.shape[0]
    out = torch.empty((n_dt, s_cnt, w_s * w_s), dtype=torch.float32,
                      device=vid.device)
    err = _build.library().vnlb_patch_dist_tile(
        vid.data_ptr(), t_len, c, h, w, *(v.data_ptr() for v in ints), s_cnt,
        dt_lo, n_dt, pt, ps, w_s, base_row, hp_g, wp_g, out.data_ptr(),
        torch.cuda.current_stream(vid.device).cuda_stream)
    _build.check(err, "patch_dist_tile kernel")
    patch_dist_tile.launches += 1
    return out


def patch_dist_tile(vid: torch.Tensor, qt: torch.Tensor, qy: torch.Tensor,
                    qx: torch.Tensor, dt_lo: int, n_dt: int, pt: int,
                    ps: int, w_s: int, base_row: int, hp_g: int,
                    wp_g: int) -> torch.Tensor:
    """(n_dt, S, w_s*w_s) raw squared patch distances on a halo tile, +inf
    out of the global frame: the plain version for a CPU video, the CUDA
    kernel for a CUDA video."""
    args = (vid, qt, qy, qx, dt_lo, n_dt, pt, ps, w_s, base_row, hp_g, wp_g)
    if vid.device.type == "cpu":
        return patch_dist_tile_plain(*args)
    if vid.device.type == "cuda":
        return patch_dist_tile_kernel(*args)
    raise ValueError(f"unsupported device {vid.device}")


patch_dist_tile.launches = 0
