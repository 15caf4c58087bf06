"""K6: the aggregation's segmented row scatter as a CUDA kernel
(csrc/scatter_rows.cu).  It replaces no Pallas kernel; the JAX package
leaves the scatter to XLA.

``agg.agg_rows`` sorts a chunk's flat accumulator rows stably (``srt``,
int32, and the permutation ``perm``) and hands them here with the filter's
(B, K, pt, C, ps, ps) output (the kernel reads its first ka patches in
place) and the (B, ka) aggregation weights.  Update j = perm[i] is patch
j % ka of site j // ka: its lanes are the patch times its weight, then the
weight, each rounded to bf16 and back under ``bf16``.  Every accumulator
row receives its updates in their original order, so the result is
bitwise the ranked scatter's (``agg.scatter_add_rows``), whose rounds are
the plain version here.

``scatter_rows`` dispatches by device: CPU tensors take the plain version
``scatter_rows_plain``; CUDA tensors launch the kernel, and a build or
launch failure raises.  ``scatter_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .agg import add_by_rank, rank_order

__all__ = ["scatter_rows", "scatter_rows_plain", "scatter_rows_kernel"]

# patch lanes the kernel's shared offset table holds (kMaxLanes)
MAX_LANES = 12288


def _check(acc, patches, wts, srt, perm):
    if acc.dim() != 2 or acc.dtype != torch.float32:
        raise ValueError(f"acc must be (N, L) float32, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    if acc.shape[0] >= 2 ** 31:
        raise ValueError(f"{acc.shape[0]} accumulator rows do not fit the "
                         f"int32 sort key")
    b, ka = wts.shape
    ptd = acc.shape[1] - 1
    if (patches.dtype != torch.float32 or patches.dim() < 2
            or patches.shape[0] != b or patches.shape[1] < ka
            or patches.shape[2:].numel() != ptd):
        raise ValueError(f"patches must be (B, K >= {ka}, ...) float32 with "
                         f"{ptd} values a patch, got "
                         f"{tuple(patches.shape)} {patches.dtype}")
    if wts.dtype != torch.float32:
        raise ValueError(f"weights must be float32, got {wts.dtype}")
    if (srt.dtype != torch.int32 or perm.dtype != torch.int64
            or srt.shape != (b * ka,) or perm.shape != (b * ka,)):
        raise ValueError(f"srt / perm must be ({b * ka},) int32 / int64, got "
                         f"{tuple(srt.shape)} {srt.dtype} / "
                         f"{tuple(perm.shape)} {perm.dtype}")


def scatter_rows_plain(acc: torch.Tensor, patches: torch.Tensor,
                       wts: torch.Tensor, srt: torch.Tensor,
                       perm: torch.Tensor, bf16: bool = False) -> None:
    """Plain PyTorch version: the (B*ka, L) update rows, then the ranked
    rounds of ``agg.scatter_add_rows`` on the given sort (in the caller's
    spans: the counts' read-back opens ``vnlb.sync.scatter_counts``)."""
    _check(acc, patches, wts, srt, perm)
    b, ka = wts.shape
    ptd = acc.shape[1] - 1
    vm = wts[:, :, None]
    upd = torch.cat([patches[:, :ka].reshape(b, ka, ptd) * vm, vm], dim=-1)
    if bf16:
        upd = upd.to(torch.bfloat16).to(acc.dtype)
    add_by_rank(acc, srt, perm, upd.reshape(-1, ptd + 1), *rank_order(srt))


def patch_layout(patches: torch.Tensor):
    """(dims, strides) of one patch of (B, K, ...) ``patches`` as the kernel
    reads it in place: four dims (leading 1s for fewer) and their strides
    in floats (0 for a dim of 1); lane l = ((l0 * d1 + l1) * d2 + l2) * d3
    + l3 lies at sum(l_i * t_i) from the patch's start."""
    if not 3 <= patches.dim() <= 6:
        raise ValueError(f"patches must have 3 to 6 dims, got "
                         f"{tuple(patches.shape)}")
    lead = 6 - patches.dim()
    dims = (1,) * lead + tuple(patches.shape[2:])
    strides = (0,) * lead + tuple(t if n > 1 else 0 for n, t in
                                  zip(patches.shape[2:], patches.stride()[2:]))
    if sum((n - 1) * t for n, t in zip(dims, strides)) >= 2 ** 31:
        raise ValueError("a patch spans 2^31 floats or more")
    return dims, strides


def scatter_rows_kernel(acc: torch.Tensor, patches: torch.Tensor,
                        wts: torch.Tensor, srt: torch.Tensor,
                        perm: torch.Tensor, bf16: bool = False) -> None:
    """Launch the CUDA kernel; all tensors on one CUDA device, ``acc``
    contiguous.  The patches are read in place at their strides (the
    filter's output is a c-major view), up to four patch dims."""
    _check(acc, patches, wts, srt, perm)
    tensors = (acc, patches, wts, srt, perm)
    if not all(t.is_cuda and t.device == acc.device for t in tensors):
        raise ValueError("scatter_rows_kernel needs CUDA tensors on one "
                         "device")
    if not acc.is_contiguous():
        raise ValueError("acc must be contiguous (updated in place)")
    if acc.shape[1] - 1 > MAX_LANES:
        raise ValueError(f"{acc.shape[1] - 1} patch lanes, the kernel's "
                         f"offset table holds {MAX_LANES}")
    b, ka = wts.shape
    if b * ka == 0:
        return
    dims, strides = patch_layout(patches)
    wts = wts.contiguous()
    srt, perm = srt.contiguous(), perm.contiguous()
    lib = _build.library()
    err = lib.vnlb_scatter_rows(
        acc.data_ptr(), acc.shape[1], patches.data_ptr(), patches.stride(0),
        patches.stride(1), *dims, *strides, wts.data_ptr(), ka,
        srt.data_ptr(), perm.data_ptr(), b * ka, int(bf16),
        torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check(err, "scatter_rows kernel")
    scatter_rows.launches += 1


def scatter_rows(acc: torch.Tensor, patches: torch.Tensor, wts: torch.Tensor,
                 srt: torch.Tensor, perm: torch.Tensor,
                 bf16: bool = False) -> None:
    """Add the weighted patch rows into ``acc`` in place: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    dev = acc.device
    if dev.type == "cpu":
        return scatter_rows_plain(acc, patches, wts, srt, perm, bf16)
    if dev.type == "cuda":
        return scatter_rows_kernel(acc, patches, wts, srt, perm, bf16)
    raise ValueError(f"unsupported device {dev}")


scatter_rows.launches = 0
