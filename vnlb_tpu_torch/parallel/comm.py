"""The collectives of the parallel passes, in one place.

A ``Mesh`` is one rank's view of a 1-D process group: the group, this
rank, the group size, the rank's device and the axis name.  It takes the
place of a ``jax.sharding.Mesh`` axis inside ``shard_map``:

* ``exchange_halos`` / ``fold_margins``: point-to-point rows to the ranks
  above and below (``lax.ppermute``), by ``dist.batch_isend_irecv``;
* ``all_gather``: along one dimension (``lax.all_gather(tiled=True)``);
* ``all_reduce_sum``: ``lax.psum``.

The transport follows the group's backend: NCCL moves CUDA tensors
directly; gloo sends no CUDA tensor point to point, so under gloo the
helpers stage through host memory.  The compute stays on the rank's
device either way.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """One rank's view of a 1-D process group."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "h"


def make_mesh(axis: str = "h", group=None, device=None) -> Mesh:
    """This rank's ``Mesh`` over ``group`` (the default group when None) of
    an initialized ``torch.distributed`` world.  ``device`` defaults to
    ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank); pass "cpu" to
    run on the host."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "world (parallel.launch.run_world starts one)")
    rank = dist.get_rank(group)
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return Mesh(group, rank, dist.get_world_size(group),
                torch.device(device), axis)


def _wire(mesh: Mesh) -> torch.device:
    """Where the bytes travel: the rank's device under NCCL, the host
    otherwise."""
    if dist.get_backend(mesh.group) == "nccl":
        return mesh.device
    return torch.device("cpu")


def _peer(mesh: Mesh, rank: int) -> int:
    return rank if mesh.group is None else dist.get_global_rank(mesh.group,
                                                                rank)


def _p2p(mesh: Mesh, sends, recvs):
    """Post every send [(tensor, peer rank)] and receive [(template,
    peer rank)] together and wait; the received tensors on mesh.device."""
    wire = _wire(mesh)
    ops = [dist.P2POp(dist.isend, t.to(wire).contiguous(), _peer(mesh, p),
                      mesh.group) for t, p in sends]
    bufs = [torch.empty(t.shape, dtype=t.dtype, device=wire)
            for t, _ in recvs]
    ops += [dist.P2POp(dist.irecv, b, _peer(mesh, p), mesh.group)
            for b, (_, p) in zip(bufs, recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(mesh.device) for b in bufs]


def _neighbours(x: torch.Tensor, mesh: Mesh, to_above: torch.Tensor,
                to_below: torch.Tensor):
    """Send ``to_above`` to rank-1 and ``to_below`` to rank+1; return what
    rank-1 and rank+1 sent (None at the ends of the group)."""
    r, n = mesh.rank, mesh.size
    up, down = r > 0, r + 1 < n
    sends = ([(to_above, r - 1)] if up else []) \
        + ([(to_below, r + 1)] if down else [])
    recvs = ([(to_below, r - 1)] if up else []) \
        + ([(to_above, r + 1)] if down else [])
    got = iter(_p2p(mesh, sends, recvs))
    return (next(got) if up else None), (next(got) if down else None)


def exchange_halos(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """(..., Hs, W) strip -> (..., Hs + 2*halo, W) tile: the ``halo`` rows
    of the neighbours above and below, zeros past the ends of the frame."""
    above, below = _neighbours(x, mesh, x[..., :halo, :], x[..., -halo:, :])
    zeros = x.new_zeros(x.shape[:-2] + (halo, x.shape[-1]))
    return torch.cat([zeros if above is None else above, x,
                      zeros if below is None else below], dim=-2)


def fold_tile(img: torch.Tensor, halo: int,
              from_above: Optional[torch.Tensor],
              from_below: Optional[torch.Tensor]) -> torch.Tensor:
    """(..., Hs + 2*halo, W) tile accumulators -> (..., Hs, W): the core
    rows plus the neighbours' margins that fall on them, the one below
    added first (``_fold_margins``'s order)."""
    core = img[..., halo:-halo, :].clone()
    if from_below is not None:
        core[..., -halo:, :] += from_below
    if from_above is not None:
        core[..., :halo, :] += from_above
    return core


def fold_margins(img: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """Overlap-add: each tile's top margin goes to the rank above, its
    bottom margin to the rank below."""
    above, below = _neighbours(img, mesh, img[..., :halo, :],
                               img[..., -halo:, :])
    return fold_tile(img, halo, above, below)


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on mesh.device."""
    wire = _wire(mesh)
    src = x.to(wire).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=dim).to(mesh.device)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``x``, on mesh.device."""
    buf = x.to(_wire(mesh)).contiguous()
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(mesh.device)
