"""Site parallelism (vnlb_tpu/parallel/tiled.py): every rank holds the
whole video, searches, filters and scatters its share of the lattice
sites, and one sum over the ranks (``psum`` in JAX) joins the folded
accumulators before the normalization.

Each rank takes a contiguous block of the dense sites and one of the
gather sites, in the planned order.  The fold is linear, so the result
equals the single-device pass up to the order of the sums: gloo's
all-reduce adds in its own order, and a repeat with the same world size
gives the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import StageConfig, VnlbConfig, default_config
from ..pipeline import (KERNELS, Kernels, accumulate, as_video, finish,
                        plan_sites, prep_flows, prepare)
from .comm import Mesh, all_reduce_sum, make_mesh


def _share(sites: np.ndarray, n_dense: int, mesh: Mesh):
    """This rank's (sites, n_dense): block ``rank`` of the dense sites and
    of the gather sites."""
    dense = np.array_split(sites[:n_dense], mesh.size)[mesh.rank]
    gather = np.array_split(sites[n_dense:], mesh.size)[mesh.rank]
    return np.concatenate([dense, gather]), dense.shape[0]


def proc_nl_sharded(noisy, basic, clean, fflow, bflow, cfg: StageConfig,
                    mesh: Mesh, zero_flow: Optional[bool] = None,
                    t_origin: int = 0,
                    kernels: Kernels = KERNELS) -> torch.Tensor:
    """One pass with the sites shared over ``mesh``; every rank passes the
    whole clip and gets the whole RGB output on its device."""
    dev = mesh.device
    noisy_yuv, basic_yuv, srch, fflow, bflow, zero_flow = prepare(
        as_video(noisy, dev),
        None if basic is None else as_video(basic, dev),
        None if clean is None else as_video(clean, dev),
        fflow, bflow, cfg, zero_flow)
    sites, n_dense = plan_sites(tuple(noisy_yuv.shape), cfg, zero_flow,
                                t_origin)
    sites, n_dense = _share(sites, n_dense, mesh)
    deno_img, wts_img = accumulate(
        noisy_yuv, basic_yuv, srch, fflow, bflow,
        torch.as_tensor(sites, device=dev), n_dense, cfg, kernels)
    deno_img = all_reduce_sum(deno_img, mesh)
    wts_img = all_reduce_sum(wts_img, mesh)
    return finish(deno_img, wts_img, noisy_yuv, basic_yuv, cfg)


def denoise_sharded(noisy, sigma: float, mesh: Optional[Mesh] = None,
                    flows=None, preset: str = "iphone",
                    cfg: Optional[VnlbConfig] = None,
                    kernels: Kernels = KERNELS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass VNLB with the sites shared over the mesh: (deno, basic) on
    the rank's device."""
    mesh = mesh or make_mesh(axis="sites")
    cfg = cfg or default_config(sigma, preset=preset)
    fflow, bflow, zf = prep_flows(tuple(np.shape(noisy)), flows)
    basic = proc_nl_sharded(noisy, None, None, fflow, bflow, cfg.stage(0),
                            mesh, zero_flow=zf, kernels=kernels)
    deno = proc_nl_sharded(noisy, basic, None, fflow, bflow, cfg.stage(1),
                           mesh, zero_flow=zf, kernels=kernels)
    return deno, basic
