"""K2: the econ spectral filter as a CUDA kernel (csrc/econ_filter.cu).

``econ_filter`` dispatches by device: a CPU tensor takes the plain version
(``econ_filter_plain`` = ops/polyspec.poly_filter_econ); a CUDA tensor
launches the kernel, and a build or launch failure raises.  Nothing falls
back.  ``econ_filter.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .polyspec import econ_params
from .polyspec import poly_filter_econ as econ_filter_plain

__all__ = ["econ_filter", "econ_filter_plain", "econ_filter_kernel"]

# table sizes of csrc/econ_filter.cu: the fused-series degree they allow
# (m*s coefficients, 2*m*s nodes) is far above the presets' (<= 32)
MAX_NODES = 128
MAX_COEF = 64


def _consts(cfg, k: int, p: int, device):
    ep = econ_params(cfg)
    xs = torch.as_tensor(ep["xs"], device=device)
    if k < p:
        gmap, v0 = ep["gram_maps"]
        proj = torch.as_tensor(gmap, device=device)
        v0 = torch.as_tensor(v0, device=device)
    else:
        proj = torch.as_tensor(ep["pinv"], device=device)
        v0 = None
    return ep, xs.contiguous(), proj.contiguous(), v0


def econ_filter_kernel(xc2: torch.Tensor, xn2: torch.Tensor, cfg
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on (G, K, p) f32 CUDA tensors."""
    if not (xc2.is_cuda and xn2.is_cuda):
        raise ValueError("econ_filter_kernel needs CUDA tensors")
    if xc2.dtype != torch.float32 or xn2.dtype != torch.float32:
        raise TypeError("econ_filter_kernel takes float32 patches")
    if xc2.shape != xn2.shape or xc2.dim() != 3:
        raise ValueError(f"shapes {tuple(xc2.shape)} / {tuple(xn2.shape)}")
    g, k, p = xc2.shape
    xc2, xn2 = xc2.contiguous(), xn2.contiguous()
    ep, xs, proj, v0 = _consts(cfg, k, p, xc2.device)
    if ep["nodes"] > MAX_NODES or ep["m"] * ep["s"] > MAX_COEF:
        raise NotImplementedError(
            f"the econ filter kernel holds at most {MAX_NODES} nodes and "
            f"{MAX_COEF} coefficients; degree {ep['deg']} needs "
            f"{ep['nodes']} and {ep['m'] * ep['s']}")
    out = torch.empty_like(xn2)
    if g == 0:
        return out
    lib = _build.library()
    # groups beyond shared memory keep their spilled matrices in a
    # per-block workspace (csrc/group_mm.cuh)
    ws_n = int(lib.vnlb_econ_filter_ws(g, k, p))
    _build.check(max(-ws_n, 0), "econ_filter workspace plan")
    ws = (torch.empty((ws_n,), dtype=torch.float32, device=xc2.device)
          if ws_n else None)
    err = lib.vnlb_econ_filter(
        xc2.data_ptr(), xn2.data_ptr(), out.data_ptr(), g, k, p,
        ep["m"], ep["s"], ep["nodes"], xs.data_ptr(), proj.data_ptr(),
        None if v0 is None else v0.data_ptr(),
        float(ep["tau"]), float(1.5 * ep["tau"]), float(ep["sb2"]),
        float(ep["s2"]), float(ep["cwg"]), int(ep["rnd"]),
        None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(xc2.device).cuda_stream)
    _build.check(err, "econ_filter kernel")
    econ_filter.launches += 1
    return out


def econ_filter(xc2: torch.Tensor, xn2: torch.Tensor, cfg) -> torch.Tensor:
    """Econ spectral filter of (G, K, p) centred patch groups: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if xc2.device.type == "cpu":
        return econ_filter_plain(xc2, xn2, cfg)
    if xc2.device.type == "cuda":
        return econ_filter_kernel(xc2, xn2, cfg)
    raise ValueError(f"unsupported device {xc2.device}")


econ_filter.launches = 0
