"""K5: the two-factor polynomial spectral filter as a CUDA kernel
(csrc/poly_filter.cu).

``poly_filter`` dispatches by device: a CPU tensor takes the plain version
(``poly_filter_plain`` = ops/polyspec.poly_filter); a CUDA tensor launches
the kernel, and a build or launch failure raises.  Nothing falls back.
``poly_filter.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .polyspec import _AGGR, poly_params
from .polyspec import poly_filter as poly_filter_plain

__all__ = ["poly_filter", "poly_filter_plain", "poly_filter_kernel"]

# table sizes of csrc/poly_filter.cu: Wiener degree <= 63 (the presets run 8)
MAX_NODES = 128
MAX_COEF = 64


def poly_filter_kernel(xc2: torch.Tensor, xn2: torch.Tensor, cfg
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on (G, K, p) f32 CUDA tensors."""
    if not (xc2.is_cuda and xn2.is_cuda):
        raise ValueError("poly_filter_kernel needs CUDA tensors")
    if xc2.dtype != torch.float32 or xn2.dtype != torch.float32:
        raise TypeError("poly_filter_kernel takes float32 patches")
    if xc2.shape != xn2.shape or xc2.dim() != 3:
        raise ValueError(f"shapes {tuple(xc2.shape)} / {tuple(xn2.shape)}")
    g, k, p = xc2.shape
    pp = poly_params(cfg)
    if pp["nodes"] > MAX_NODES or pp["wdeg"] + 1 > MAX_COEF:
        raise NotImplementedError(
            f"the poly filter kernel holds at most {MAX_NODES} nodes and "
            f"{MAX_COEF} coefficients; poly_deg {pp['wdeg']} needs "
            f"{pp['nodes']} and {pp['wdeg'] + 1}")
    xc2, xn2 = xc2.contiguous(), xn2.contiguous()
    out = torch.empty_like(xn2)
    if g == 0:
        return out
    dev = xc2.device
    xs = torch.as_tensor(pp["xs"], device=dev).contiguous()
    dct = torch.as_tensor(pp["dct"], device=dev).contiguous()
    lib = _build.library()
    ws_n = int(lib.vnlb_poly_filter_ws(g, k, p))
    _build.check(max(-ws_n, 0), "poly_filter workspace plan")
    ws = (torch.empty((ws_n,), dtype=torch.float32, device=dev)
          if ws_n else None)
    err = lib.vnlb_poly_filter(
        xc2.data_ptr(), xn2.data_ptr(), out.data_ptr(), g, k, p,
        pp["n_aggr"], pp["n_polish"], pp["wdeg"], pp["nodes"],
        xs.data_ptr(), dct.data_ptr(), float(pp["tau"]), float(pp["sb2"]),
        float(pp["s2"]), *(float(a) for a in _AGGR), int(pp["rnd"]),
        None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "poly_filter kernel")
    poly_filter.launches += 1
    return out


def poly_filter(xc2: torch.Tensor, xn2: torch.Tensor, cfg) -> torch.Tensor:
    """Two-factor spectral filter of (G, K, p) centred patch groups: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if xc2.device.type == "cpu":
        return poly_filter_plain(xc2, xn2, cfg)
    if xc2.device.type == "cuda":
        return poly_filter_kernel(xc2, xn2, cfg)
    raise ValueError(f"unsupported device {xc2.device}")


poly_filter.launches = 0
