"""K5: the two-factor polynomial spectral filter as a CUDA kernel
(csrc/poly_filter.cu).

``poly_filter`` dispatches by device: a CPU tensor takes the plain version
(``poly_filter_plain`` = ops/polyspec.poly_filter); a CUDA tensor launches
the kernel, and a build or launch failure raises.  Nothing falls back.
``poly_filter.launches`` counts kernel launches.

The kernel has two designs (``design``), each a CUDA kernel of its own:
"tc", bf16 tensor cores for every p x p product of the gate, the Chebyshev
series and the applications, p padded to 64 (two blocks per SM) or to 128
(one block per SM) by ``tc_width``, for every shape under ``poly_bf16``
whose buffers fit (``tc_smem_bytes``; the left route, K < p, needs K <=
64); "smem", the shared-memory design on CUDA cores, for ``poly_bf16``
off and the joint groups of ``couple_channels`` (p = 147, 294).
``poly_filter.by_design`` counts the launches of each.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .polyspec import _AGGR, poly_params
from .polyspec import poly_filter as poly_filter_plain

__all__ = ["poly_filter", "poly_filter_plain", "poly_filter_kernel"]

# table sizes of csrc/poly_filter.cu: Wiener degree <= 63 (the presets run 8)
MAX_NODES = 128
MAX_COEF = 64

# the tensor-core design's layout (csrc/poly_filter.cu ``tc_layout``): at
# width w, bf16 operand buffers of w rows at a stride of w + 8, f32
# k-major rows of w + 4 floats (xn^T: 64 + 4), at most TC_SMEM_MAX[w] bytes
# of dynamic shared memory, BLOCKS_PER_SM[w] blocks on one SM
TC_SMEM_MAX = {64: 104 * 1024, 128: 220 * 1024}
BLOCKS_PER_SM = {64: 2, 128: 1}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tc_width(p: int) -> int:
    """The padded width of the tensor-core design for p (0: p > 128)."""
    return 64 if p <= 64 else 128 if p <= 128 else 0


def tc_smem_bytes(k: int, p: int) -> int:
    """Dynamic shared memory of a tensor-core block for (k, p) groups, or
    0 when that design does not take them (csrc/poly_filter.cu
    ``tc_layout``): the largest of its phases.  The covariance (xc and the
    syrk scratch); the gate (five operand buffers); left route (k < p):
    one buffer, xn^T, W in f32 and the xn W scratch; right route: four
    buffers and Q (f32), then one buffer and the three bf16 parts of xn."""
    w = tc_width(p)
    if not w or k < 1 or p < 1 or (k < p and k > 64):
        return 0
    ldb, ldk = w + 8, w + 4
    buf = w * ldb * 2
    n = max(k * ldk * 4 + 2 * w * (w + 8) * 4, 5 * buf)
    if k < p:
        n = max(n, buf + p * 68 * 4 + p * ldk * 4 + 2 * 64 * (w + 8) * 4)
    else:
        n = max(n, 4 * buf + w * w * 4,
                buf + 3 * _round_up(k, 16) * ldb * 2)
    return n if n <= TC_SMEM_MAX[w] else 0


def design(k: int, p: int, rnd: bool) -> str:
    """Which design of the kernel takes (k, p) groups: "tc" or "smem"."""
    return "tc" if rnd and tc_smem_bytes(k, p) else "smem"


def tc_plan(k: int, p: int) -> tuple[int, int]:
    """(dynamic shared memory, blocks per SM) of the tensor-core design on
    the card, from the kernel library; (0, 0) for a shape it does not
    take."""
    smem, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().vnlb_poly_filter_tc_plan(
        k, p, ctypes.byref(smem), ctypes.byref(per_sm)),
        "poly_filter tc plan")
    return smem.value, per_sm.value


def poly_filter_kernel(xc2: torch.Tensor, xn2: torch.Tensor, cfg,
                       smem_design: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on (G, K, p) f32 CUDA tensors;
    ``smem_design`` takes the shared-memory design whatever ``design``
    says (to time both designs on the same inputs)."""
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (pp["n_aggr"], pp["n_polish"], pp["wdeg"], pp["nodes"],
            xs.data_ptr(), dct.data_ptr(), float(pp["tau"]),
            float(pp["sb2"]), float(pp["s2"]), *(float(a) for a in _AGGR))
    kind = "smem" if smem_design else design(k, p, pp["rnd"])
    if kind == "tc":
        err = lib.vnlb_poly_filter_tc(xc2.data_ptr(), xn2.data_ptr(),
                                      out.data_ptr(), g, k, p, *args, stream)
    else:
        ws_n = int(lib.vnlb_poly_filter_ws(g, k, p))
        _build.check(max(-ws_n, 0), "poly_filter workspace plan")
        ws = (torch.empty((ws_n,), dtype=torch.float32, device=dev)
              if ws_n else None)
        err = lib.vnlb_poly_filter(
            xc2.data_ptr(), xn2.data_ptr(), out.data_ptr(), g, k, p, *args,
            int(pp["rnd"]), None if ws is None else ws.data_ptr(), stream)
    _build.check(err, f"poly_filter kernel ({kind})")
    poly_filter.launches += 1
    poly_filter.by_design[kind] += 1
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
poly_filter.by_design = {"tc": 0, "smem": 0}
