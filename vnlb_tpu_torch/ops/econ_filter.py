"""K2: the econ spectral filter as a CUDA kernel (csrc/econ_filter.cu).

``econ_filter`` dispatches by device: a CPU tensor takes the plain version
(``econ_filter_plain`` = ops/polyspec.poly_filter_econ); a CUDA tensor
launches the kernel, and a build or launch failure raises.  Nothing falls
back.  ``econ_filter.launches`` counts kernel launches.

The kernel has four designs (``design``), each a CUDA kernel of its own:
"tc", tensor cores for the chain at a padded width of 64 with the f32
state in registers, for groups with q = min(K, p) <= 64 under
``poly_bf16`` whose buffers leave two blocks per SM (``tc_smem_bytes``:
the main path's (100, 49) and (60, 98)); "tcw", the matrix route (K >=
p) with A, T_2, T_3 in f32 shared memory, under ``poly_bf16`` for 64 < q
<= 128 at width 128 (preset ``default``'s (100, 98)) and without it for
q <= 128 at width 64 or 128 (``tcw_width``, ``tcw_smem_bytes``); "tcg",
the Gram route (K < p) for K <= 128 with its patch blocks streamed
through shared memory in chunks of 32 columns, so p is not bounded
(``tcg_smem_bytes``: the ``couple_channels`` groups (100, 147), (60, 294),
(100, 294), and without ``poly_bf16`` (60, 98)); "smem", the
shared-memory design on CUDA cores, for every other shape (Gram groups
with K > 128, groups beyond the others' shared memory).  Without
``poly_bf16`` the tensor-core designs run every product with f32
operands as three TF32 products of split operands (csrc/econ_tc.cuh
``OpTf32``).  ``econ_filter.by_design`` counts the launches of each.  The
kernel has no left regime (K < p without ``poly_gram``, ``left_regime``),
which JAX's Pallas filter never takes either: ``econ_filter`` sends those
groups to the torch chain on every device, and ``econ_filter_kernel``
raises if it is given them.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .polyspec import econ_params
from .polyspec import poly_filter_econ as econ_filter_plain

__all__ = ["econ_filter", "econ_filter_plain", "econ_filter_kernel"]

# table sizes of csrc/econ_filter.cu: the fused-series degree they allow
# (m*s coefficients, 2*m*s nodes) is far above the presets' (<= 32)
MAX_NODES = 128
MAX_COEF = 64

# the tensor-core design's layout (csrc/econ_tc.cuh): q padded to TC_Q;
# f32 k-major patch copies at a row stride of TC_LDK floats; TC_BUFS bf16
# operand buffers of TC_Q rows at a stride of TC_LDB; at most TC_SMEM_MAX
# bytes of dynamic shared memory per block
TC_Q, TC_LDK, TC_LDB, TC_BUFS, TC_SMEM_MAX = 64, 68, 72, 4, 104 * 1024
# the wide and streamed Gram designs' (csrc/econ_filter.cu ``tcw_smem``,
# ``tcg_layout``) at a padded width w of 64 or TCW_Q: f32 rows of w + 4
# floats, bf16 operand rows of w + 8 (f32 operand rows of round_up(q, 8) +
# 4 in split TF32); A, T_2, T_3 as f32 q x q matrices at a row stride of
# ``_tcw_ldt(q)``; at most SMEM_MAX[w] bytes of dynamic shared memory
TCW_Q, TCW_SMEM_MAX = 128, 220 * 1024
# blocks each bf16 design keeps on one SM (the card's plan must say the
# same); "tcw" and "tcg" keep WIDTH_BLOCKS[width] at their width
BLOCKS_PER_SM = {"tc": 2, "tcw": 1}
WIDTH_BLOCKS = {64: 2, 128: 1}
SMEM_MAX = {64: TC_SMEM_MAX, 128: TCW_SMEM_MAX}
# the streamed Gram route's chunk of patch-block columns (csrc/econ_tc.cuh
# ``kChunk``)
CHUNK = 32


def left_regime(k: int, p: int, cfg) -> bool:
    """Groups of K < p without ``poly_gram``: the p x p chain, which no
    design of the kernel runs."""
    return k < p and not cfg.poly_gram


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tcw_ldt(q: int) -> int:
    return _round_up(max(q - 8, 0), 32) + 8


def tc_smem_bytes(k: int, p: int) -> int:
    """Dynamic shared memory of a tensor-core block for (k, p) groups, or
    0 when that design does not take them (csrc/econ_filter.cu
    ``tc_smem``)."""
    q = min(k, p)
    if not 1 <= q <= TC_Q:
        return 0
    n = TC_BUFS * TC_Q * TC_LDB * 2
    if k < p:
        if _round_up(p, 8) > 2 * TC_Q:
            return 0
        n += 2 * p * TC_LDK * 4
    else:
        n += k * TC_LDK * 4 + _round_up(k, 16) * TC_LDB * 2
    return n if n <= TC_SMEM_MAX else 0


def _op_bytes(w: int, rnd: bool, q: int) -> int:
    """One operand buffer of a q x q chain at width w: bf16 w x (w + 8),
    or f32 round_up(q, 8) rows of round_up(q, 8) + 4 (split TF32)."""
    r8 = _round_up(q, 8)
    return 2 * w * (w + 8) if rnd else 4 * r8 * (r8 + 4)


def _block_bytes(w: int, rnd: bool, k: int, q: int) -> int:
    """An A-side (k, q) patch block, rows padded to 16."""
    row = 2 * (w + 8) if rnd else 4 * (_round_up(q, 8) + 4)
    return _round_up(k, 16) * row


def tcw_width(k: int, p: int, rnd: bool = True) -> int:
    """The wide design's padded width for (k, p) groups (0: not its
    shape): the matrix route, 64 < p <= 128 under poly_bf16, p <= 128
    (width 64 for p <= 64) without it."""
    if k < p or p < 1:
        return 0
    if not rnd:
        return 64 if p <= TC_Q else TCW_Q if p <= TCW_Q else 0
    return TCW_Q if TC_Q < p <= TCW_Q else 0


def tcw_smem_bytes(k: int, p: int, rnd: bool = True) -> int:
    """Dynamic shared memory of a wide tensor-core block for (k, p) groups,
    or 0 when that design does not take them (csrc/econ_filter.cu
    ``tcw_smem``); the largest of its phases: xc and the covariance's
    scratch, the chain (A, T_2, T_3 and two operand buffers), the
    application (xn after one buffer)."""
    w = tcw_width(k, p, rnd)
    if not w:
        return 0
    tsz, buf = p * _tcw_ldt(p) * 4, _op_bytes(w, rnd, p)
    n = max(k * (w + 4) * 4 + 2 * w * (w + 8) * 4, 3 * tsz + 2 * buf,
            3 * tsz + buf + _block_bytes(w, rnd, k, p))
    return n if n <= SMEM_MAX[w] else 0


def tcg_layout(k: int, p: int, rnd: bool = True) -> tuple[int, int, int]:
    """(width, dynamic shared memory, offset of the operand buffers) of the
    streamed Gram route for (k, p) groups, zeros when it does not take
    them (csrc/econ_filter.cu ``tcg_layout``): k < p, k <= 128; the
    larger of two stages of xc and xn chunks, the slices' merge scratch
    and A, T_2, T_3, then two operand buffers."""
    if k >= p or not 1 <= k <= TCW_Q:
        return 0, 0, 0
    w = 64 if k <= TC_Q else TCW_Q
    stages = 2 * 2 * CHUNK * (w + 4) * 4
    merge = 4 * (2 if w == 64 else 1) * w * (w + 8)
    r0 = max(stages, merge, 3 * k * _tcw_ldt(k) * 4)
    n = r0 + 2 * _op_bytes(w, rnd, k)
    return (w, n, r0) if n <= SMEM_MAX[w] else (0, 0, 0)


def tcg_smem_bytes(k: int, p: int, rnd: bool = True) -> int:
    """Dynamic shared memory of a streamed Gram block, or 0."""
    return tcg_layout(k, p, rnd)[1]


def design(k: int, p: int, rnd: bool) -> str:
    """Which design of the kernel takes (k, p) groups: "tc", "tcw", "tcg"
    or "smem"."""
    if rnd and tc_smem_bytes(k, p):
        return "tc"
    if tcw_smem_bytes(k, p, rnd):
        return "tcw"
    if tcg_smem_bytes(k, p, rnd):
        return "tcg"
    return "smem"


def width(kind: str, k: int, p: int, rnd: bool = True) -> int:
    """The padded width of a tensor-core design on (k, p) groups."""
    if kind == "tc":
        return TC_Q
    return tcw_width(k, p, rnd) if kind == "tcw" else tcg_layout(k, p,
                                                                 rnd)[0]


def blocks_per_sm(kind: str, k: int, p: int, rnd: bool = True) -> int:
    """The blocks a tensor-core design states it keeps on one SM."""
    return BLOCKS_PER_SM["tc"] if kind == "tc" else \
        WIDTH_BLOCKS[width(kind, k, p, rnd)]


def smem_bytes(kind: str, k: int, p: int, rnd: bool = True) -> int:
    """The Python mirror of a tensor-core design's shared memory."""
    if kind == "tc":
        return tc_smem_bytes(k, p) if rnd else 0
    return {"tcw": tcw_smem_bytes, "tcg": tcg_smem_bytes}[kind](k, p, rnd)


def tc_plan(k: int, p: int, kind: str = "tc",
            rnd: bool = True) -> tuple[int, int]:
    """(dynamic shared memory, blocks per SM) of a tensor-core design
    ("tc", "tcw" or "tcg"; bf16 operands, or split TF32 without ``rnd``)
    on the card, from the kernel library; (0, 0) for a shape it does not
    take."""
    lib = _build.library()
    smem, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    refs = (ctypes.byref(smem), ctypes.byref(per_sm))
    if kind == "tc":
        err = lib.vnlb_econ_filter_tc_plan(k, p, *refs) if rnd else 0
    else:
        fn = {"tcw": lib.vnlb_econ_filter_tcw_plan,
              "tcg": lib.vnlb_econ_filter_tcg_plan}[kind]
        err = fn(k, p, int(rnd), *refs)
    _build.check(err, f"econ_filter {kind} plan")
    return smem.value, per_sm.value


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


def econ_filter_kernel(xc2: torch.Tensor, xn2: torch.Tensor, cfg,
                       smem_design: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on (G, K, p) f32 CUDA tensors;
    ``smem_design`` takes the shared-memory design whatever ``design``
    says (to time both designs on the same inputs)."""
    if xc2.dim() == 3 and left_regime(xc2.shape[1], xc2.shape[2], cfg):
        raise ValueError("the econ filter kernel has no left regime (K < p "
                         "without poly_gram); econ_filter runs it as torch "
                         "ops")
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
    stream = torch.cuda.current_stream(xc2.device).cuda_stream
    args = (ep["m"], ep["s"], ep["nodes"], xs.data_ptr(), proj.data_ptr(),
            None if v0 is None else v0.data_ptr(), float(ep["tau"]),
            float(1.5 * ep["tau"]), float(ep["sb2"]), float(ep["s2"]),
            float(ep["cwg"]))
    kind = "smem" if smem_design else design(k, p, ep["rnd"])
    rnd = int(ep["rnd"])
    if kind == "tc":
        err = lib.vnlb_econ_filter_tc(xc2.data_ptr(), xn2.data_ptr(),
                                      out.data_ptr(), g, k, p, *args, stream)
    elif kind == "tcw":
        # the matrix route: no v0 (args[5])
        err = lib.vnlb_econ_filter_tcw(xc2.data_ptr(), xn2.data_ptr(),
                                       out.data_ptr(), g, k, p,
                                       *args[:5], *args[6:], rnd, stream)
    elif kind == "tcg":
        err = lib.vnlb_econ_filter_tcg(xc2.data_ptr(), xn2.data_ptr(),
                                       out.data_ptr(), g, k, p, *args, rnd,
                                       stream)
    else:
        # groups beyond shared memory keep their spilled matrices in a
        # per-block workspace (csrc/group_mm.cuh)
        ws_n = int(lib.vnlb_econ_filter_ws(g, k, p))
        _build.check(max(-ws_n, 0), "econ_filter workspace plan")
        ws = (torch.empty((ws_n,), dtype=torch.float32, device=xc2.device)
              if ws_n else None)
        err = lib.vnlb_econ_filter(
            xc2.data_ptr(), xn2.data_ptr(), out.data_ptr(), g, k, p, *args,
            int(ep["rnd"]), None if ws is None else ws.data_ptr(), stream)
    _build.check(err, f"econ_filter kernel ({kind})")
    econ_filter.launches += 1
    econ_filter.by_design[kind] += 1
    return out


def econ_filter(xc2: torch.Tensor, xn2: torch.Tensor, cfg) -> torch.Tensor:
    """Econ spectral filter of (G, K, p) centred patch groups: the plain
    version for CPU tensors and for the left regime, the CUDA kernel for
    other CUDA tensors."""
    if xc2.device.type == "cpu" or left_regime(xc2.shape[1], xc2.shape[2],
                                                cfg):
        return econ_filter_plain(xc2, xn2, cfg)
    if xc2.device.type == "cuda":
        return econ_filter_kernel(xc2, xn2, cfg)
    raise ValueError(f"unsupported device {xc2.device}")


econ_filter.launches = 0
econ_filter.by_design = {"tc": 0, "tcw": 0, "tcg": 0, "smem": 0}
