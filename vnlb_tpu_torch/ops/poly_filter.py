"""K5: the two-factor polynomial spectral filter as a CUDA kernel
(csrc/poly_filter.cu, csrc/poly_tcb.cu).

``poly_filter`` dispatches by device: a CPU tensor takes the plain version
(``poly_filter_plain`` = ops/polyspec.poly_filter); a CUDA tensor launches
the kernel, and a build or launch failure raises.  Nothing falls back.
``poly_filter.launches`` counts kernel launches.

The kernel has three designs (``design``), each CUDA code of its own:
"tc", one block per group on tensor cores, p padded to 64 (two blocks per
SM) or 128 (one block per SM) by ``tc_width``, for every shape whose
buffers fit one SM (``tc_smem_bytes``; the left route, K < p, needs K <=
64): the presets' groups, the right route's (100, 49) and (100, 98) and
the left route's (60, 98), bf16 operands under ``poly_bf16`` and split
TF32 without it (csrc/econ_tc.cuh ``OpTf32``).  "tcb", the batched design, for
every left-route shape "tc" refuses (``tcb_takes``): the joint groups of
``couple_channels`` ((100, 147), (60, 294), (100, 294), (60, 147)), whose
gate chain at p = 294 needs five or more 294 x 294 matrices (1.3 MB),
beyond one SM, left routes with K > 64 and the f32 (16, 128); each p x p
product of a sub-batch of groups is one launch over its 64 x 64 output
tiles (in split TF32 a gate product, symmetric, over those on and above
the diagonal) on tensor cores, through a device workspace the wrapper
allocates (``tcb_plan``: at most ``TCB_WS_BYTES``).  "smem", the
shared-memory design on CUDA cores, for the right routes "tc" refuses
(p = 128 in split TF32: ps = 8, pt = 2 with npatches >= 128; xc of more
rows than a block holds: npatches = 300 at p = 49; no preset reaches
them) and as the comparison the card's checks time beside the others
(``smem_design``).  ``poly_filter.by_design`` counts the launches of
each.
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
# width w, bf16 operand buffers of w rows at a stride of w + 8 (split
# TF32: f32 buffers of round_up(p, 8) rows at a stride of round_up(p, 8) +
# 4), f32 k-major rows of w + 4 floats (xn^T: 64 + 4), at most
# TC_SMEM_MAX[w] bytes of dynamic shared memory, BLOCKS_PER_SM[w] blocks on
# one SM
TC_SMEM_MAX = {64: 104 * 1024, 128: 220 * 1024}
BLOCKS_PER_SM = {64: 2, 128: 1}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tc_width(p: int) -> int:
    """The padded width of the tensor-core design for p (0: p > 128)."""
    return 64 if p <= 64 else 128 if p <= 128 else 0


def tc_smem_bytes(k: int, p: int, rnd: bool = True) -> int:
    """Dynamic shared memory of a tensor-core block for (k, p) groups, or
    0 when that design does not take them (csrc/poly_filter.cu
    ``tc_layout``; bf16 operands under ``rnd``, else split TF32): the
    largest of its phases.  The covariance (xc and the syrk scratch); the
    gate (five operand buffers); left route (k < p): one buffer, xn^T, W
    in f32 and the xn W scratch, then z_j in two buffers of 64 rows; right
    route: under ``rnd`` four buffers and Q (w x w f32), in split TF32 Q
    in the fifth buffer (the gate's five), then one buffer and xn (three
    bf16 parts, or f32)."""
    w = tc_width(p)
    if not w or k < 1 or p < 1 or (k < p and k > 64):
        return 0
    ldb, ldk, r8 = w + 8, w + 4, _round_up(p, 8)
    row = 2 * ldb if rnd else 4 * (r8 + 4)
    buf = w * ldb * 2 if rnd else 4 * r8 * (r8 + 4)
    n = max(k * ldk * 4 + 2 * w * (w + 8) * 4, 5 * buf)
    if k < p:
        n = max(n, buf + p * 68 * 4 + p * ldk * 4 + 2 * 64 * (w + 8) * 4,
                buf + 2 * 64 * row)
    else:
        n = max(n, buf + (3 if rnd else 1) * _round_up(k, 16) * row)
        if rnd:
            n = max(n, 4 * buf + w * w * 4)
    return n if n <= TC_SMEM_MAX[w] else 0


# the batched design (csrc/poly_tcb.cu ``tcb_plan``): output tiles of
# TCB_TILE x TCB_TILE, p at most 512, the prologue's xc and strip of C in at
# most TCB_PRO_SMEM_MAX bytes; each buffer of a group's workspace 256-byte
# aligned; a launch's workspace at most TCB_WS_BYTES (one sub-batch,
# csrc/poly_tcb.cu ``kWsBytes``)
TCB_TILE = 64
TCB_MAX_P = 512
TCB_PRO_SMEM_MAX = 200 * 1024
TCB_WS_BYTES = 512 << 20


def tcb_takes(k: int, p: int) -> bool:
    """Whether the batched design takes (k, p) groups: the left route, p
    <= 512, xc (rows of round_up(p, 4) floats) and a 16-row strip of C in
    the prologue's shared memory."""
    smem = (k * _round_up(p, 4) + 16 * _round_up(p, 16)) * 4
    return 1 <= k < p <= TCB_MAX_P and smem <= TCB_PRO_SMEM_MAX


def tcb_plan(g: int, k: int, p: int, rnd: bool = True) -> dict | None:
    """The batched design's launch plan for g groups of (k, p) (bf16
    operands under ``rnd``, else f32), or None where it does not take
    them (csrc/poly_tcb.cu ``tcb_plan``): p and k padded to 16, the 64 x
    64 output tiles of a p x p product of the gate (all under ``rnd``;
    in split TF32, symmetric, those on and above the diagonal) and of a k
    x p product of the recurrence, a group's workspace (Ah, S twice, S^2,
    st(S^3) in the operand type; S^3 in f32; the coefficients, C's row
    |sums| and diagonal; xn in three bf16 parts or f32; z_j twice and their
    running sum in f32 and, under bf16, z_j twice rounded) and the groups
    a sub-batch takes: as many as ``TCB_WS_BYTES`` holds, spread evenly."""
    if not tcb_takes(k, p):
        return None
    pp, kp, e = _round_up(p, 16), _round_up(k, 16), 2 if rnd else 4
    big, small = pp * pp, kp * pp
    sizes = ([big * e] * (5 if rnd else 4)
             + [big * 4, MAX_COEF * 4, pp * 4, pp * 4,
                (3 if rnd else 1) * small * e]
             + [small * 4] * 3 + ([small * e] * 2 if rnd else []))
    group = sum(_round_up(b, 256) for b in sizes)
    cap = max(1, TCB_WS_BYTES // group)
    n = -(-max(g, 1) // cap)
    batch = -(-max(g, 1) // n)
    tn = -(-pp // TCB_TILE)
    return dict(p_pad=pp, k_pad=kp,
                tiles=tn * tn if rnd else tn * (tn + 1) // 2,
                ztiles=tn * -(-kp // TCB_TILE), batch=batch,
                group_bytes=group, ws_bytes=group * batch)


def design(k: int, p: int, rnd: bool) -> str:
    """Which design of the kernel takes (k, p) groups: "tc", "tcb" or
    "smem"."""
    if tc_smem_bytes(k, p, rnd):
        return "tc"
    return "tcb" if tcb_takes(k, p) else "smem"


def tc_plan(k: int, p: int, rnd: bool = True) -> tuple[int, int]:
    """(dynamic shared memory, blocks per SM) of the tensor-core design
    (bf16 operands under ``rnd``, else split TF32) on the card, from the
    kernel library; (0, 0) for a shape it does not take."""
    smem, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().vnlb_poly_filter_tc_plan(
        k, p, int(rnd), ctypes.byref(smem), ctypes.byref(per_sm)),
        "poly_filter tc plan")
    return smem.value, per_sm.value


def card_tcb_plan(g: int, k: int, p: int, rnd: bool = True) -> dict | None:
    """The batched design's plan from the kernel library (``tcb_plan``'s
    keys; None for a shape it does not take)."""
    v = (ctypes.c_longlong * 7)()
    _build.check(_build.library().vnlb_poly_filter_tcb_plan(
        g, k, p, int(rnd), v),
        "poly_filter tcb plan")
    if not v[0]:
        return None
    return dict(zip(("p_pad", "k_pad", "tiles", "ztiles", "batch",
                     "group_bytes", "ws_bytes"), v))


def poly_filter_kernel(xc2: torch.Tensor, xn2: torch.Tensor, cfg,
                       smem_design: bool = False,
                       batched_design: bool = False,
                       _workspace: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on (G, K, p) f32 CUDA tensors;
    ``smem_design`` takes the shared-memory design, ``batched_design``
    the batched one (a left-route shape), whatever ``design`` says (to
    time and hold the designs against each other on the same inputs).
    ``_workspace``, a check's hook that the passes never give: the
    batched design's workspace, a uint8 CUDA tensor of at least
    ``tcb_plan(...)["ws_bytes"]`` bytes, in place of a new one (to show
    that the output does not depend on what the workspace held)."""
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
    kind = ("smem" if smem_design else "tcb" if batched_design
            else design(k, p, pp["rnd"]))
    if _workspace is not None and kind != "tcb":
        raise ValueError(f"a workspace is given to the {kind!r} design; "
                         f"only the batched design takes one")
    if kind == "tc":
        err = lib.vnlb_poly_filter_tc(xc2.data_ptr(), xn2.data_ptr(),
                                      out.data_ptr(), g, k, p, *args,
                                      int(pp["rnd"]), stream)
    elif kind == "tcb":
        plan = tcb_plan(g, k, p, pp["rnd"])
        if plan is None:
            raise ValueError(f"the batched design does not take ({k}, {p})"
                             f" groups (it takes K < p <= {TCB_MAX_P})")
        ws = _workspace
        if ws is None:
            ws = torch.empty((plan["ws_bytes"],), dtype=torch.uint8,
                             device=dev)
        elif not (ws.dtype == torch.uint8 and ws.device == dev
                  and ws.is_contiguous() and ws.numel() >= plan["ws_bytes"]):
            raise ValueError(f"a workspace of {plan['ws_bytes']} contiguous "
                             f"uint8 bytes on {dev} is needed")
        err = lib.vnlb_poly_filter_tcb(
            xc2.data_ptr(), xn2.data_ptr(), out.data_ptr(), g, k, p, *args,
            int(pp["rnd"]), ws.data_ptr(), plan["ws_bytes"], stream)
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
poly_filter.by_design = {"tc": 0, "tcb": 0, "smem": 0}
