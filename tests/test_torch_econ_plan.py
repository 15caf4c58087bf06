"""The launch plan of K2 (ops/econ_filter.py) on the CPU: which design a
group shape takes and the tensor-core designs' shared memory, which
mirrors csrc/econ_filter.cu ``tc_smem``, ``tcw_smem`` and ``tcg_layout``
(held equal on the card by
tests/test_torch_cuda.py::test_econ_tc_plan_matches_wrapper)."""

import pytest

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops.econ_filter import (BLOCKS_PER_SM, TC_SMEM_MAX,
                                            TCW_SMEM_MAX, WIDTH_BLOCKS,
                                            blocks_per_sm, design,
                                            smem_bytes, tc_smem_bytes,
                                            tcg_layout, tcg_smem_bytes,
                                            tcw_smem_bytes, tcw_width, width)

BUFS = 4 * 64 * 72 * 2           # four bf16 64 x 64 operand buffers


@pytest.mark.parametrize("k,p,want", [
    (60, 98, BUFS + 2 * 98 * 68 * 4),          # Gram: xc^T, xn^T
    (37, 98, BUFS + 2 * 98 * 68 * 4),
    (16, 128, BUFS + 2 * 128 * 68 * 4),
    (100, 49, BUFS + 100 * 68 * 4 + 112 * 72 * 2),   # matrix: xc, bf16(xn)
    (64, 33, BUFS + 64 * 68 * 4 + 64 * 72 * 2),
    (150, 49, BUFS + 150 * 68 * 4 + 160 * 72 * 2),
])
def test_tc_smem_layout(k, p, want):
    assert tc_smem_bytes(k, p) == want <= TC_SMEM_MAX


@pytest.mark.parametrize("k,p", [
    (60, 294), (100, 147), (100, 294),  # Gram with q > 64 or p > 128
    (16, 129), (300, 49), (65, 70)])
def test_tc_refuses(k, p):
    """Beyond the width-64 and wide bf16 designs; the Gram groups among
    them take the streamed Gram route, (300, 49) keeps shared memory."""
    assert tc_smem_bytes(k, p) == 0
    assert tcw_smem_bytes(k, p) == 0
    assert design(k, p, True) == ("tcg" if k < p else "smem")


TCW_BUF = 128 * 136 * 2          # one bf16 128 x 128 operand buffer
TCW_PART = 2 * 128 * 136 * 4     # the covariance's two depth slices


@pytest.mark.parametrize("k,p,ldt,want", [
    # the largest phase: xc (f32, rows of 132) and the covariance's scratch
    (100, 98, 104, 100 * 132 * 4 + TCW_PART),
    (70, 65, 72, 70 * 132 * 4 + TCW_PART),
    # the chain: A, T_2, T_3 (f32, q rows of ldt) and two operand buffers
    (98, 98, 104, 3 * 98 * 104 * 4 + 2 * TCW_BUF),
    (65, 104, 0, 0),             # a Gram route: not this design
    (104, 104, 104, 3 * 104 * 104 * 4 + 2 * TCW_BUF),
])
def test_tcw_smem_layout(k, p, ldt, want):
    """The wide design (matrix route, 64 < q <= 128) at its phases' largest
    shared memory; (100, 98), the pt=2 first pass of preset default, takes
    it."""
    assert tcw_smem_bytes(k, p) == want <= TCW_SMEM_MAX
    assert tc_smem_bytes(k, p) == 0
    assert design(k, p, True) == ("tcw" if want else "tcg")
    # without poly_bf16: the wide design in split TF32, or the streamed Gram
    # route for the Gram group (65, 104)
    assert design(k, p, False) == ("tcw" if want else "tcg")
    if want:
        assert smem_bytes("tcw", k, p) == want
        assert ldt % 32 == 8 and ldt >= p


@pytest.mark.parametrize("k,p", [(100, 105), (100, 128), (170, 98),
                                 (100, 129), (64, 64)])
def test_tcw_refuses(k, p):
    """Beyond the wide design: A, T_2, T_3 of q = 105-128 or 170 rows of
    xc exceed the 220 KB a block is given; p > 128 or q <= 64 is not its
    width.  The Gram groups among them (k < p) take the streamed Gram
    route."""
    assert tcw_smem_bytes(k, p) == 0
    want = "tc" if (k, p) == (64, 64) else "tcg" if k < p else "smem"
    assert design(k, p, True) == want


def test_blocks_per_sm():
    """Each tensor-core design states the blocks it keeps on an SM (the
    card's plan must match: tests/test_torch_cuda.py)."""
    assert BLOCKS_PER_SM == {"tc": 2, "tcw": 1}


@pytest.mark.parametrize("preset", ["iphone", "sss_v2", "default", "sss"])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("bf16", [True, False])
def test_preset_shapes_take_design(preset, stage, bf16):
    """The main path's groups (iphone and sss_v2: (100, 49) and (60, 98))
    take the tensor-core design under poly_bf16; the pt=2 first pass of
    default and sss ((100, 98), q = 98) takes the wide tensor-core design
    under poly_bf16.  Without poly_bf16 every preset shape takes a
    tensor-core design in split TF32: the matrix route's (100, 49) and
    (100, 98) the wide design, the Gram route's (60, 98) the streamed Gram
    route."""
    cfg = vt.default_config(20.0, preset=preset).stage(stage)
    k, p = cfg.npatches, cfg.pdim
    if bf16:
        want = "tc" if min(k, p) <= 64 else "tcw"
    else:
        want = "tcw" if k >= p else "tcg"
    assert design(k, p, bf16) == want
    if preset in ("default", "sss") and stage == 0:
        assert (k, p) == (100, 98)
        assert design(k, p, bf16) == "tcw"
    if preset == "iphone":
        assert (k, p) == ((100, 49), (60, 98))[stage]
        assert design(k, p, bf16) == ("tc" if bf16 else want)


F32_BUF64 = lambda q: 4 * q * (q + 4)    # an f32 operand buffer, q rows


@pytest.mark.parametrize("k,p,kind,w,want", [
    # the wide design in split TF32: width 64 for (100, 49) (A, T_2, T_3 at
    # rows of 72 floats, one 56 x 60 f32 buffer, xn 112 x 60 f32), width
    # 128 for (100, 98) (104 x 108 f32 buffers)
    (100, 49, "tcw", 64, 3 * 49 * 72 * 4 + F32_BUF64(56) + 112 * 60 * 4),
    (100, 98, "tcw", 128, 3 * 98 * 104 * 4 + F32_BUF64(104)
     + 112 * 108 * 4),
    (64, 64, "tcw", 64, 3 * 64 * 72 * 4 + 2 * F32_BUF64(64)),
    # the streamed Gram route: A, T_2, T_3 then two f32 buffers
    (60, 98, "tcg", 64, 3 * 60 * 72 * 4 + 2 * F32_BUF64(64)),
    # at q = 37 the slices' merge scratch is the largest (2 x 64 x 72)
    (37, 98, "tcg", 64, 2 * 64 * 72 * 4 + 2 * F32_BUF64(40)),
])
def test_split_tf32_shapes(k, p, kind, w, want):
    """Without poly_bf16 the f32 groups take a tensor-core design in split
    TF32 (f32 operand buffers of round_up(q, 8) rows of round_up(q, 8) + 4
    floats), at the stated blocks per SM."""
    assert design(k, p, False) == kind
    assert smem_bytes(kind, k, p, False) == want <= (
        TC_SMEM_MAX if w == 64 else TCW_SMEM_MAX)
    assert width(kind, k, p, False) == w
    assert blocks_per_sm(kind, k, p, False) == WIDTH_BLOCKS[w]


@pytest.mark.parametrize("k,p,w,r0", [
    # couple_channels' joint groups: the region before the operand buffers
    # is A, T_2, T_3 (q = 100: 3 x 100 x 104 floats) or, at q = 60, the
    # same (3 x 60 x 72), whatever p
    (100, 147, 128, 3 * 100 * 104 * 4), (100, 294, 128, 3 * 100 * 104 * 4),
    (60, 294, 64, 3 * 60 * 72 * 4), (60, 1000, 64, 3 * 60 * 72 * 4),
    # small q: the four slices' merge scratch (2 x 64 x 72; the two stages
    # of both blocks' chunks take 2 x 2 x 32 x 68)
    (16, 129, 64, 2 * 64 * 72 * 4),
])
@pytest.mark.parametrize("bf16", [True, False])
def test_tcg_layout(k, p, w, r0, bf16):
    """The streamed Gram route's shared memory does not grow with p: its
    region of stages, merge scratch and A, T_2, T_3, then two operand
    buffers (bf16 w x (w + 8), or f32 in split TF32)."""
    buf = 2 * w * (w + 8) if bf16 else F32_BUF64(-(-k // 8) * 8)
    assert tcg_layout(k, p, bf16) == (w, r0 + 2 * buf, r0)
    assert design(k, p, bf16) == "tcg"
    assert tcg_smem_bytes(k, p, bf16) == smem_bytes("tcg", k, p, bf16)
    assert blocks_per_sm("tcg", k, p, bf16) == WIDTH_BLOCKS[w]


@pytest.mark.parametrize("k,p,bf16", [
    (129, 300, True), (129, 300, False),   # Gram groups with K > 128
    (150, 294, True), (150, 294, False),
    (300, 49, True), (300, 49, False),     # xc beyond shared memory
    (170, 98, True), (128, 128, False),    # A, T_2, T_3 and the buffers
    (105, 105, True),                      # A, T_2, T_3 of q = 105
])
def test_still_smem(k, p, bf16):
    """Shapes beyond every tensor-core design keep the shared-memory
    design."""
    assert design(k, p, bf16) == "smem"
    assert tcg_smem_bytes(k, p, bf16) == 0
    assert tcw_smem_bytes(k, p, bf16) == 0


@pytest.mark.parametrize("k,p,bf16,w", [
    (100, 98, True, 128), (100, 49, True, 0), (100, 49, False, 64),
    (100, 98, False, 128), (100, 129, False, 0), (60, 98, False, 0)])
def test_tcw_width(k, p, bf16, w):
    """The wide design's width: 128 for 64 < p <= 128 under poly_bf16; 64
    or 128 in split TF32; none for p > 128 or a Gram group."""
    assert tcw_width(k, p, bf16) == w
