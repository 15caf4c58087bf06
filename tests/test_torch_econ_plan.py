"""The launch plan of K2 (ops/econ_filter.py) on the CPU: which design a
group shape takes and the tensor-core designs' shared memory, which
mirrors csrc/econ_filter.cu ``tc_smem`` and ``tcw_smem`` (held equal on
the card by tests/test_torch_cuda.py::test_econ_tc_plan_matches_wrapper)."""

import pytest

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops.econ_filter import (BLOCKS_PER_SM, TC_SMEM_MAX,
                                            TCW_SMEM_MAX, design, smem_bytes,
                                            tc_smem_bytes, tcw_smem_bytes)

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
    assert tc_smem_bytes(k, p) == 0
    assert tcw_smem_bytes(k, p) == 0
    assert design(k, p, True) == "smem"


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
    assert design(k, p, True) == ("tcw" if want else "smem")
    assert design(k, p, False) == "smem"
    if want:
        assert smem_bytes("tcw", k, p) == want
        assert ldt % 32 == 8 and ldt >= p


@pytest.mark.parametrize("k,p", [(100, 105), (100, 128), (170, 98),
                                 (100, 129), (64, 64)])
def test_tcw_refuses(k, p):
    """Beyond the wide design: A, T_2, T_3 of q = 105-128 or 170 rows of
    xc exceed the 220 KB a block is given; p > 128 or q <= 64 is not its
    width."""
    assert tcw_smem_bytes(k, p) == 0
    assert design(k, p, True) == ("tc" if (k, p) == (64, 64) else "smem")


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
    under poly_bf16; every shape without poly_bf16 keeps the shared-memory
    design."""
    cfg = vt.default_config(20.0, preset=preset).stage(stage)
    k, p = cfg.npatches, cfg.pdim
    want = ("smem" if not bf16 else "tc" if min(k, p) <= 64 else "tcw")
    assert design(k, p, bf16) == want
    if preset in ("default", "sss") and stage == 0:
        assert (k, p) == (100, 98)
        assert design(k, p, bf16) == ("tcw" if bf16 else "smem")
    if preset == "iphone":
        assert (k, p) == ((100, 49), (60, 98))[stage]
        assert design(k, p, bf16) == ("tc" if bf16 else "smem")
