"""The launch plan of K2 (ops/econ_filter.py) on the CPU: which design a
group shape takes and the tensor-core design's shared memory, which
mirrors csrc/econ_filter.cu ``tc_smem`` (held equal on the card by
tests/test_torch_cuda.py::test_econ_tc_plan_matches_wrapper)."""

import pytest

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops.econ_filter import (TC_SMEM_MAX, design,
                                            tc_smem_bytes)

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
    (100, 98), (60, 294), (100, 147), (100, 294),  # q > 64 or p > 128
    (16, 129), (300, 49), (65, 70)])
def test_tc_refuses(k, p):
    assert tc_smem_bytes(k, p) == 0
    assert design(k, p, True) == "smem"


@pytest.mark.parametrize("preset", ["iphone", "sss_v2", "default", "sss"])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("bf16", [True, False])
def test_preset_shapes_take_design(preset, stage, bf16):
    """The main path's groups (iphone and sss_v2: (100, 49) and (60, 98))
    take the tensor-core design under poly_bf16; the pt=2 first pass of
    default and sss ((100, 98), q = 98) and every shape without poly_bf16
    keep the shared-memory design."""
    cfg = vt.default_config(20.0, preset=preset).stage(stage)
    k, p = cfg.npatches, cfg.pdim
    tc = bf16 and min(k, p) <= 64
    assert design(k, p, bf16) == ("tc" if tc else "smem")
    if preset == "iphone":
        assert (k, p) == ((100, 49), (60, 98))[stage]
        assert design(k, p, bf16) == ("tc" if bf16 else "smem")
