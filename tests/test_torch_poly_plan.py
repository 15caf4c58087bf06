"""The launch plan of K5 (ops/poly_filter.py) on the CPU: which design a
group shape takes, the tensor-core design's padded width and its shared
memory, which mirrors csrc/poly_filter.cu ``tc_layout`` (held equal on the
card by tests/test_torch_cuda.py::test_poly_tc_plan_matches_wrapper)."""

import pytest

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops.poly_filter import (BLOCKS_PER_SM, TC_SMEM_MAX,
                                            design, tc_smem_bytes, tc_width)


def _buf(w):
    return w * (w + 8) * 2                  # one bf16 w x w operand buffer


def _part(mr, w):
    return 2 * mr * (w + 8) * 4             # a syrk's two partial sums


@pytest.mark.parametrize("k,p,w,want", [
    # right route (k >= p): xc and the covariance's scratch, or four
    # buffers and Q, or one buffer and xn's three bf16 parts
    (100, 49, 64, 100 * 68 * 4 + _part(64, 64)),
    (64, 33, 64, 64 * 68 * 4 + _part(64, 64)),
    (100, 98, 128, 4 * _buf(128) + 128 * 128 * 4),
    (200, 49, 64, _buf(64) + 3 * 208 * 72 * 2),
    # left route (k < p, k <= 64): one buffer, xn^T, W (f32) and the xn W
    # scratch
    (60, 98, 128, _buf(128) + 98 * 68 * 4 + 98 * 132 * 4 + _part(64, 128)),
    (37, 98, 128, _buf(128) + 98 * 68 * 4 + 98 * 132 * 4 + _part(64, 128)),
    (16, 128, 128, _buf(128) + 128 * 68 * 4 + 128 * 132 * 4
     + _part(64, 128)),
    (20, 49, 64, _buf(64) + 49 * 68 * 4 + 49 * 68 * 4 + _part(64, 64)),
])
def test_tc_smem_layout(k, p, w, want):
    assert tc_width(p) == w
    assert tc_smem_bytes(k, p) == want <= TC_SMEM_MAX[w]
    assert design(k, p, True) == "tc"


@pytest.mark.parametrize("k,p", [
    (100, 147), (60, 294), (100, 294), (60, 147),  # couple_channels: p > 128
    (65, 98), (100, 129),                           # left with k > 64; p > 128
    (250, 49), (200, 128)])                         # beyond shared memory
def test_tc_refuses(k, p):
    assert tc_smem_bytes(k, p) == 0
    assert design(k, p, True) == "smem"


@pytest.mark.parametrize("k,p", [(100, 49), (60, 98), (37, 98), (16, 128),
                                 (100, 147), (60, 294)])
def test_without_bf16_takes_smem(k, p):
    """poly_bf16 off keeps the shared-memory design (f32 products on CUDA
    cores), whatever the shape."""
    assert design(k, p, False) == "smem"


@pytest.mark.parametrize("preset", ["iphone", "sss_v2", "default", "sss"])
@pytest.mark.parametrize("stage", [0, 1])
def test_preset_shapes_take_tc(preset, stage):
    """Every preset's groups without couple_channels take the tensor-core
    design under poly_bf16: width 64 for p = 49, 128 for p = 98."""
    cfg = vt.default_config(20.0, preset=preset).stage(stage)
    k, p = cfg.npatches, cfg.pdim
    assert design(k, p, True) == "tc"
    assert tc_width(p) == (64 if p == 49 else 128)
    joint = vt.default_config(20.0, preset=preset,
                              couple_channels=True).stage(stage)
    assert design(k, 3 * p, joint.poly_bf16) == "smem"


def test_blocks_per_sm():
    """Width 64 keeps two blocks on an SM, width 128 one (the card's plan
    must match: tests/test_torch_cuda.py)."""
    assert BLOCKS_PER_SM == {64: 2, 128: 1}
    assert tc_width(64) == 64 and tc_width(65) == 128
    assert tc_width(128) == 128 and tc_width(129) == 0
