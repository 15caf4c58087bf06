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


@pytest.mark.parametrize("k,p,want", [
    (100, 49, "tc"), (60, 98, "tc"), (37, 98, "tc"), (16, 128, "smem"),
    (100, 147, "smem"), (60, 294, "smem")])
def test_without_bf16_takes_smem(k, p, want):
    """poly_bf16 off: the tensor-core design in split TF32 where its f32
    buffers fit (the right route's (100, 49), the left route's (60, 98)
    and (37, 98)); p = 128 (five 128 x 132 f32 buffers) and the
    couple_channels groups keep the shared-memory design."""
    assert design(k, p, False) == want


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
    # without poly_bf16: split TF32 except the right route at p = 98 (its
    # four f32 buffers and Q exceed 220 KB), and never couple_channels
    assert design(k, p, False) == ("smem" if (k, p) == (100, 98) else "tc")
    assert design(k, 3 * p, False) == "smem"


def test_blocks_per_sm():
    """Width 64 keeps two blocks on an SM, width 128 one (the card's plan
    must match: tests/test_torch_cuda.py)."""
    assert BLOCKS_PER_SM == {64: 2, 128: 1}
    assert tc_width(64) == 64 and tc_width(65) == 128
    assert tc_width(128) == 128 and tc_width(129) == 0


def _fbuf(p):
    r8 = -(-p // 8) * 8
    return 4 * r8 * (r8 + 4)                # an f32 operand buffer


@pytest.mark.parametrize("k,p,w,want", [
    # right route: four f32 buffers (56 x 60) and Q (64 x 64 f32)
    (100, 49, 64, 4 * _fbuf(49) + 64 * 64 * 4),
    (64, 33, 64, 64 * 68 * 4 + _part(64, 64)),
    (250, 49, 64, 250 * 68 * 4 + _part(64, 64)),  # xc of 250 rows
    # left route: the gate's five f32 buffers of 104 x 108 (224,640 of the
    # 225,280 bytes a width-128 block is given)
    (60, 98, 128, 5 * _fbuf(98)),
    (37, 98, 128, 5 * _fbuf(98)),
    (20, 49, 64, _fbuf(49) + 49 * 68 * 4 + 49 * 68 * 4 + _part(64, 64)),
])
def test_tc_smem_layout_f32(k, p, w, want):
    """Without poly_bf16 the tensor-core design stores f32 operand buffers
    of round_up(p, 8) rows at a stride of round_up(p, 8) + 4 and splits
    them into TF32 in registers; its largest phase."""
    assert tc_width(p) == w
    assert tc_smem_bytes(k, p, False) == want <= TC_SMEM_MAX[w]
    assert design(k, p, False) == "tc"


@pytest.mark.parametrize("k,p", [(100, 98), (16, 128), (100, 147),
                                 (60, 294), (65, 98), (300, 49)])
def test_tc_refuses_f32(k, p):
    """Split TF32 beyond the tensor-core design: the right route at p =
    98, p = 128, couple_channels, a left route with k > 64, xc of 300
    rows."""
    assert tc_smem_bytes(k, p, False) == 0
    assert design(k, p, False) == "smem"
