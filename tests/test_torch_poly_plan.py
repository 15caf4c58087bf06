"""The launch plan of K5 (ops/poly_filter.py) on the CPU: which design a
group shape takes, the tensor-core design's padded width and its shared
memory, which mirrors csrc/poly_filter.cu ``tc_layout`` (held equal on the
card by tests/test_torch_cuda.py::test_poly_tc_plan_matches_wrapper), and
the batched design's padded sizes, tiles, workspace and sub-batch, which
mirror csrc/poly_tcb.cu ``tcb_plan`` (on the card:
test_poly_tcb_plan_matches_wrapper)."""

import pytest

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops.poly_filter import (BLOCKS_PER_SM, TC_SMEM_MAX,
                                            TCB_TILE, TCB_WS_BYTES, design,
                                            tc_smem_bytes, tc_width,
                                            tcb_plan, tcb_takes)


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


@pytest.mark.parametrize("k,p,want", [
    # couple_channels (p > 128), left with k > 64, p > 128: the batched
    # design takes the left routes
    (100, 147, "tcb"), (60, 294, "tcb"), (100, 294, "tcb"), (60, 147, "tcb"),
    (65, 98, "tcb"), (100, 129, "tcb"),
    (250, 49, "smem"), (200, 128, "smem")])      # right routes beyond it
def test_tc_refuses(k, p, want):
    assert tc_smem_bytes(k, p) == 0
    assert design(k, p, True) == want


@pytest.mark.parametrize("k,p,want", [
    (100, 49, "tc"), (60, 98, "tc"), (37, 98, "tc"), (16, 128, "tcb"),
    (100, 147, "tcb"), (60, 294, "tcb"), (100, 98, "tc"),
    (128, 128, "smem")])
def test_without_bf16_takes_smem(k, p, want):
    """poly_bf16 off: the tensor-core design in split TF32 where its f32
    buffers fit (the right route's (100, 49) and (100, 98), the left
    route's (60, 98) and (37, 98)); the left routes it refuses, p = 128
    (five 128 x 132 f32 buffers) and the couple_channels groups, take the
    batched design; the shared-memory design keeps only right routes (p =
    128)."""
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
    assert design(k, 3 * p, joint.poly_bf16) == "tcb"
    # without poly_bf16: split TF32 (the right route at p = 98, stage 0
    # of presets default, exp and sss, keeps Q in the gate's fifth f32
    # buffer: 224,640 bytes); couple_channels batched
    assert design(k, p, False) == "tc"
    assert design(k, 3 * p, False) == "tcb"


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
    # right route: the gate's five f32 buffers (56 x 60), Q in the fifth
    (100, 49, 64, 5 * _fbuf(49)),
    (64, 33, 64, 64 * 68 * 4 + _part(64, 64)),
    (250, 49, 64, 250 * 68 * 4 + _part(64, 64)),  # xc of 250 rows
    # the right route at p = 98 (presets default, exp, sss, stage 0): five
    # buffers of 104 x 108, Q in the fifth; xc of 162 rows is the most the
    # covariance phase holds at width 128
    (100, 98, 128, 5 * _fbuf(98)),
    (162, 98, 128, 162 * 132 * 4 + _part(128, 128)),
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


@pytest.mark.parametrize("k,p,want", [
    (128, 128, "smem"), (16, 128, "tcb"), (100, 147, "tcb"), (60, 294, "tcb"),
    (65, 98, "tcb"), (300, 49, "smem"), (163, 98, "smem"), (300, 98, "smem"),
    (200, 128, "smem")])
def test_tc_refuses_f32(k, p, want):
    """Split TF32 beyond the tensor-core design: p = 128 (the right route
    of ps = 8, pt = 2 with npatches >= 128), couple_channels, a left route
    with k > 64, xc of more rows than the covariance phase holds (300 at
    p = 49, 163 and 300 at p = 98); the left routes among them take the
    batched design, the right routes the shared-memory design."""
    assert tc_smem_bytes(k, p, False) == 0
    assert design(k, p, False) == want


def _up(x, m):
    return -(-x // m) * m


def _tcb_group_bytes(k, p, rnd):
    """One group's workspace, from the buffer list of csrc/poly_tcb.cu
    (each 256-byte aligned): Ah, S twice, st(S S), st(S^3) (bf16 only) in
    the operand type, S^3 in f32, 64 coefficients, row |sums| and the
    diagonal of C, xn (three bf16 parts or f32), z_j twice and their
    running sum in f32 and, under bf16, z_j twice rounded."""
    pp, kp, e = _up(p, 16), _up(k, 16), 2 if rnd else 4
    sq, zk = pp * pp, kp * pp
    bufs = [sq * e] * (5 if rnd else 4) + [sq * 4, 256, pp * 4, pp * 4]
    bufs += [(3 if rnd else 1) * zk * e, zk * 4, zk * 4, zk * 4]
    bufs += [zk * e] * (2 if rnd else 0)
    return sum(_up(b, 256) for b in bufs)


@pytest.mark.parametrize("rnd", [True, False])
@pytest.mark.parametrize("k,p,pp,kp", [
    (100, 147, 160, 112), (60, 294, 304, 64), (100, 294, 304, 112),
    (60, 147, 160, 64), (65, 98, 112, 80)])
def test_tcb_plan(k, p, pp, kp, rnd):
    """The batched design at couple_channels' shapes and a left route with
    k > 64: p and k padded to 16, 64 x 64 output tiles of a p x p product
    of the gate (all under bf16; in split TF32, symmetric, those on and
    above the diagonal) and of a k x p product, a group's workspace, and
    4096 groups in even sub-batches within TCB_WS_BYTES."""
    assert design(k, p, rnd) == "tcb" and tcb_takes(k, p)
    plan = tcb_plan(4096, k, p, rnd)
    tn = _up(pp, TCB_TILE) // TCB_TILE
    assert TCB_TILE == 64
    assert (plan["p_pad"], plan["k_pad"]) == (pp, kp)
    assert plan["tiles"] == (tn * tn if rnd else tn * (tn + 1) // 2)
    assert plan["ztiles"] == _up(kp, 64) // 64 * tn
    gb = _tcb_group_bytes(k, p, rnd)
    assert plan["group_bytes"] == gb
    cap = TCB_WS_BYTES // gb
    n = -(-4096 // cap)
    assert plan["batch"] == -(-4096 // n) <= cap
    assert plan["ws_bytes"] == gb * plan["batch"] <= TCB_WS_BYTES


@pytest.mark.parametrize("g,want", [
    (4096, 293), (1, 1), (311, 311), (312, 156)])
def test_tcb_batch(g, want):
    """Sub-batches: as many groups as TCB_WS_BYTES holds, spread evenly
    (311 groups of (60, 294) in bf16 a sub-batch: 4096 groups in 14
    sub-batches of 293 or fewer, 312 in two of 156); at least one."""
    assert TCB_WS_BYTES == 512 << 20
    plan = tcb_plan(g, 60, 294, True)
    assert plan["batch"] == want


@pytest.mark.parametrize("k,p,takes", [
    (60, 294, True), (100, 294, True), (16, 128, True), (1, 2, True),
    (294, 294, False), (300, 294, False),    # right routes
    (60, 520, False),                        # p > 512
    (200, 500, False)])                      # xc beyond the prologue's 200 KB
def test_tcb_takes(k, p, takes):
    assert tcb_takes(k, p) == takes
    assert (tcb_plan(64, k, p) is not None) == takes
