"""The launch plan of K1 (ops/patch_dist.plan) on the CPU: it mirrors
csrc/patch_dist.cu ``make_plan`` (held equal on the card by
tests/test_torch_cuda.py::test_patch_dist_plan_matches_library).  For
every preset's (ps, w_s, dt planes) and a ragged S: the micro-tiles cover
every candidate once, the shared memory fits the SM at the blocks per SM
the plan claims, the grid covers every (site, dt) pair, and the two groups
of a warp read disjoint shared-memory banks."""

import itertools

import pytest

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.config import PRESETS
from vnlb_tpu_torch.ops.patch_dist import plan
from vnlb_tpu_torch.ops.search import eff_dt_range

SM_SMEM = 233472                  # 228 KB per SM on the H100
BLOCK_SMEM_MAX = 232448           # 227 KB per block
RESERVED = 1024                   # per resident block
SITES = [1, 389, 4096, 46046]


def _cases():
    seen = set()
    for preset, stage, t_len in itertools.product(PRESETS, (0, 1), (5, 30)):
        cfg = vt.default_config(20.0, preset=preset).stage(stage)
        lo, hi = eff_dt_range(cfg, t_len)
        seen.add((cfg.ps, cfg.w_s, hi - lo + 1))
    return sorted(seen)


CASES = _cases()


def test_presets_give_the_main_shapes():
    assert {(7, 15, 9), (7, 15, 7), (7, 27, 7), (7, 15, 21), (7, 27, 13)} \
        <= set(CASES)


@pytest.mark.parametrize("ps,w_s,n_dt", CASES)
def test_micro_tiles_cover_each_candidate_once(ps, w_s, n_dt):
    pl = plan(ps, w_s, 4096, n_dt)
    owners = pl["tiles_down"] * pl["tiles_across"]
    assert owners <= pl["lanes"] and pl["lanes"] in (16, 32, 64, 96, 128,
                                                     160, 192, 224, 256)
    assert pl["threads"] == pl["lanes"] * pl["pairs_per_block"] <= 256
    seen = {}
    for lane in range(owners):
        ta, tb = divmod(lane, pl["tiles_across"])
        for da, db in itertools.product(range(pl["micro_rows"]),
                                        range(pl["micro_cols"])):
            a, b = ta * pl["micro_rows"] + da, tb * pl["micro_cols"] + db
            if a < w_s and b < w_s:
                seen[a, b] = seen.get((a, b), 0) + 1
            # a ragged tile reads inside the padded region
            assert a + ps - 1 < pl["region_rows"]
            assert b + ps - 1 < pl["region_cols"]
    assert len(seen) == w_s * w_s and set(seen.values()) == {1}


@pytest.mark.parametrize("ps,w_s,n_dt", CASES)
def test_shared_memory_fits_claimed_blocks(ps, w_s, n_dt):
    pl = plan(ps, w_s, 4096, n_dt)
    stage = pl["region_rows"] * pl["region_cols"] + ps * ps
    stride = pl["smem_bytes"] // (2 * 4 * pl["pairs_per_block"])
    assert stride >= stage and stride % 32 == 16
    assert pl["smem_bytes"] == 2 * pl["pairs_per_block"] * stride * 4
    assert pl["smem_bytes"] <= BLOCK_SMEM_MAX
    assert pl["blocks_per_sm"] * (pl["smem_bytes"] + RESERVED) <= SM_SMEM


@pytest.mark.parametrize("ps,w_s,n_dt", CASES)
@pytest.mark.parametrize("s_cnt", SITES)
def test_grid_covers_every_pair(ps, w_s, n_dt, s_cnt):
    pl = plan(ps, w_s, s_cnt, n_dt)
    per_block = pl["pairs_per_block"] * pl["sites_per_group"]
    assert 1 <= pl["sites_per_group"] <= 4
    assert pl["grid_x"] * per_block >= s_cnt > (pl["grid_x"] - 1) * per_block
    # the kernel's walk: block x, group p, step m -> site x*P*M + m*P + p,
    # each site of [0, S) exactly once (blockIdx.y covers the dt planes)
    sites = sorted(x * per_block + m * pl["pairs_per_block"] + p
                   for x in range(pl["grid_x"])
                   for m in range(pl["sites_per_group"])
                   for p in range(pl["pairs_per_block"]))
    assert [s for s in sites if s < s_cnt] == list(range(s_cnt))


def test_more_sites_per_group_on_a_large_grid():
    assert plan(7, 15, 46046, 7)["sites_per_group"] == 4
    assert plan(7, 15, 4096, 7)["sites_per_group"] == 1
    assert plan(7, 15, 1, 1)["grid_x"] == 1


@pytest.mark.parametrize("n_dt", [7, 9])
def test_half_warp_groups_read_disjoint_banks(n_dt):
    """w_s = 15, ps = 7 (every preset's first pass and the iphone second):
    two groups of 16 lanes per warp; for every region load of the compute
    loop the 30 owning lanes hit 30 distinct banks."""
    ps = 7
    pl = plan(ps, 15, 4096, n_dt)
    assert pl["lanes"] == 16
    stride = pl["smem_bytes"] // (2 * 4 * pl["pairs_per_block"])
    rc = pl["region_cols"]
    for r, u in itertools.product(range(pl["micro_rows"] + ps - 1),
                                  range(pl["micro_cols"] + ps - 1)):
        banks = []
        for group, lane in itertools.product((0, 1), range(15)):
            ta, tb = divmod(lane, pl["tiles_across"])
            addr = (group * stride + (ta * pl["micro_rows"] + r) * rc
                    + tb * pl["micro_cols"] + u)
            banks.append(addr % 32)
        assert len(set(banks)) == 30


@pytest.mark.parametrize("ps,w_s", [(9, 15), (7, 0), (7, 61)])
def test_plan_refuses(ps, w_s):
    with pytest.raises(ValueError):
        plan(ps, w_s, 10, 1)
