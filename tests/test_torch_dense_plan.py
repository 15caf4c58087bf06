"""The launch plan of K3 (ops/dense_dist.plan) on the CPU: it mirrors
csrc/dense_dist.cu ``make_plan`` (held equal on the card by
tests/test_torch_cuda.py::test_dense_dist_plan_matches_library).  For
every preset's (ps, w_s, pt*C) at every pyramid level of a 480x854 clip,
a 148-row halo tile and the 61x67 card-test clip: the column strips and
tiles cover every output once, the shared memory fits the SM at the blocks
per SM the plan claims (two at stage 1 of every preset), the grid covers
every frame, every warp task has two or more live lanes, and a warp's
reads stay in the tile and in distinct banks."""

import itertools

import numpy as np
import pytest
import torch

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.config import PRESETS
from vnlb_tpu_torch.ops.dense_dist import frame_range, plan, tasks_of_warp
from vnlb_tpu_torch.ops.search import eff_dt_range, search_levels

SM_SMEM = 233472                  # 228 KB per SM on the H100
BLOCK_SMEM_MAX = 232448           # 227 KB per block
RESERVED = 1024                   # per resident block
FRAMES = ((480, 854), (148, 854), (61, 67))
T_LEN = 5


def _cases():
    """(ps, w_s, ptc, h, w, n_f, stage) of every preset, stage, level and
    dt's frame count."""
    seen = set()
    for preset, stage, (h, w) in itertools.product(PRESETS, (0, 1), FRAMES):
        cfg = vt.default_config(20.0, preset=preset).stage(stage)
        vid = torch.empty((T_LEN, cfg.dist_chnls, h, w))
        lo, hi = eff_dt_range(cfg, T_LEN)
        n_fs = {frame_range(T_LEN, cfg.pt, dt)[1]
                - frame_range(T_LEN, cfg.pt, dt)[0]
                for dt in range(lo, hi + 1)}
        for v_l in search_levels(vid, cfg):
            for n_f in n_fs:
                seen.add((cfg.ps, cfg.w_s, cfg.pt * cfg.dist_chnls,
                          v_l.shape[2], v_l.shape[3], n_f, stage))
    return sorted(seen)


CASES = _cases()
SHAPES = sorted({c[:3] for c in CASES})


def test_presets_give_the_main_shapes():
    assert {(7, 15, 1), (7, 15, 6), (7, 15, 2), (7, 27, 2), (7, 27, 6)} \
        <= set(SHAPES)
    # the 480p needle levels of the iphone preset's first pass
    assert {(7, 15, 1, 240, 427, 5, 0), (7, 15, 1, 120, 213, 5, 0)} \
        <= set(CASES)


@pytest.mark.parametrize("ps,w_s,ptc,h,w,n_f,stage", CASES)
def test_strips_and_tiles_cover_each_output_once(ps, w_s, ptc, h, w, n_f,
                                                 stage):
    """The kernel's walk: block (bx, by), warp w's tasks (``tasks_of_warp``)
    -> (strip s, offset d) per lane; the strip's columns x0 + s*strip_w +
    x for x < strip_w inside the frame; each output (y, x, d) of the
    frame exactly once."""
    pl = plan(ps, w_s, ptc, h, w, n_f)
    hp, wp, ws2 = h - ps + 1, w - ps + 1, w_s * w_s
    th, tw, sw = pl["tile_h"], pl["tile_w"], pl["strip_w"]
    assert tw == pl["strips"] * sw and pl["items"] == pl["strips"] * ws2
    tasks = [t for warp in range(pl["threads"] // 32)
             for t in tasks_of_warp(pl, warp)]
    assert len(tasks) == pl["warp_tasks"]
    items = [it for t in tasks for it in t if it is not None]
    # every (strip, offset) pair exactly once
    assert sorted(items) == [(s, d) for s in range(pl["strips"])
                             for d in range(ws2)]
    cols = np.zeros(wp, int)
    for bx in range(pl["grid_x"]):
        x0 = bx * tw
        nx = min(tw, wp - x0)
        for strip in range(pl["strips"]):
            if strip * sw < nx:
                cols[x0 + strip * sw:x0 + min((strip + 1) * sw, nx)] += 1
    rows = np.zeros(hp, int)
    for by in range(pl["grid_y"]):
        rows[by * th:min((by + 1) * th, hp)] += 1
    assert (cols == 1).all() and (rows == 1).all()


@pytest.mark.parametrize("ps,w_s,ptc", SHAPES)
def test_shared_memory_fits_claimed_blocks(ps, w_s, ptc):
    pl = plan(ps, w_s, ptc, 480, 854, 4)
    assert pl["smem_bytes"] <= BLOCK_SMEM_MAX
    assert pl["blocks_per_sm"] * (pl["smem_bytes"] + RESERVED) <= SM_SMEM
    assert pl["blocks_per_sm"] == 2
    assert pl["threads"] == 256 and pl["smem_bytes"] % 16 == 0


@pytest.mark.parametrize("ps,w_s,ptc,h,w,n_f,stage", CASES)
def test_grid_covers_every_frame(ps, w_s, ptc, h, w, n_f, stage):
    pl = plan(ps, w_s, ptc, h, w, n_f)
    hp, wp = h - ps + 1, w - ps + 1
    assert pl["grid_z"] == n_f
    tw, th = pl["tile_w"], pl["tile_h"]
    assert pl["grid_x"] * tw >= wp > (pl["grid_x"] - 1) * tw
    assert pl["grid_y"] * th >= hp > (pl["grid_y"] - 1) * th
    if stage == 1:
        assert pl["blocks_per_sm"] >= 2


@pytest.mark.parametrize("ps,w_s,ptc", SHAPES + [(3, 9, 3), (9, 27, 6),
                                                 (5, 21, 2)])
def test_no_warp_runs_a_single_live_lane(ps, w_s, ptc):
    """Whole warps of one strip's offsets, then tail warps that pack the
    strips' last w_s^2 mod 32 offsets: every task has two or more live
    lanes, and the warps of a block share the tasks within one."""
    pl = plan(ps, w_s, ptc, 480, 854, 4)
    n_w = pl["threads"] // 32
    counts = []
    for warp in range(n_w):
        tasks = tasks_of_warp(pl, warp)
        counts.append(len(tasks))
        for t in tasks:
            live = [it for it in t if it is not None]
            assert len(live) >= 2
            if len(live) == 32 and len({s for s, _ in live}) == 1:
                d = [dd for _, dd in live]
                assert d == list(range(d[0], d[0] + 32))
    assert sum(counts) == pl["warp_tasks"]
    assert max(counts) - min(counts) <= max(1, pl["strips"])


@pytest.mark.parametrize("ps,w_s,ptc", SHAPES + [(3, 9, 3), (9, 27, 6)])
def test_reads_stay_in_the_tile_and_in_distinct_banks(ps, w_s, ptc):
    """A strip's query row (whole float4s from column s*strip_w) and
    candidate row (columns s*strip_w + b .. + strip_w + ps - 2) lie inside
    the padded tile rows, and the 32 offsets of a warp inside one strip
    read 32 distinct banks of the candidate tile and of b2."""
    pl = plan(ps, w_s, ptc, 480, 854, 4)
    sw, tw = pl["strip_w"], pl["tile_w"]
    n_q = -(-(sw + ps - 1) // 4) * 4
    assert pl["query_pitch"] % 4 == 0
    assert tw - sw + n_q <= pl["query_pitch"]
    assert tw - sw + (w_s - 1) + sw + ps - 2 < pl["cand_pitch"]
    assert pl["cand_rows"] == pl["tile_h"] + ps - 1 + w_s - 1
    for warp in range(pl["threads"] // 32):
        for t in tasks_of_warp(pl, warp):
            live = [it for it in t if it is not None]
            if len({s for s, _ in live}) > 1:
                continue          # a tail task: strips may share a bank
            d = np.array([dd for _, dd in live])
            a, b = d // w_s, d % w_s
            for pitch in (pl["cand_pitch"], pl["b2_pitch"]):
                banks = (a * pitch + b) % 32
                assert len(set(banks.tolist())) == len(d)


def test_wide_window_narrows_the_tile():
    """w_s = 27 at stage 1 (preset default) takes 16-column tiles to keep
    two blocks per SM; w_s = 15 keeps 32."""
    assert plan(7, 27, 6, 480, 854, 4)["tile_w"] == 16
    assert plan(7, 27, 2, 480, 854, 4)["tile_w"] == 32
    assert plan(7, 15, 6, 480, 854, 4)["tile_w"] == 32


@pytest.mark.parametrize("args", [(11, 15, 1, 61, 67, 2),
                                  (7, 15, 1, 6, 67, 2),
                                  (7, 0, 1, 61, 67, 2),
                                  (7, 61, 6, 480, 854, 4)])
def test_plan_refuses(args):
    with pytest.raises(ValueError):
        plan(*args)
