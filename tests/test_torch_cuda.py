"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither jax nor vnlb_tpu, so it runs on a machine that
has only PyTorch; tests/conftest.py imports jax, so run it there with

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Without a CUDA card every test skips (a CUDA kernel has no CPU mode).
"""

import numpy as np
import pytest
import torch

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops.dense_dist import card_plan as k3_card_plan
from vnlb_tpu_torch.ops.dense_dist import (dense_dist, dense_dist_plain,
                                           frame_range)
from vnlb_tpu_torch.ops.dense_dist import plan as k3_plan
from vnlb_tpu_torch.ops import poly_filter as k5
from vnlb_tpu_torch.ops.econ_filter import (blocks_per_sm, design,
                                            econ_filter, econ_filter_kernel,
                                            econ_filter_plain, smem_bytes,
                                            tc_plan, tc_smem_bytes)
from vnlb_tpu_torch.ops.mask import lattice_sites
from vnlb_tpu_torch.ops.patch_dist import (card_plan, patch_dist,
                                           patch_dist_plain, patch_dist_tile,
                                           patch_dist_tile_plain, tile_oob)
from vnlb_tpu_torch.ops.patch_dist import plan as k1_plan
from vnlb_tpu_torch.ops.patch_gather import patch_gather, patch_gather_plain
from vnlb_tpu_torch.ops.poly_filter import poly_filter, poly_filter_plain
from vnlb_tpu_torch.ops.search import (_window_starts, eff_dt_range,
                                       search_levels, track_centers)
from vnlb_tpu_torch.testing.data import add_noise, drift_flows, synthetic_video
from vnlb_tpu_torch.testing.stale_ws import tcb_stale_workspace
from vnlb_tpu_torch.utils.metrics import compute_psnr

BENCH = dict(preset="iphone", eig_method="poly", step_s=6,
             border_mode="mask", topk="exact")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1])
def test_patch_dist_kernel_matches_plain(card, stage):
    cfg = vt.default_config(20.0, **BENCH).stage(stage)
    rng = np.random.default_rng(1)
    vid = torch.from_numpy(rng.uniform(0, 255, (5, cfg.dist_chnls, 60, 64))
                           .astype(np.float32)).to(card)
    sites = torch.from_numpy(lattice_sites((5, 3, 60, 64), cfg)).to(card)
    args = (vid, sites[:, 0], sites[:, 1], sites[:, 2], -3, 7, cfg.pt,
            cfg.ps, cfg.w_s)
    before = patch_dist.launches
    got = patch_dist(*args)
    want = patch_dist_plain(*args)
    torch.cuda.synchronize()
    assert patch_dist.launches == before + 1
    # f32 sums of the same squares in another order
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1])
def test_patch_dist_window_starts_match_plain(card, stage):
    """K1's gather-search entry: per-(dt, site) window starts from
    flow-tracked centres."""
    cfg = vt.default_config(20.0).stage(stage)
    rng = np.random.default_rng(2)
    shape = (5, 3, 60, 64)
    vid = torch.from_numpy(rng.uniform(0, 255, (5, cfg.dist_chnls, 60, 64))
                           .astype(np.float32)).to(card)
    ff, bf = (torch.from_numpy(rng.uniform(-3, 3, (5, 2, 60, 64))
                               .astype(np.float32)).to(card)
              for _ in range(2))
    sites = torch.from_numpy(lattice_sites(shape, cfg)).to(card)
    cen = track_centers(sites, ff, bf, 3, 3, shape).long()
    sy, sx = _window_starts(cen, cfg.w_s, cfg.ps, 60, 64)
    args = (vid, sites[:, 0], sites[:, 1], sites[:, 2], -3, 7, cfg.pt,
            cfg.ps, cfg.w_s)
    kw = dict(sy=sy.T.contiguous(), sx=sx.T.contiguous())
    before = patch_dist.launches
    got = patch_dist(*args, **kw)
    want = patch_dist_plain(*args, **kw)
    torch.cuda.synchronize()
    assert patch_dist.launches == before + 1
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-2)
    assert not torch.allclose(got, patch_dist(*args), rtol=1e-5, atol=1e-2)


def _k1_rel(got, want):
    """chip_smoke.py's K1 criterion: max |d| / max(|want|, 1)."""
    return ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()


def _k1_video(rng, t_len, c, h, w, card):
    return torch.from_numpy(rng.uniform(0, 255, (t_len, c, h, w))
                            .astype(np.float32)).to(card)


def _k1_sites(rng, s_cnt, t_len, h, w, ps, card):
    """``s_cnt`` query corners: the four frame corners first, then random
    ones over the whole frame."""
    corners = [(0, 0, 0), (t_len - 1, 0, w - ps), (0, h - ps, 0),
               (t_len - 1, h - ps, w - ps)]
    rest = np.stack([rng.integers(0, t_len, s_cnt),
                     rng.integers(0, h - ps + 1, s_cnt),
                     rng.integers(0, w - ps + 1, s_cnt)], 1)
    sites = np.concatenate([np.array(corners), rest])[:s_cnt]
    return torch.from_numpy(sites.astype(np.int32)).to(card)


# (pt, C, w_s): every preset's (pt * dist_chnls, w_s) and pt*C = 3
K1_SHAPES = [(1, 1, 15), (1, 3, 15), (2, 3, 15), (2, 1, 27), (2, 3, 27),
             (1, 1, 27)]


@pytest.mark.cuda
@pytest.mark.parametrize("pt,c,w_s", K1_SHAPES)
@pytest.mark.parametrize("s_cnt", [1, 4, 389])
def test_patch_dist_shapes_match_plain(card, pt, c, w_s, s_cnt):
    """K1 at every preset's plane count and window, S = 1 and S that is
    no multiple of the pairs per block, the frame corners among the sites,
    dt planes whose frames fall outside [0, T) (dt_lo = -T); a repeat
    launch is bitwise equal."""
    rng = np.random.default_rng(s_cnt + 10 * w_s + pt * c)
    t_len, h, w = 4, 40, 46
    vid = _k1_video(rng, t_len, c, h, w, card)
    sites = _k1_sites(rng, s_cnt, t_len, h, w, 7, card)
    args = (vid, sites[:, 0], sites[:, 1], sites[:, 2], -t_len, 2 * t_len,
            pt, 7, w_s)
    before = patch_dist.launches
    got = patch_dist(*args)
    want = patch_dist_plain(*args)
    torch.cuda.synchronize()
    assert patch_dist.launches == before + 1
    assert _k1_rel(got, want) < 1e-5
    assert torch.equal(patch_dist(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("pt,c,w_s", K1_SHAPES)
def test_patch_dist_window_starts_outside_frame(card, pt, c, w_s):
    """Window starts partly or wholly outside the frame read zeros there,
    as the plain version does."""
    rng = np.random.default_rng(w_s + pt * c)
    t_len, h, w = 5, 36, 40
    vid = _k1_video(rng, t_len, c, h, w, card)
    sites = _k1_sites(rng, 203, t_len, h, w, 7, card)
    n_dt = 5
    sy, sx = (torch.from_numpy(rng.integers(-w_s - 8, n + 8, (n_dt, 203))
                               .astype(np.int32)).to(card) for n in (h, w))
    args = (vid, sites[:, 0], sites[:, 1], sites[:, 2], -2, n_dt, pt, 7, w_s)
    got = patch_dist(*args, sy=sy, sx=sx)
    want = patch_dist_plain(*args, sy=sy, sx=sx)
    torch.cuda.synchronize()
    assert _k1_rel(got, want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("w_s", [15, 27])
@pytest.mark.parametrize("base_row,hp_g,wp_g", [(-9, 20, 31), (13, 40, 17),
                                                 (-3, 9, 40)])
def test_patch_dist_tile_straddles_frame_edge(card, w_s, base_row, hp_g,
                                              wp_g):
    """A global frame whose edges cut through the micro-tiles (3 x 5
    candidates): +inf at exactly ``tile_oob``, the other values as the
    plain version's."""
    rng = np.random.default_rng(w_s - base_row)
    t_len, h, w = 4, 44, 48
    vid = _k1_video(rng, t_len, 3, h, w, card)
    sites = _k1_sites(rng, 157, t_len, h, w, 7, card)
    args = (vid, sites[:, 0], sites[:, 1], sites[:, 2], -2, 4, 2, 7, w_s,
            base_row, hp_g, wp_g)
    got = patch_dist_tile(*args)
    want = patch_dist_tile_plain(*args)
    torch.cuda.synchronize()
    bad = tile_oob(sites[:, 1], sites[:, 2], w_s, base_row, hp_g, wp_g)
    assert bad.any() and not bad.all()
    assert torch.equal(torch.isinf(got), bad[None].expand_as(got))
    fin = ~bad[None].expand_as(got)
    assert _k1_rel(got[fin], want[fin]) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ps,w_s,s_cnt,n_dt", [
    (7, 15, 4096, 9), (7, 15, 46046, 7), (7, 27, 4096, 13), (7, 15, 1, 1),
    (5, 21, 389, 3), (3, 9, 1000, 2)])
def test_patch_dist_plan_matches_library(card, ps, w_s, s_cnt, n_dt):
    """ops/patch_dist.plan mirrors the library's launch plan, and the card
    grants the blocks per SM the plan claims."""
    got, per_sm = card_plan(ps, w_s, s_cnt, n_dt)
    assert got == k1_plan(ps, w_s, s_cnt, n_dt)
    assert per_sm >= got["blocks_per_sm"]


@pytest.mark.cuda
def test_patch_dist_refuses_unbuilt_patch_size(card):
    vid = torch.zeros((3, 1, 30, 30), device=card)
    q = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="ps=9"):
        patch_dist(vid, q, q, q, 0, 1, 1, 9, 15)


@pytest.mark.cuda
@pytest.mark.parametrize("joint,bf16", [(False, True), (False, False),
                                        (True, True), (True, False)])
def test_patch_gather_kernel_bitwise(card, joint, bf16):
    """K4 copies values (rounding them to bf16 at most), so it is bitwise
    equal to its plain version, -1 indices included."""
    rng = np.random.default_rng(5)
    shape = (5, 3, 40, 44)
    t_len, c, h, w = shape
    pt, ps = (2, 7) if joint else (1, 7)
    videos = [torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
              .to(card) for _ in range(2 if joint else 1)]
    inds = rng.integers(-1, (t_len - pt + 1) * c * h * w, (300, 37))
    inds = torch.from_numpy(inds.astype(np.int32)).to(card)
    before = patch_gather.launches
    got = patch_gather(videos, inds, ps, pt, bf16)
    want = patch_gather_plain(videos, inds, ps, pt, bf16)
    torch.cuda.synchronize()
    assert patch_gather.launches == before + 1
    assert len(got) == len(videos)
    for g, wnt in zip(got, want):
        assert g.shape == (300, 37, c, pt * ps * ps)
        assert torch.equal(g, wnt)


@pytest.mark.cuda
@pytest.mark.parametrize("stage,bf16", [(0, True), (1, True), (0, False),
                                        (1, False)])
def test_econ_filter_kernel_matches_plain(card, stage, bf16):
    cfg = vt.default_config(20.0, **BENCH).stage(stage).replace(
        poly_bf16=bf16)
    k, p = cfg.npatches, cfg.pdim
    rng = np.random.default_rng(stage)
    base = rng.normal(size=(64, 1, p)).astype(np.float32) * 30
    xc = torch.from_numpy(base + rng.normal(size=(64, k, p))
                          .astype(np.float32) * 20).to(card)
    xn = torch.from_numpy(base + rng.normal(size=(64, k, p))
                          .astype(np.float32) * 20).to(card)
    got = econ_filter(xc, xn, cfg)
    want = econ_filter_plain(xc, xn, cfg)
    scale = want.abs().mean()
    rms = ((got - want) ** 2).mean().sqrt() / scale
    # same cast points, other summation order (tolerances of
    # tests/test_pallas_filter.py)
    assert rms < (5e-2 if bf16 else 1e-4), rms.item()


@pytest.mark.cuda
def test_main_path_launches_kernels(card):
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    cfg = vt.default_config(20.0, **BENCH)
    patch_dist.launches = econ_filter.launches = patch_gather.launches = 0
    deno, basic, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert patch_dist.launches > 0 and econ_filter.launches > 0
    assert patch_gather.launches > 0
    again, _, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert torch.equal(deno, again)
    assert compute_psnr(deno.cpu().numpy(), clean) > \
        compute_psnr(noisy, clean) + 6.0


@pytest.mark.cuda
@pytest.mark.parametrize("flow", [False, True])
def test_api_default_launches_kernels(card, flow):
    """``denoise(noisy, sigma)`` with no cfg (step 3, sliding borders),
    with zero flow and with the clip's drift flow."""
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    flows = drift_flows(5, 96, 112) if flow else None
    patch_dist.launches = econ_filter.launches = patch_gather.launches = 0
    deno, basic, _ = vt.denoise(noisy, 20.0, flows=flows, device=card)
    assert min(patch_dist.launches, econ_filter.launches,
               patch_gather.launches) > 0
    again, _, _ = vt.denoise(noisy, 20.0, flows=flows, device=card)
    assert torch.equal(deno, again)
    assert compute_psnr(deno.cpu().numpy(), clean) > \
        compute_psnr(noisy, clean) + 6.0


@pytest.mark.cuda
def test_site_chunks_bitwise_on_card(card, monkeypatch):
    """Both kernels work per site / per group and the scatter keeps the
    global order, so the chunk size does not change a bit."""
    noisy = add_noise(synthetic_video(5, 64, 80, seed=2), 20.0, seed=3)
    cfg = vt.default_config(20.0, **BENCH).stage(1)
    vid = torch.from_numpy(noisy).to(card)
    whole = vt.proc_nl(vid, vid, None, None, None, cfg)
    monkeypatch.setattr(vt.pipeline, "SITE_CHUNK", 97)
    assert torch.equal(vt.proc_nl(vid, vid, None, None, None, cfg), whole)


def _groups(rng, g, k, p, card):
    base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
    return tuple(torch.from_numpy(base + rng.normal(size=(g, k, p))
                                  .astype(np.float32) * 20).to(card)
                 for _ in range(2))


def _rel_rms(got, want):
    return (((got - want) ** 2).mean().sqrt() / want.abs().mean()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("preset,stage,k,p", [
    ("default", 0, 100, 98), ("iphone", 0, 100, 147), ("iphone", 1, 60, 294),
    ("default", 0, 100, 294)])
def test_econ_filter_kernel_large_groups(card, preset, stage, k, p):
    """Groups beyond the shared-memory design's shared memory (pt=2 first
    pass, couple_channels), on the design ``design`` picks (the wide or the
    streamed Gram tensor-core design) and on the shared-memory design:
    spilled matrices in the per-block workspace, patch blocks read in
    place; 300 groups exceed one persistent grid."""
    cfg = vt.default_config(20.0, preset=preset).stage(stage)
    xc, xn = _groups(np.random.default_rng(k + p), 300, k, p, card)
    before = econ_filter.launches
    got = econ_filter(xc, xn, cfg)
    want = econ_filter_plain(xc, xn, cfg)
    old = econ_filter_kernel(xc, xn, cfg, smem_design=True)
    torch.cuda.synchronize()
    assert econ_filter.launches == before + 2
    assert torch.isfinite(got).all()
    assert _rel_rms(got, want) < 5e-2
    assert _rel_rms(old, want) < 5e-2
    f32 = cfg.replace(poly_bf16=False)
    want32 = econ_filter_plain(xc, xn, f32)
    assert _rel_rms(econ_filter(xc, xn, f32), want32) < 1e-4
    assert _rel_rms(econ_filter_kernel(xc, xn, f32, smem_design=True),
                    want32) < 1e-4


# the tensor-core design's shapes: both main-path shapes at a chunk's
# 12,288 groups, and widths that pad to 64 (q = 37, 33) at group counts
# that are not a multiple of the resident blocks (132 SMs x 2)
TC_SHAPES = [(1, 60, 98, 12288), (0, 100, 49, 12288), (1, 37, 98, 777),
             (0, 64, 33, 535)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("stage,k,p,g", TC_SHAPES)
def test_econ_filter_tc_shapes_match_plain(card, stage, k, p, g, bf16):
    """The tensor-core design under poly_bf16 (without it, split TF32 on
    the wide design for the matrix route, on the streamed Gram route for
    the Gram route) against the plain version at the tolerances of
    test_econ_filter_kernel_matches_plain; a repeat run is bitwise equal
    and each call is one launch."""
    cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
    assert design(k, p, bf16) == (
        "tc" if bf16 else "tcg" if k < p else "tcw")
    xc, xn = _groups(np.random.default_rng(k * p + g), g, k, p, card)
    before = econ_filter.launches
    got = econ_filter(xc, xn, cfg)
    again = econ_filter(xc, xn, cfg)
    want = econ_filter_plain(xc, xn, cfg)
    torch.cuda.synchronize()
    assert econ_filter.launches == before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel_rms(got, want) < (5e-2 if bf16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(100, 49), (60, 98), (37, 98), (64, 33),
                                 (16, 128), (16, 129), (100, 98), (60, 294),
                                 (100, 147), (100, 294), (129, 300)])
def test_econ_tc_plan_matches_wrapper(card, k, p):
    """The kernel library's plan of each tensor-core design ("tc" at width
    64; "tcw" and "tcg" at 64 or 128), with bf16 operands and in split
    TF32, equals the wrapper's (ops/econ_filter.smem_bytes), and a shape
    it takes keeps the blocks on an SM that the design states
    (ops/econ_filter.blocks_per_sm: two at width 64, one at 128)."""
    for kind in ("tc", "tcw", "tcg"):
        for rnd in (True, False):
            smem, per_sm = tc_plan(k, p, kind, rnd)
            assert smem == smem_bytes(kind, k, p, rnd)
            if smem:
                assert per_sm >= blocks_per_sm(kind, k, p, rnd)
            else:
                assert per_sm == 0
    assert tc_plan(k, p) == tc_plan(k, p, "tc")
    assert (tc_smem_bytes(k, p) > 0) == (design(k, p, True) == "tc")


# the wide design's shapes: preset default's pt=2 first pass at a chunk's
# 12,288 groups and at a count that is not a multiple of the resident
# blocks (132 SMs x 1), and a q = 65 matrix route
TCW_SHAPES = [(100, 98, 12288), (100, 98, 777), (70, 65, 535)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("k,p,g", TCW_SHAPES)
def test_econ_filter_tcw_matches_plain(card, k, p, g, bf16):
    """The wide tensor-core design, bf16 under poly_bf16 and split TF32
    without it, against the plain version at the tolerances of
    test_econ_filter_tc_shapes_match_plain; a repeat run is bitwise equal,
    each call is one launch of its design, and the shared-memory design
    agrees on the same inputs."""
    cfg = vt.default_config(20.0, preset="default").stage(0).replace(
        poly_bf16=bf16)
    assert design(k, p, bf16) == "tcw"
    xc, xn = _groups(np.random.default_rng(k * p + g), g, k, p, card)
    before = econ_filter.launches
    kind_before = econ_filter.by_design[design(k, p, bf16)]
    got = econ_filter(xc, xn, cfg)
    again = econ_filter(xc, xn, cfg)
    want = econ_filter_plain(xc, xn, cfg)
    torch.cuda.synchronize()
    assert econ_filter.launches == before + 2
    assert econ_filter.by_design[design(k, p, bf16)] == kind_before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel_rms(got, want) < (5e-2 if bf16 else 1e-4)
    old = econ_filter_kernel(xc, xn, cfg, smem_design=True)
    assert _rel_rms(old, want) < (5e-2 if bf16 else 1e-4)


# the streamed Gram route's shapes: couple_channels' joint groups at a
# count that is not a multiple of the resident blocks (both modes), a
# ragged K and p, and without poly_bf16 the Gram route's (60, 98) at a
# chunk's 12,288 groups (under poly_bf16 it takes the width-64 design)
TCG_SHAPES = [(pr, st, k, p, g, bf16) for pr, st, k, p, g in (
    ("iphone", 0, 100, 147, 777), ("iphone", 1, 60, 294, 777),
    ("default", 0, 100, 294, 300), ("iphone", 1, 16, 129, 300))
    for bf16 in (True, False)] + [("iphone", 1, 60, 98, 12288, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("preset,stage,k,p,g,bf16", TCG_SHAPES)
def test_econ_filter_tcg_matches_plain(card, preset, stage, k, p, g, bf16):
    """The streamed Gram route, bf16 and split TF32, against the plain
    version at chip_smoke.py's K2 tolerances (rms / scale < 5e-3; 1e-4 in
    f32); a repeat run is bitwise equal, each call is one launch of the
    design, and the shared-memory design agrees on the same inputs."""
    cfg = vt.default_config(20.0, preset=preset).stage(stage).replace(
        poly_bf16=bf16)
    assert design(k, p, bf16) == "tcg"
    xc, xn = _groups(np.random.default_rng(k * p + g + bf16), g, k, p, card)
    before = econ_filter.by_design["tcg"]
    got = econ_filter(xc, xn, cfg)
    again = econ_filter(xc, xn, cfg)
    want = econ_filter_plain(xc, xn, cfg)
    old = econ_filter_kernel(xc, xn, cfg, smem_design=True)
    torch.cuda.synchronize()
    assert econ_filter.by_design["tcg"] == before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    tol = 5e-3 if bf16 else 1e-4
    assert _rel_rms(got, want) < tol
    assert _rel_rms(old, want) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("stage,bf16", [(0, True), (1, True), (0, False),
                                        (1, False)])
def test_poly_filter_kernel_matches_plain(card, stage, bf16):
    """K5 on both routes: right (stage 0, K=100 >= p=49), left (stage 1,
    K=60 < p=98); same cast points, other summation order."""
    cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
    xc, xn = _groups(np.random.default_rng(40 + stage), 64, cfg.npatches,
                     cfg.pdim, card)
    before = poly_filter.launches
    got = poly_filter(xc, xn, cfg)
    want = poly_filter_plain(xc, xn, cfg)
    torch.cuda.synchronize()
    assert poly_filter.launches == before + 1
    assert torch.isfinite(got).all()
    assert _rel_rms(got, want) < (5e-2 if bf16 else 1e-4)


# K5's tensor-core shapes: both routes at a chunk's 12,288 groups, ragged
# widths and group counts (q = 37, 33, 128; 777, 535, 300 groups), the
# right route at width 128 (preset default's (100, 98) at a chunk too, and
# (162, 98), the most rows its covariance phase holds) and the left route
# at width 64
K5_TC_SHAPES = [(1, 60, 98, 12288), (0, 100, 49, 12288), (1, 37, 98, 777),
                (0, 64, 33, 535), (1, 16, 128, 300), (0, 100, 98, 300),
                (1, 20, 49, 300), (0, 100, 98, 12288), (0, 162, 98, 300)]
# the shape whose f32 buffers exceed the tensor-core design's shared
# memory: a left route, on the batched design
K5_F32_DESIGN = {(16, 128): "tcb"}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("stage,k,p,g", K5_TC_SHAPES)
def test_poly_filter_tc_shapes_match_plain(card, stage, k, p, g, bf16):
    """K5's tensor-core design (split TF32 without poly_bf16; for
    K5_F32_DESIGN's f32 shape the design named there) against the plain
    version, at chip_smoke.py's K5 tolerance (rms / scale < 2e-2) and 1e-4
    in f32; a repeat run is bitwise equal and each call is one launch."""
    cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
    # split TF32 without poly_bf16, except where its f32 buffers do not fit
    assert k5.design(k, p, bf16) == (
        K5_F32_DESIGN[k, p] if not bf16 and (k, p) in K5_F32_DESIGN
        else "tc")
    xc, xn = _groups(np.random.default_rng(k * p + g + 1), g, k, p, card)
    before = poly_filter.launches
    got = poly_filter(xc, xn, cfg)
    again = poly_filter(xc, xn, cfg)
    want = poly_filter_plain(xc, xn, cfg)
    torch.cuda.synchronize()
    assert poly_filter.launches == before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel_rms(got, want) < (2e-2 if bf16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(100, 49), (60, 98), (37, 98), (64, 33),
                                 (16, 128), (100, 98), (20, 49), (100, 147),
                                 (60, 294), (65, 98), (162, 98), (163, 98),
                                 (128, 128), (300, 49)])
def test_poly_tc_plan_matches_wrapper(card, k, p):
    """The kernel library's plan of K5's tensor-core design, with bf16
    operands and in split TF32, equals the wrapper's
    (ops/poly_filter.tc_smem_bytes), and a shape it takes keeps the blocks
    on an SM its width states (two at 64, one at 128)."""
    assert k5.tc_plan(k, p) == k5.tc_plan(k, p, True)
    for rnd in (True, False):
        smem, per_sm = k5.tc_plan(k, p, rnd)
        assert smem == k5.tc_smem_bytes(k, p, rnd)
        if smem:
            assert per_sm >= k5.BLOCKS_PER_SM[k5.tc_width(p)]
        else:
            assert per_sm == 0


# K5's batched design: couple_channels' joint groups (the presets' (100,
# 147) and (60, 294), preset default's (100, 294), and (60, 147)) at a
# ragged group count
K5_TCB_SHAPES = [(0, 100, 147, 300), (1, 60, 294, 300), (0, 100, 294, 131),
                 (1, 60, 147, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("stage,k,p,g", K5_TCB_SHAPES)
def test_poly_filter_tcb_matches_plain(card, stage, k, p, g, bf16):
    """K5's batched design against the plain version at chip_smoke.py's
    K5 tolerance (rms / scale < 2e-2 with bf16 operands, 1e-4 in split
    TF32); a repeat run is bitwise equal; each call is one launch, counted
    by ``launches`` and ``by_design["tcb"]``."""
    cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
    assert k5.design(k, p, bf16) == "tcb"
    xc, xn = _groups(np.random.default_rng(k * p + g), g, k, p, card)
    before, tcb = poly_filter.launches, poly_filter.by_design["tcb"]
    got = poly_filter(xc, xn, cfg)
    again = poly_filter(xc, xn, cfg)
    want = poly_filter_plain(xc, xn, cfg)
    torch.cuda.synchronize()
    assert poly_filter.launches == before + 2
    assert poly_filter.by_design["tcb"] == tcb + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel_rms(got, want) < (2e-2 if bf16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(100, 98), (128, 128), (300, 49)])
def test_poly_filter_smem_right_f32(card, k, p):
    """K5's shared-memory design on right routes in f32: forced at preset
    default's (100, 98) (``smem_design=True``, which the card's checks
    time beside the tensor-core design), and where it is the design (p =
    128; xc of 300 rows): against the plain version within 1e-4, bitwise
    on repeat, one launch of it a call."""
    cfg = vt.default_config(20.0).stage(0).replace(poly_bf16=False)
    assert k5.design(k, p, False) == ("tc" if (k, p) == (100, 98)
                                      else "smem")
    xc, xn = _groups(np.random.default_rng(k + p), 300, k, p, card)
    before = poly_filter.by_design["smem"]
    got = k5.poly_filter_kernel(xc, xn, cfg, smem_design=True)
    again = k5.poly_filter_kernel(xc, xn, cfg, smem_design=True)
    want = poly_filter_plain(xc, xn, cfg)
    torch.cuda.synchronize()
    assert poly_filter.by_design["smem"] == before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel_rms(got, want) < 1e-4


@pytest.mark.cuda
def test_poly_filter_tcb_forced_matches_tc(card):
    """The batched design forced on the main path's (60, 98) groups
    (``batched_design=True``) against the tensor-core design, within the
    bf16 bound; it refuses a right-route shape (no fallback)."""
    cfg = vt.default_config(20.0).stage(1)
    xc, xn = _groups(np.random.default_rng(98), 768, 60, 98, card)
    tcb = poly_filter.by_design["tcb"]
    got = k5.poly_filter_kernel(xc, xn, cfg, batched_design=True)
    want = k5.poly_filter_kernel(xc, xn, cfg)
    torch.cuda.synchronize()
    assert poly_filter.by_design["tcb"] == tcb + 1
    assert _rel_rms(got, want) < 2e-2
    x0 = torch.zeros((2, 100, 49), device=card)
    with pytest.raises(ValueError, match="batched design"):
        k5.poly_filter_kernel(x0, x0, vt.default_config(20.0).stage(0),
                              batched_design=True)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("stage,k,p", [(0, 100, 147), (1, 60, 294)])
def test_poly_filter_tcb_stale_workspace(card, stage, k, p, bf16):
    """The batched design's output does not depend on what its workspace
    held: at 4096 groups a launch on a fresh workspace and one on the
    block of a freed workspace of 0xFF bytes (NaN as f32 and as bf16),
    which the caching allocator hands back (the same ``data_ptr``), are
    bitwise equal, and equal the wrapper's own launch."""
    cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
    xc, xn = _groups(np.random.default_rng(k * p), 4096, k, p, card)
    r = tcb_stale_workspace(xc, xn, cfg)
    assert r["reused"]
    assert torch.isfinite(r["fresh"]).all()
    assert torch.equal(r["stale"], r["fresh"])
    assert torch.equal(r["own"], r["fresh"])
    short = torch.empty((r["ws_bytes"] // 2,), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="workspace"):
        k5.poly_filter_kernel(xc, xn, cfg, _workspace=short)


@pytest.mark.cuda
@pytest.mark.parametrize("rnd", [True, False])
@pytest.mark.parametrize("g,k,p", [(4096, 100, 147), (4096, 60, 294),
                                   (4096, 100, 294), (300, 60, 147),
                                   (535, 65, 98), (1, 16, 128),
                                   (64, 100, 49), (64, 60, 98)])
def test_poly_tcb_plan_matches_wrapper(card, g, k, p, rnd):
    """The kernel library's plan of the batched design (padded sizes,
    tiles, sub-batch, workspace) equals the wrapper's
    (ops/poly_filter.tcb_plan; 4096 groups at p = 294 take 14 or 17
    sub-batches); None for the right route."""
    assert k5.card_tcb_plan(g, k, p, rnd) == k5.tcb_plan(g, k, p, rnd)
    assert (k5.tcb_plan(g, k, p, rnd) is None) == (k >= p)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["econ", "poly"])
def test_filter_kernels_refuse_degree_beyond_tables(card, which):
    """A fused degree of 80 needs 84 econ coefficients and 168 nodes, a
    Wiener degree of 80 81 coefficients: beyond the kernels' tables."""
    cfg = vt.default_config(20.0).stage(0)
    x = torch.zeros((2, 100, 49), device=card)
    with pytest.raises(NotImplementedError, match="coefficients"):
        if which == "econ":
            econ_filter(x, x, cfg.replace(poly_deg_fused=80))
        else:
            poly_filter(x, x, cfg.replace(poly_deg=80))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["preset_default", "poly_pallas",
                                  "poly_pallas_couple", "default_pallas_f32"])
def test_filter_paths_launch_kernels(card, name):
    """The default preset (w_s=27, K2 on K=100, p=98 groups),
    poly_impl="pallas" (K5 in both passes, K2 never), poly_impl="pallas"
    with couple_channels (every K5 launch on the batched design) and the
    default preset with poly_impl="pallas" in split TF32 (every K5 launch,
    (100, 98) and (60, 98), on the tensor-core design) run on the card."""
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    cfg = {"preset_default": vt.default_config(20.0, preset="default"),
           "default_pallas_f32": vt.default_config(
               20.0, preset="default", poly_impl="pallas", poly_bf16=False)
           }.get(name) or vt.default_config(
               20.0, poly_impl="pallas",
               couple_channels=name == "poly_pallas_couple")
    for c in (patch_dist, econ_filter, patch_gather, poly_filter):
        c.launches = 0
    econ_filter.by_design.update(tc=0, tcw=0, smem=0)
    poly_filter.by_design.update(tc=0, tcb=0, smem=0)
    deno, _, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert min(patch_dist.launches, patch_gather.launches) > 0
    if name == "preset_default":
        assert econ_filter.launches > 0 and poly_filter.launches == 0
        assert econ_filter.by_design["tcw"] > 0
    else:
        assert poly_filter.launches > 0 and econ_filter.launches == 0
    if name == "poly_pallas_couple":
        assert poly_filter.by_design["tcb"] == poly_filter.launches
    if name == "default_pallas_f32":
        assert poly_filter.by_design["tc"] == poly_filter.launches
    again, _, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert torch.equal(deno, again)
    assert compute_psnr(deno.cpu().numpy(), clean) > \
        compute_psnr(noisy, clean) + 6.0


def _box(x, ps):
    """ps x ps box sums of (N, H, W), f64."""
    return torch.nn.functional.avg_pool2d(x[:, None].double(), ps,
                                          stride=1)[:, 0] * ps * ps


def _k3_case(pt, c_d, w_s, ps, dt, h=61, w=67):
    """A case's id: its parameters, and its frame when not 61x67."""
    tag = "-".join(map(str, (pt, c_d, w_s, ps, dt)))
    return pytest.param(pt, c_d, w_s, ps, dt, h, w,
                        id=tag if (h, w) == (61, 67) else f"{tag}-{h}x{w}")


@pytest.mark.cuda
@pytest.mark.parametrize("pt,c_d,w_s,ps,dt,h,w", [
    _k3_case(1, 1, 15, 7, 0), _k3_case(1, 1, 15, 7, -2),
    _k3_case(2, 3, 15, 7, 1), _k3_case(2, 3, 27, 7, 0),
    _k3_case(1, 3, 9, 5, 2),
    # ps 3 and 9 (W' = 65, 59: not whole strips of 8)
    _k3_case(2, 3, 15, 3, 1), _k3_case(2, 3, 15, 9, 0),
    _k3_case(1, 1, 27, 9, -1),
    # H' shorter than one tile; a frame narrower than one strip
    _k3_case(1, 1, 15, 7, 0, 12, 67), _k3_case(2, 3, 15, 7, 1, 12, 13),
    # w_s = 27 at pt*C = 6 (16-column tiles) and dt < 0 (f_lo > 0)
    _k3_case(2, 3, 27, 7, -2), _k3_case(2, 3, 15, 7, -2, 40, 90)])
def test_dense_dist_kernel_matches_plain(card, pt, c_d, w_s, ps, dt, h, w):
    """K3 against its plain version: |d| <= 1e-5 (q2 + b2) + 1e-3."""
    rng = np.random.default_rng(7)
    vid = torch.from_numpy(rng.uniform(0, 255, (5, c_d, h, w))
                           .astype(np.float32)).to(card)
    before = dense_dist.launches
    got = dense_dist(vid, dt, pt, ps, w_s)
    want = dense_dist_plain(vid, dt, pt, ps, w_s)
    torch.cuda.synchronize()
    assert dense_dist.launches == before + 1
    f_lo, f_hi = frame_range(5, pt, dt)
    half = (w_s - 1) // 2
    v2 = (vid.double() ** 2).sum(1)
    box = _box(sum(v2[p:p + 6 - pt] for p in range(pt)), ps)
    hp, wp = box.shape[1:]
    b2 = torch.nn.functional.pad(box[f_lo + dt:f_hi + dt], (half,) * 4)
    scale = torch.stack([box[f_lo:f_hi] + b2[:, a:a + hp, b:b + wp]
                         for a in range(w_s) for b in range(w_s)], -1)
    assert got.shape == want.shape == scale.shape
    assert ((got - want).abs() <= 1e-5 * scale + 1e-3).all()


@pytest.mark.cuda
@pytest.mark.parametrize("pt,c_d,w_s", [(1, 1, 15), (2, 3, 15), (2, 3, 27)])
def test_dense_dist_kernel_repeats_bitwise(card, pt, c_d, w_s):
    """Two launches on the same input give the same bits (no atomics, a
    fixed order of sums)."""
    rng = np.random.default_rng(8)
    vid = torch.from_numpy(rng.uniform(0, 255, (5, c_d, 70, 90))
                           .astype(np.float32)).to(card)
    first = dense_dist(vid, 1, pt, 7, w_s)
    again = dense_dist(vid, 1, pt, 7, w_s)
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("ps,w_s,ptc,h,w,n_f", [
    (7, 15, 6, 480, 854, 4), (7, 15, 1, 480, 854, 5), (7, 15, 1, 240, 427, 5),
    (7, 15, 1, 148, 854, 3), (7, 27, 6, 480, 854, 4), (7, 27, 2, 61, 67, 3),
    (3, 15, 6, 61, 67, 4), (9, 27, 3, 61, 67, 2), (5, 9, 3, 12, 13, 1)])
def test_dense_dist_plan_matches_library(card, ps, w_s, ptc, h, w, n_f):
    """ops/dense_dist.plan mirrors the library's launch plan, and the card
    grants the blocks per SM the plan claims."""
    got, per_sm = k3_card_plan(ps, w_s, ptc, h, w, n_f)
    assert got == k3_plan(ps, w_s, ptc, h, w, n_f)
    assert per_sm >= got["blocks_per_sm"]


@pytest.mark.cuda
def test_dense_full_path_launches_kernels(card):
    """dense_rows="full" launches K3 once per (level, dt) of each pass;
    topk="stream" gives the same bits."""
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    cfg = vt.default_config(20.0, dense_rows="full")
    yuv = torch.from_numpy(noisy).to(card)
    want = 0
    for i in (0, 1):
        lo, hi = eff_dt_range(cfg.stage(i), 5)
        want += len(search_levels(yuv, cfg.stage(i))) * (hi - lo + 1)
    dense_dist.launches = 0
    deno, basic, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert dense_dist.launches == want
    again, b2, _ = vt.denoise(
        noisy, 20.0, device=card,
        cfg=vt.default_config(20.0, dense_rows="full", topk="stream"))
    assert torch.equal(deno, again) and torch.equal(basic, b2)
    assert compute_psnr(deno.cpu().numpy(), clean) > \
        compute_psnr(noisy, clean) + 6.0


@pytest.mark.cuda
def test_streaming_on_card(card):
    clean = synthetic_video(13, 48, 48, seed=7)
    noisy = add_noise(clean, 20.0, seed=8)
    cfg = vt.default_config(20.0, nwt_f=[1, 1], nwt_b=[1, 1])
    d_s, b_s, _ = vt.denoise_streaming(noisy, 20.0, chunk=3, cfg=cfg,
                                       device=card)
    d_m, b_m, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert np.abs(d_s - d_m.cpu().numpy()).mean() < 1e-3
    assert np.abs(b_s - b_m.cpu().numpy()).mean() < 1e-3


def _strip_case(stage, strip, card):
    """A 5x128x96 clip in 4 strips (hs 32, halo 14): the search tile of
    ``strip`` at ``stage``, its home sites and the global bounds."""
    from vnlb_tpu_torch.parallel.halo import _plan_strip_sites, _strip_geometry

    cfg = vt.default_config(20.0).stage(stage).replace(border_mode="mask")
    rng = np.random.default_rng(5 + stage)
    vid = rng.uniform(0, 255, (5, cfg.dist_chnls, 128, 96)).astype(np.float32)
    shape = (5, 3, 128, 96)
    halo, hs, h_run = _strip_geometry(shape, cfg, 4)
    assert h_run == 128
    sites, _ = _plan_strip_sites(shape, cfg, 4, halo, strip)
    base_row = strip * hs - halo
    tile = np.zeros((5, cfg.dist_chnls, hs + 2 * halo, 96), np.float32)
    lo, hi = max(base_row, 0), min(base_row + hs + 2 * halo, h_run)
    tile[:, :, lo - base_row:hi - base_row] = vid[:, :, lo:hi]
    sites = torch.from_numpy(sites).to(card)
    return (cfg, torch.from_numpy(tile).to(card), sites, base_row,
            h_run - cfg.ps + 1, 96 - cfg.ps + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("strip", [0, 1, 3])
def test_patch_dist_tile_kernel_matches_plain(card, stage, strip):
    """K1's tile entry: the same +inf positions (zero-filled halo rows on
    the first and last strips, the left and right edges), finite values
    as K1's."""
    cfg, tile, sites, base_row, hp_g, wp = _strip_case(stage, strip, card)
    args = (tile, sites[:, 0], sites[:, 1], sites[:, 2], -3, 7, cfg.pt,
            cfg.ps, cfg.w_s, base_row, hp_g, wp)
    before = patch_dist_tile.launches
    got = patch_dist_tile(*args)
    want = patch_dist_tile_plain(*args)
    torch.cuda.synchronize()
    assert patch_dist_tile.launches == before + 1
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and not fin.all()
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
def test_patch_dist_tile_whole_frame_bitwise(card):
    """With the whole frame as the tile, the tile entry is K1 plus the
    mask-border +inf, bit for bit."""
    cfg = vt.default_config(20.0).stage(1).replace(border_mode="mask")
    vid = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 255, (5, 3, 60, 64)).astype(np.float32)).to(card)
    sites = torch.from_numpy(lattice_sites((5, 3, 60, 64), cfg)).to(card)
    hp_g, wp = 60 - cfg.ps + 1, 64 - cfg.ps + 1
    args = (vid, sites[:, 0], sites[:, 1], sites[:, 2], -3, 7, cfg.pt,
            cfg.ps, cfg.w_s)
    got = patch_dist_tile(*args, 0, hp_g, wp)
    bad = tile_oob(sites[:, 1], sites[:, 2], cfg.w_s, 0, hp_g, wp)
    want = patch_dist(*args).masked_fill(bad[None], float("inf"))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_strip_composition_matches_proc_nl(card):
    """strip_runner over the 4 strips of a 5x128x96 clip, then
    combine_strips, against the one-device pass under mask borders
    (tests/test_halo.py's bound), through K1's tile entry."""
    from vnlb_tpu_torch.parallel.halo import combine_strips, strip_runner

    clean = synthetic_video(5, 128, 96, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    cfg = vt.default_config(20.0).stage(0).replace(border_mode="mask")
    patch_dist_tile.launches = 0
    tiles, meta = [], None
    for i in range(4):
        run, meta = strip_runner(noisy, None, cfg, 4, i, device=card)
        tiles.append(run())
    got = combine_strips(tiles, cfg, noisy, None, meta)
    assert patch_dist_tile.launches > 0
    want = vt.proc_nl(torch.from_numpy(noisy).to(card), None, None, None,
                      None, cfg)
    diff = (got - want).abs()
    assert diff.max().item() < 0.5 and diff.mean().item() < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("strip", [0, 1, 3])
@pytest.mark.parametrize("mode", [dict(dense_rows="full"),
                                  dict(topk="stream")], ids=["full", "stream"])
def test_tile_search_all_rows_matches_plain(card, strip, mode):
    """The halo tile's all-rows search (``exec_search_dense_tile`` in its
    "full" mode: K3 planes of the tile and of the full-frame needle levels,
    no bf16 rounding) against the same search on the plain versions, stage
    0 of a 5x128x96 clip in 4 strips: one K3 launch per (level, dt), the
    same inf pattern, values to the f32 rounding of the distances
    (|d| <= 1e-5 (q2 + b2) + 1e-3 per level, (q2 + b2) / norm <= 2), index
    swaps only at ties."""
    from vnlb_tpu_torch.ops.search_dense import (exec_search_dense_tile,
                                                 tile_search_mode)
    from vnlb_tpu_torch.parallel.halo import (_coarse, _plan_strip_sites,
                                              _strip_geometry)

    cfg = vt.default_config(20.0, **mode).stage(0).replace(border_mode="mask")
    assert tile_search_mode(cfg) == "full" and cfg.stype == "needle"
    shape = (5, 3, 128, 96)
    vid = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 255, shape).astype(np.float32)).to(card)
    halo, hs, h_run = _strip_geometry(shape, cfg, 4)
    coarse = _coarse(vid, cfg, hs)
    sites, gy = _plan_strip_sites(shape, cfg, 4, halo, strip)
    base_row = strip * hs - halo
    tile = vid.new_zeros((5, 3, hs + 2 * halo, 96))
    lo, hi = max(base_row, 0), min(base_row + hs + 2 * halo, h_run)
    tile[:, :, lo - base_row:hi - base_row] = vid[:, :, lo:hi]
    args = (tile, torch.from_numpy(sites).to(card),
            torch.from_numpy(gy).to(card), cfg, base_row,
            h_run - cfg.ps + 1, coarse)
    dt_lo, dt_hi = eff_dt_range(cfg, 5)
    before = dense_dist.launches
    vk, ik = exec_search_dense_tile(*args)
    assert dense_dist.launches - before == \
        (1 + len(coarse)) * (dt_hi - dt_lo + 1)
    vp, ip = exec_search_dense_tile(*args, dist_fn=patch_dist_plain,
                                    tile_fn=patch_dist_tile_plain,
                                    dense_fn=dense_dist_plain)
    fin = torch.isfinite(vp)
    assert torch.equal(torch.isfinite(vk), fin)
    norm = cfg.pt * cfg.dist_chnls * cfg.ps ** 2 * 255.0 ** 2
    tol = (1 + len(coarse)) * (2e-5 + 1e-3 / norm)
    err = (vk - vp).abs()[fin]
    assert (err <= tol).all(), err.max().item()
    assert (ik == ip).float().mean().item() > 0.95


# ---- estimated flow, the reference-order pass, the aggregation modes ----

# tests/test_torch_flow_est.py's tolerances (the port against JAX on the
# CPU), here the card against the CPU
TVL1_MEAN, TVL1_MAX, LK_MAX = 1e-4, 0.25, 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["tvl1", "lk"])
def test_estimate_flows_card_matches_cpu(card, method):
    from vnlb_tpu_torch.ops.flow import estimate_flows

    noisy = add_noise(synthetic_video(3, 72, 96, seed=11, motion=4.0), 20.0,
                      seed=12)
    got = estimate_flows(noisy, method=method, device=card)
    want = estimate_flows(noisy, method=method, device="cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.shape == (3, 2, 72, 96)
        d = (g.cpu() - w).abs()
        if method == "lk":
            assert d.max().item() <= LK_MAX
        else:
            assert d.mean().item() <= TVL1_MEAN
            assert d.max().item() <= TVL1_MAX
    again = estimate_flows(noisy, method=method, device=card)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
def test_denoise_compat_kernels_match_plain(card):
    """The reference-order pass launches K1, K2 and K4, repeats bitwise,
    and lands within 0.02 dB of its plain-version pass."""
    from vnlb_tpu_torch.compat import denoise_compat

    clean = synthetic_video(3, 64, 72, seed=5)
    noisy = add_noise(clean, 20.0, seed=6)
    cfg = vt.default_config(20.0, bsize=[128, 128])
    patch_dist.launches = econ_filter.launches = patch_gather.launches = 0
    deno, basic = denoise_compat(noisy, 20.0, cfg=cfg, device=card)
    assert min(patch_dist.launches, econ_filter.launches,
               patch_gather.launches) > 0
    d2, b2 = denoise_compat(noisy, 20.0, cfg=cfg, device=card)
    assert torch.equal(d2, deno) and torch.equal(b2, basic)
    dp, bp = denoise_compat(noisy, 20.0, cfg=cfg, device=card,
                            kernels=vt.PLAIN)
    for got, want in ((basic, bp), (deno, dp)):
        assert abs(compute_psnr(got.cpu().numpy(), clean)
                   - compute_psnr(want.cpu().numpy(), clean)) < 0.02
    assert compute_psnr(deno.cpu().numpy(), clean) > \
        compute_psnr(noisy, clean) + 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [dict(agg_weight="exp"),
                                  dict(agg_weight="exp", dense_rows="full"),
                                  dict(only_frame=2), dict(agg_bf16=True),
                                  dict(poly_gram=False)])
def test_agg_modes_kernels_match_plain(card, mode):
    """Each aggregation mode with the kernels against the plain versions:
    within 0.02 dB, a bitwise repeat; the left regime launches no K2 in
    the second pass."""
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    cfg = vt.default_config(20.0, **mode)
    econ_filter.launches = 0
    deno, basic, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    if "poly_gram" in mode:
        n0 = econ_filter.launches
        econ_filter.launches = 0
        vt.proc_nl(torch.from_numpy(noisy).to(card), basic, None, None, None,
                   cfg.stage(1))
        assert n0 > 0 and econ_filter.launches == 0
    again, _, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert torch.equal(again, deno)
    dp, bp, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card,
                           kernels=vt.PLAIN)
    for got, want in ((basic, bp), (deno, dp)):
        assert abs(compute_psnr(got.cpu().numpy(), clean)
                   - compute_psnr(want.cpu().numpy(), clean)) < 0.02


@pytest.mark.cuda
def test_agg_patches_repeat_bitwise_on_card(card):
    """The pixel scatter adds duplicates in a fixed order on the card: a
    repeat is bitwise equal, and equal to the same scatter on the CPU
    (the same additions in the same order)."""
    from vnlb_tpu_torch.ops.agg import agg_patches

    rng = np.random.default_rng(4)
    shape = (4, 3, 40, 44)
    inds = rng.integers(0, 4 * 3 * 40 * 44, (64, 30)).astype(np.int32)
    inds[1] = inds[0]
    inds[5, 3] = -1
    patches = rng.normal(100, 30, (64, 30, 2, 3, 7, 7)).astype(np.float32)
    valid = rng.uniform(size=64) < 0.9

    def run(dev):
        deno = torch.zeros((4 * 40 * 44, 3), device=dev)
        wts = torch.zeros((4 * 40 * 44,), device=dev)
        return agg_patches(deno, wts, torch.from_numpy(patches).to(dev),
                           torch.from_numpy(inds).to(dev),
                           torch.from_numpy(valid).to(dev), 2, 7, shape)

    a, b = run(card), run(card)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = run("cpu")
    assert torch.equal(a[0].cpu(), c[0]) and torch.equal(a[1].cpu(), c[1])


# the program's sync spans in one API-default call on a 5x96x112 numpy
# clip: the clip's upload, per pass the sites' upload, three colour
# matrices (two rgb -> yuv, one yuv -> rgb) and one dense and one gather
# chunk (each an inf scalar, a filter call's K2 tables and a scatter's
# counts), and the final wait
SYNC_SPANS = {"vnlb.sync.inputs": 1, "vnlb.sync.sites": 2,
              "vnlb.sync.color_matrix": 6, "vnlb.sync.dense_inf": 2,
              "vnlb.sync.gather_inf": 2, "vnlb.sync.scatter_counts": 4,
              "vnlb.sync.filter_consts": 4, "vnlb.sync.call_end": 1}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


@pytest.mark.cuda
def test_every_sync_of_a_call_lies_in_a_sync_span(card):
    """Every stream or device synchronize a ``denoise`` call issues lies
    inside one of the program's ``vnlb.sync.*`` spans, on the profiler's
    host clock; the spans' count for this clip is pinned."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    noisy = add_noise(synthetic_video(5, 96, 112, seed=0), 20.0, seed=1)
    vt.denoise(noisy, 20.0, device=card)          # the build, the allocator
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("test.call"):
            vt.denoise(noisy, 20.0, device=card)
    evs = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU]
    (call,) = [(s, e) for n, s, e in evs if n == "test.call"]
    spans = [(n, s, e) for n, s, e in evs if n.startswith("vnlb.sync.")]
    syncs = [(n, s, e) for n, s, e in evs
             if n in SYNCS and call[0] <= s and e <= call[1]]
    outside = [(n, s - call[0]) for n, s, e in syncs
               if not any(s0 <= s and e <= e0 for _, s0, e0 in spans)]
    assert syncs and not outside, outside
    assert Counter(n for n, _, _ in spans) == SYNC_SPANS
