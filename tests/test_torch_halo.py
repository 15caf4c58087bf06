"""The halo-sharded pass of the PyTorch port against the JAX package on the
CPU.

* K1's tile entry (plain version) against the Pallas tile kernel in
  interpret mode at the in-bounds candidates of an offset strip;
* ``exec_search_dense_tile`` against JAX's on offset strips, with and
  without needle levels: values to one bf16 ulp per level, index swaps only
  at ties; its all-rows mode (``dense_rows="full"``, ``topk="stream"``)
  against JAX's ``_search_dense_halo`` to the f32 rounding of the
  distances; with the whole frame as the tile it is bitwise the port's own
  mask-border dense search;
* ``proc_nl_halo`` in gloo worlds of 2 and 4 ranks (``run_world``, one
  thread per rank), with zero flow at stages 0 and 1 and with a flow at
  nwt 1: within tests/test_halo.py's bounds of the port's single-device
  ``proc_nl`` (mask borders), and against JAX's ``proc_nl_halo`` on the
  8-device CPU mesh within the port-vs-JAX bounds of the single-device
  pass (tests/test_torch_pipeline.py: 0.02 dB, mean |d| < 0.25; on this
  clip the two single-device passes differ by up to 1.05 gray levels at
  stage 0, bf16 near-ties of the needle levels, while the port's halo and
  single-device passes differ by 6e-5); the all-rows branch within
  tests/test_halo.py's bound of JAX's ``proc_nl_halo``; the refusal of
  strips shorter than the halo;
* ``strip_runner`` + ``combine_strips`` bitwise against the mesh program for
  the ``small``, ``coarse2`` and ``stream`` geometries of
  tests/test_halo.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vnlb_tpu.config as jcfg
import vnlb_tpu_torch as vt
from vnlb_tpu.ops import pallas_smat as sm
from vnlb_tpu.ops.search import _avg_pool2 as j_pool
from vnlb_tpu.ops.search_dense import exec_search_dense_tile as j_tile_search
from vnlb_tpu.parallel.halo import _search_dense_halo as j_search_dense_halo
from vnlb_tpu.parallel.halo import proc_nl_halo as j_proc_nl_halo
from vnlb_tpu.parallel.tiled import make_mesh as j_make_mesh
from vnlb_tpu.pipeline import proc_nl as j_proc_nl

from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops.mask import lattice_sites
from vnlb_tpu_torch.ops.patch_dist import (patch_dist_plain,
                                           patch_dist_tile_plain, tile_oob)
from vnlb_tpu_torch.ops.search import search_levels
from vnlb_tpu_torch.ops.search_dense import (exec_search_dense,
                                             exec_search_dense_tile,
                                             tile_search_mode)
from vnlb_tpu_torch.parallel.comm import Mesh
from vnlb_tpu_torch.parallel.halo import (combine_strips, proc_nl_halo,
                                          proc_nl_strip_single)
from vnlb_tpu_torch.parallel.launch import run_world, sequence
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)


def _phases(shape, cfg):
    end_t = shape[0] - cfg.pt + 1
    return tuple((f % cfg.step_s) if f < end_t - 1 else 0
                 for f in range(end_t))


def _mk(seed, t, h, w):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (t, 3, h, w)).astype(np.float32)


def _assert_close(got, want):
    """tests/test_halo.py's bound: near-tie top-K swaps only."""
    diff = np.abs(got - want)
    assert diff.max() < 0.5, diff.max()
    assert diff.mean() < 0.02, diff.mean()


def _near_jax(got, want, clean):
    """tests/test_torch_pipeline.py's port-vs-JAX bound of a pass."""
    dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
    assert dpsnr < 0.02, dpsnr
    assert np.abs(got - want).mean() < 0.25


def _single(noisy, basic, flows, cfg):
    """The port's single-device pass on the CPU."""
    ff, bf = flows
    return vt.proc_nl(torch.from_numpy(noisy),
                      None if basic is None else torch.from_numpy(basic),
                      None, ff, bf, cfg).numpy()


def _match(va, ia, vb, ib, vtol):
    """Values agree to vtol; where indices differ the values are ties."""
    assert np.array_equal(np.isfinite(va), np.isfinite(vb))
    fin = np.isfinite(va)
    err = np.abs(va - vb)
    assert (err[fin] <= vtol[fin]).all(), (err - vtol)[fin].max()
    diff = (ia != ib) & fin
    assert (err[diff] <= vtol[diff]).all()
    return diff.mean()


def test_tile_plain_matches_pallas_interpret():
    """tests/test_search_strided.py:261's geometry: strip [16, 32) of a
    64x44 clip, dt=1, stage 0.  At the candidates in bounds of both, the
    plain tile entry matches the bf16 selection-matmul kernel to 1%."""
    rng = np.random.default_rng(21)
    t, h, w = 3, 64, 44
    video = rng.uniform(0, 255, (t, 3, h, w)).astype(np.float32)
    jc = jcfg.default_config(20.0, preset="iphone").stage(0).replace(
        nwt_b=1, nwt_f=1, border_mode="mask")
    ps, w_s, step = jc.ps, jc.w_s, jc.step_s
    qrow0 = _phases(video.shape, jc)
    hp_g = h - ps + 1
    halo = (w_s - 1) // 2 + ps - 1
    hs, r0 = 16, 16
    base_row = r0 - halo
    tile = video[:, :, base_row:r0 + hs + halo, :]
    h_t = tile.shape[2]
    hp_t, wp = h_t - ps + 1, w - ps + 1
    gmax, _, rowpad, _, ncpad = sm.tile_smat_layout(hp_t, wp, step)
    f_cnt = t - jc.pt + 1
    vc = tile[:, :jc.dist_chnls]
    vq = jnp.concatenate([jnp.asarray(vc[f:f + f_cnt])
                          for f in range(jc.pt)], axis=1)
    sy = sm.build_row_select_tile(qrow0, jnp.int32(base_row), hp_t, hp_g,
                                  step, ps, -(-h_t // 128) * 128, gmax,
                                  rowpad)
    dt = 1
    vd = jnp.concatenate([jnp.asarray(np.roll(vc, -dt, axis=0)[f:f + f_cnt])
                          for f in range(jc.pt)], axis=1)
    a = np.asarray(sm.smat_distances_dt_tile(vq, vd, sy, ps, w_s, step, gmax,
                                             rowpad, ncpad, interpret=True))

    sites = lattice_sites(video.shape, config_from_jax(jc))
    s_g = sites[(sites[:, 1] >= r0) & (sites[:, 1] < r0 + hs)]
    s_l = s_g.copy()
    s_l[:, 1] -= base_row
    rows = np.asarray(sm.site_rows_smat_tile(
        jnp.asarray(s_l), jnp.asarray(s_g[:, 1]), qrow0, step, hp_g, gmax,
        rowpad, ncpad))
    want = a.transpose(0, 2, 3, 1).reshape(-1, w_s * w_s)[rows]
    st = torch.from_numpy(s_l).long()
    got = patch_dist_tile_plain(torch.from_numpy(np.ascontiguousarray(vc)),
                                st[:, 0], st[:, 1], st[:, 2], dt, 1, jc.pt,
                                ps, w_s, base_row, hp_g, wp)[0].numpy()
    # JAX's rolled frame wraps past the clip: only sites whose frame t+dt
    # exists, and candidates inside the tile
    half = (w_s - 1) // 2
    d = np.arange(w_s)
    cy = s_l[:, 1, None, None] - half + d[None, :, None]
    cx = s_l[:, 2, None, None] - half + d[None, None, :]
    ok = ((cy >= 0) & (cy <= hp_t - 1) & (cx >= 0)
          & (cx <= wp - 1)).reshape(-1, w_s * w_s)
    ok &= (s_l[:, 0] + dt <= t - jc.pt)[:, None]
    assert ok.mean() > 0.5
    assert np.isfinite(got[ok]).all()
    scale = np.abs(want[ok]).max()
    assert np.abs(got[ok] - want[ok]).max() / scale < 0.01


def _offset_strip(stype, **kw):
    """The offset strips of tests/test_search_strided.py:92-202: strip
    [24, 48) of a 72x52 clip (l2), strip [48, 72) of a 96x64 clip with
    full-frame needle levels.  Returns (tile, tile sites, global rows,
    base_row, hp_g, JAX config, JAX's and the port's coarse levels)."""
    if stype == "l2":
        h, w, seed, r0, halo_even = 72, 52, 13, 24, False
    else:
        h, w, seed, r0, halo_even = 96, 64, 17, 48, True
    t, hs = 4, 24
    video = _mk(seed, t, h, w)
    jc = jcfg.default_config(20.0, preset="iphone").stage(0).replace(
        nwt_b=2, nwt_f=2, npatches=16, stype=stype, border_mode="mask", **kw)
    tc = config_from_jax(jc)
    halo = (jc.w_s - 1) // 2 + jc.ps - 1
    halo += halo % 2 if halo_even else 0
    base_row = r0 - halo
    tile = video[:, :, base_row:r0 + hs + halo, :]
    sites = lattice_sites(video.shape, tc)
    s_g = sites[(sites[:, 1] >= r0) & (sites[:, 1] < r0 + hs)]
    s_l = s_g.copy()
    s_l[:, 1] -= base_row
    j_coarse, cur = [], jnp.asarray(video)
    if stype == "needle":
        r = jc.w_s + jc.ps - 1
        for _ in range(1, jc.needle_scales):
            cur = j_pool(cur)
            if cur.shape[2] < r or cur.shape[3] < r:
                break
            j_coarse.append(cur)
        assert j_coarse
    t_coarse = search_levels(torch.from_numpy(video), tc)[1:]
    assert len(t_coarse) == len(j_coarse)
    return (tile, s_l, s_g[:, 1], base_row, h - jc.ps + 1, jc, j_coarse,
            t_coarse)


def _port_tile_search(tile, s_l, gy, base_row, hp_g, jc, t_coarse):
    tv, ti = exec_search_dense_tile(torch.from_numpy(tile),
                                    torch.from_numpy(s_l),
                                    torch.from_numpy(gy),
                                    config_from_jax(jc), base_row, hp_g,
                                    t_coarse)
    assert ti.dtype == torch.int32
    return tv.numpy(), ti.numpy()


@pytest.mark.parametrize("stype", ["l2", "needle"])
def test_tile_search_offset_strip_matches_jax(stype):
    """The lattice-row tile search (K1's tile entry at level 0)."""
    tile, s_l, gy, base_row, hp_g, jc, j_coarse, t_coarse = _offset_strip(
        stype)
    jv, ji = j_tile_search(jnp.asarray(tile), jnp.asarray(s_l),
                           jnp.asarray(gy), jc, _phases(tile.shape, jc),
                           jnp.int32(base_row), hp_g, tuple(j_coarse))
    tv, ti = _port_tile_search(tile, s_l, gy, base_row, hp_g, jc, t_coarse)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.shape == jv.shape
    vtol = (1 + len(t_coarse)) * 2.0 ** -7 * (np.abs(jv) + jc.offset) + 1e-7
    assert _match(tv, ti, jv, ji, vtol) < 0.05


@pytest.mark.parametrize("stype,mode", [
    ("l2", dict(dense_rows="full")), ("needle", dict(topk="stream"))],
    ids=["l2-full", "needle-stream"])
def test_tile_search_all_rows_matches_jax(stype, mode):
    """The all-rows tile search (``tile_search_mode`` "full": K3 planes of
    the tile and of the coarse levels, no bf16 rounding) against JAX's
    ``_search_dense_halo`` on the same strip.  With no bf16 rounding on
    either side the values differ by the f32 rounding of the distances
    only: |d| <= 1e-5 (q2 + b2) + 1e-3 per level in raw units
    (tests/test_torch_dense_full.py), and (q2 + b2) / norm <= 2 for pixels
    in [0, 255]."""
    tile, s_l, gy, base_row, hp_g, jc, j_coarse, t_coarse = _offset_strip(
        stype, **mode)
    assert tile_search_mode(config_from_jax(jc)) == "full"
    jv, ji = j_search_dense_halo(jnp.asarray(tile), tuple(j_coarse),
                                 jnp.asarray(s_l), jnp.asarray(gy), jc,
                                 -base_row, hp_g - 1 - base_row)
    tv, ti = _port_tile_search(tile, s_l, gy, base_row, hp_g, jc, t_coarse)
    jv, ji = np.asarray(jv), np.asarray(ji)
    norm = jc.pt * jc.dist_chnls * jc.ps ** 2 * 255.0 ** 2
    vtol = np.full(jv.shape, (1 + len(t_coarse)) * (2e-5 + 1e-3 / norm),
                   np.float32)
    assert _match(tv, ti, jv, ji, vtol) < 0.05


@pytest.mark.parametrize("stype,stage", [("l2", 0), ("needle", 0),
                                         ("l2", 1)])
def test_tile_search_whole_frame_bitwise(stype, stage):
    """With the whole frame as the tile (base_row 0), the tile entry is K1
    with the mask-border +inf, and the tile search is the port's dense
    search under border_mode="mask", bit for bit."""
    video = torch.from_numpy(_mk(7 + stage, 4, 48, 52))
    jc = jcfg.default_config(20.0, preset="iphone").stage(stage).replace(
        nwt_b=2, nwt_f=2, npatches=20, stype=stype, border_mode="mask")
    tc = config_from_jax(jc)
    sites = torch.from_numpy(lattice_sites(video.shape, tc))
    levels = search_levels(video, tc)
    hp_g, wp = 48 - tc.ps + 1, 52 - tc.ps + 1
    args = (levels[0], sites[:, 0], sites[:, 1], sites[:, 2], -2, 5, tc.pt,
            tc.ps, tc.w_s)
    tile_raw = patch_dist_tile_plain(*args, 0, hp_g, wp)
    bad = tile_oob(sites[:, 1], sites[:, 2], tc.w_s, 0, hp_g, wp)
    want_raw = patch_dist_plain(*args).masked_fill(bad[None], float("inf"))
    assert torch.equal(tile_raw, want_raw)
    gv, gi = exec_search_dense(video, sites, tc, levels=levels)
    tv, ti = exec_search_dense_tile(video, sites, sites[:, 1], tc, 0, hp_g,
                                    levels[1:])
    assert torch.equal(tv, gv) and torch.equal(ti, gi)


@pytest.fixture(scope="module")
def clip():
    """tests/test_halo.py's clip: H=56 in 4 strips of 14 rows (halo 14)."""
    clean = synthetic_video(3, 56, 56, seed=5)
    noisy = add_noise(clean, 20.0, seed=6)
    return noisy, np.zeros((3, 2, 56, 56), np.float32), clean


def _jcfg(stage, **kw):
    return jcfg.default_config(20.0, preset="iphone").stage(stage).replace(
        border_mode="mask", bsize=32, **kw)


def _flow(noisy):
    """tests/test_halo.py:86's smooth vertical flow, |v| <= 1.2."""
    t, _, h, w = noisy.shape
    v = 1.2 * np.sin(np.linspace(0, 2 * np.pi, h, dtype=np.float32))
    fflow = np.zeros((t, 2, h, w), np.float32)
    fflow[:, 1] = v[None, :, None]
    return fflow, -fflow


@pytest.fixture(scope="module")
def coarse2():
    """(3, 88, 86): strips of 24 rows build two needle levels of odd pooled
    width 43."""
    return add_noise(synthetic_video(3, 88, 86, seed=15), 20.0, seed=16)


@pytest.fixture(scope="module")
def jax_basic(clip):
    noisy, zf, _ = clip
    return np.asarray(j_proc_nl(noisy, None, None, zf, zf, _jcfg(0)))


@pytest.fixture(scope="module")
def worlds(clip, coarse2, jax_basic):
    """The port's mesh programs, one gloo world per size: {(n, name):
    output of rank 0} plus every rank's zero-flow stage-0 output and every
    call's kernel launches."""
    noisy = clip[0]
    c0, c1 = config_from_jax(_jcfg(0)), config_from_jax(_jcfg(1))
    flow_cfg = config_from_jax(jcfg.default_config(
        20.0, preset="iphone", nwt_f=[1, 1], nwt_b=[1, 1]).stage(0))
    calls = {
        2: [("s0", (noisy, None, None, None, c0)),
            ("s1", (noisy, jax_basic, None, None, c1)),
            ("flow", (noisy, None) + _flow(noisy) + (flow_cfg,)),
            ("full", (noisy, None, None, None,
                      c0.replace(dense_rows="full")))],
        4: [("s0", (noisy, None, None, None, c0)),
            ("s1", (noisy, jax_basic, None, None, c1)),
            ("coarse2", (coarse2, None, None, None, c0)),
            ("stream", (noisy, None, None, None, c0.replace(topk="stream")))],
    }
    out = {}
    for n, named in calls.items():
        ranks = run_world(sequence, n, device="cpu", threads=1, args=(
            [(proc_nl_halo, a, {}) for _, a in named],))
        for i, (name, _) in enumerate(named):
            out[n, name] = ranks[0][i][0]
        out[n, "ranks"] = [r[0][0] for r in ranks]
        out[n, "launches"] = [c[2] for r in ranks for c in r]
    return out


@pytest.mark.parametrize("ndev,stage", [(2, 0), (4, 0), (4, 1)])
def test_halo_matches_jax(clip, jax_basic, worlds, ndev, stage):
    noisy, zf, clean = clip
    basic = None if stage == 0 else jax_basic
    want = np.asarray(j_proc_nl_halo(noisy, basic, zf, zf, _jcfg(stage),
                                     j_make_mesh(ndev, axis="h")))
    got = worlds[ndev, f"s{stage}"]
    assert got.shape == noisy.shape and np.isfinite(got).all()
    _assert_close(got, _single(noisy, basic, (None, None),
                               config_from_jax(_jcfg(stage))))
    _near_jax(got, want, clean)


@pytest.mark.parametrize("ndev,mode", [(4, "stream"), (2, "full")])
def test_halo_all_rows_matches_jax(clip, worlds, ndev, mode):
    """The all-rows tile branch (K3 planes of the tile, no bf16 rounding,
    as JAX's ``_search_dense_halo``) that ``topk="stream"`` and
    ``dense_rows="full"`` take: within tests/test_halo.py's bound of JAX's
    ``proc_nl_halo`` with the same setting and of the port's one-device
    pass with ``search_bf16=False``."""
    noisy, zf, clean = clip
    jc = _jcfg(0).replace(**{"stream": dict(topk="stream"),
                             "full": dict(dense_rows="full")}[mode])
    want = np.asarray(j_proc_nl_halo(noisy, None, zf, zf, jc,
                                     j_make_mesh(ndev, axis="h")))
    got = worlds[ndev, mode]
    _assert_close(got, want)
    # the same search with no bf16 rounding on one device; the rounded
    # single-device pass moves near-ties (mean |d| 0.045 here) at the
    # same PSNR
    tc = config_from_jax(jc)
    _assert_close(got, _single(noisy, None, (None, None),
                               tc.replace(search_bf16=False)))
    _near_jax(got, _single(noisy, None, (None, None), tc), clean)


def test_halo_ranks_agree(worlds):
    """Every rank returns the whole output, the same bits."""
    for n in (2, 4):
        first = worlds[n, "ranks"][0]
        assert all(np.array_equal(r, first) for r in worlds[n, "ranks"])


def test_sequence_counts_launches_per_call(worlds):
    """``launch.sequence`` reports each call's launches of every kernel
    wrapper; on the CPU the wrappers take the plain versions and launch
    nothing."""
    names = {k.__name__ for k in vt.KERNELS}
    for n in (2, 4):
        assert worlds[n, "launches"]
        for launches in worlds[n, "launches"]:
            assert set(launches) == names and not any(launches.values())


def test_halo_with_flow_matches_jax(clip, worlds):
    """A nonzero flow widens the halo (margin ceil(1 * 1.2) = 2) and takes
    the gather search with the global row bounds."""
    noisy, _, clean = clip
    jc = jcfg.default_config(20.0, preset="iphone", nwt_f=[1, 1],
                             nwt_b=[1, 1]).stage(0).replace(bsize=32)
    want = np.asarray(j_proc_nl_halo(noisy, None, *_flow(noisy), jc,
                                     j_make_mesh(2, axis="h")))
    got = worlds[2, "flow"]
    _assert_close(got, _single(noisy, None, _flow(noisy),
                               config_from_jax(jc)))
    _near_jax(got, want, clean)


def test_halo_refuses_strips_below_halo(clip):
    """8 strips of 7 rows < halo 14: refused before any communication."""
    noisy = clip[0]
    mesh = Mesh(None, 0, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="strip"):
        proc_nl_halo(noisy, None, None, None, config_from_jax(_jcfg(0)), mesh)


def test_run_world_raises_when_a_rank_raises(clip):
    noisy = clip[0]
    with pytest.raises(Exception, match="strip"):
        run_world(proc_nl_halo, 2, device="cpu", threads=1,
                  args=(noisy[:, :, :20], None, None, None,
                        config_from_jax(_jcfg(0))))


@pytest.mark.parametrize("geom", ["small", "coarse2", "stream"])
def test_strip_runner_bitwise_mesh(clip, coarse2, worlds, geom):
    """The one-device strip runner and the 4-rank mesh run the same
    per-strip program; their outputs are bitwise equal.  The composition
    runs at the ranks' one thread: the CPU's batched products in the plain
    filters round differently with the thread count."""
    noisy = coarse2 if geom == "coarse2" else clip[0]
    cfg = config_from_jax(_jcfg(0))
    if geom == "stream":
        cfg = cfg.replace(topk="stream")
    tiles, meta = [], None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in range(4):
            deno, wts, meta = proc_nl_strip_single(noisy, None, cfg, 4, i,
                                                   device="cpu")
            tiles.append((deno, wts))
        got = combine_strips(tiles, cfg, noisy, None, meta).numpy()
    finally:
        torch.set_num_threads(threads)
    want = worlds[4, "s0" if geom == "small" else geom]
    np.testing.assert_array_equal(got, want)
