"""Flow and gather-search parity of the PyTorch port against the JAX package
on the CPU: flow-tracked centres, sliding window starts, the
interior/border split, flow preparation, the per-site gather search
(``exec_search``), the site plan of every route, and the plain version of
kernel K4 (the patch gather) against the JAX gathers it replaces,
including the Pallas row gather in interpret mode."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import vnlb_tpu.config as jcfg
from vnlb_tpu import api as japi
from vnlb_tpu import pipeline as jpipe
from vnlb_tpu.ops import gather as jgather
from vnlb_tpu.ops import mask as jmask
from vnlb_tpu.ops import search as jsearch
from vnlb_tpu.ops.pallas_gather import gather_rows
from vnlb_tpu.utils import flow_io as jflow

from vnlb_tpu_torch import pipeline
from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops import mask, search
from vnlb_tpu_torch.ops.patch_gather import (patch_gather,
                                             patch_gather_plain)
from vnlb_tpu_torch.utils import flow_io

torch.set_num_threads(2)


def _flows(rng, shape, amp=3.0):
    t_len, _, h, w = shape
    return tuple(rng.uniform(-amp, amp, (t_len, 2, h, w)).astype(np.float32)
                 for _ in range(2))


def _cfg(**kw):
    kw.setdefault("nwt_b", 2)
    kw.setdefault("nwt_f", 2)
    kw.setdefault("npatches", 8)
    kw.setdefault("stype", "l2")
    return jcfg.default_config(20.0, preset="iphone").stage(0).replace(**kw)


def test_track_centers_match_jax():
    rng = np.random.default_rng(8)
    shape = (5, 3, 48, 40)
    ff, bf = _flows(rng, shape)
    sites = np.stack([rng.integers(0, 5, 64), rng.integers(0, 42, 64),
                      rng.integers(0, 34, 64)], axis=1).astype(np.int32)
    sites[:4] = [[0, 0, 0], [4, 41, 33], [2, 0, 33], [3, 41, 0]]
    want = np.asarray(jsearch.track_centers(
        jnp.asarray(sites), jnp.asarray(ff), jnp.asarray(bf), 3, 2, shape))
    got = search.track_centers(torch.from_numpy(sites), torch.from_numpy(ff),
                               torch.from_numpy(bf), 3, 2, shape)
    assert got.dtype == torch.int32 and got.shape == (64, 6, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # the flows moved the centres: the test is not the identity case
    assert (want != sites[:, None, 1:]).any()


def test_track_centers_zero_flow_identity():
    zf = torch.zeros((4, 2, 32, 32))
    sites = torch.tensor([[1, 5, 6], [2, 30, 31], [0, 0, 0]])
    cen = search.track_centers(sites, zf, zf, 2, 2, (4, 3, 32, 32))
    assert cen.shape == (3, 5, 2)
    for i in range(5):
        np.testing.assert_array_equal(cen[:, i].numpy(), sites[:, 1:].numpy())


@pytest.mark.parametrize("h,w", [(48, 40), (20, 19)])
def test_window_starts_and_interior_split_match_jax(h, w):
    rng = np.random.default_rng(h)
    centers = np.stack([rng.integers(-3, h + 3, (50, 5)),
                        rng.integers(-3, w + 3, (50, 5))],
                       axis=-1).astype(np.int32)
    jy, jx = jsearch._window_starts(jnp.asarray(centers), 15, 7, h, w)
    ty, tx = search._window_starts(torch.from_numpy(centers), 15, 7, h, w)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))

    jc = jcfg.default_config(20.0).stage(1)
    shape = (4, 3, h, w)
    sites = jmask.lattice_sites(shape, jc)
    for got, want in zip(mask.interior_split(sites, shape,
                                             config_from_jax(jc)),
                         jmask.interior_split(sites, shape, jc)):
        np.testing.assert_array_equal(got, want)


def _flow_forms(rng, t_len, h, w):
    ff, bf = _flows(rng, (t_len, 2, h, w))
    return {
        "none": None,
        "pair": (ff, bf),
        "dict": {"fflow": ff, "bflow": bf},
        "short": (ff[:-1], bf[1:]),
        "zeros": (np.zeros_like(ff), np.zeros_like(bf)),
    }


@pytest.mark.parametrize("form", ["none", "pair", "dict", "short", "zeros"])
def test_prep_flows_match_jax(form):
    rng = np.random.default_rng(3)
    shape = (5, 3, 12, 14)
    flows = _flow_forms(rng, 5, 12, 14)[form]
    jf, jb, jz = japi._prep_flows(shape, flows)
    tf, tb, tz = pipeline.prep_flows(shape, flows)
    assert tz == jz == (form in ("none", "zeros"))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if form == "short":
        for got, want in zip(flow_io.expand_flows(*flows),
                             jflow.expand_flows(*flows)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(flow_io.expand_flows(flows[0][None],
                                                  flows[1][None], axis=1),
                             jflow.expand_flows(flows[0][None],
                                                flows[1][None], axis=1)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        pipeline.prep_flows((7,) + shape[1:], flows or (np.zeros((5, 2, 12, 14)),
                                                    np.zeros((5, 2, 12, 14))))


def _search_case(case):
    rng = np.random.default_rng({"l2": 8, "needle": 10, "border": 12}[case])
    if case == "l2":
        shape, cfg = (5, 3, 48, 40), _cfg(pt=2, dist_chnls=3, npatches=20)
        sites = np.array([[2, 10, 12], [1, 30, 20], [3, 33, 33], [0, 17, 5]],
                         np.int32)
    elif case == "needle":
        shape, cfg = (3, 3, 64, 64), _cfg(stype="needle", npatches=16)
        sites = np.array([[1, 20, 22], [0, 57, 3], [2, 40, 57], [1, 1, 30]],
                         np.int32)
    else:
        shape = (4, 3, 44, 52)
        cfg = _cfg(stype="needle", dist_chnls=3, npatches=30, nwt_b=3)
        h, w = shape[2] - 7, shape[3] - 7
        sites = np.array([[t, y, x] for t in (0, 3) for y in (0, 3, h // 2,
                                                              h - 2, h)
                          for x in (0, 5, w // 2, w - 1, w)], np.int32)
    video = rng.uniform(0, 255, shape).astype(np.float32)
    ff, bf = _flows(rng, shape)
    return video, sites, ff, bf, cfg


@pytest.mark.parametrize("case", ["l2", "needle", "border"])
def test_exec_search_matches_jax(case):
    video, sites, ff, bf, jc = _search_case(case)
    if case == "needle":
        assert len(search.search_levels(torch.from_numpy(video),
                                        config_from_jax(jc))) == 2
    jv, ji = jsearch.exec_search(jnp.asarray(video), jnp.asarray(sites),
                                 jnp.asarray(ff), jnp.asarray(bf), jc)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = search.exec_search(torch.from_numpy(video),
                                torch.from_numpy(sites), torch.from_numpy(ff),
                                torch.from_numpy(bf), config_from_jax(jc))
    tv, ti = tv.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and tv.shape == jv.shape
    # tolerance of tests/test_search.py against its brute force
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-6)
    # indices equal except where the two values are ties at that tolerance
    diff = ti != ji
    assert diff.mean() < 0.05
    tol = 1e-4 * np.abs(jv) + 1e-6
    for s, k in zip(*np.nonzero(diff)):
        partner = np.nonzero(ji[s] == ti[s, k])[0]
        assert partner.size == 1
        assert abs(jv[s, partner[0]] - tv[s, k]) <= 2 * tol[s, k]


@pytest.mark.parametrize("zero_flow,border_mode", [
    (False, "slide"), (False, "mask"), (True, "slide"), (True, "mask")])
def test_plan_sites_match_jax_order(zero_flow, border_mode):
    jc = jcfg.default_config(20.0, border_mode=border_mode).stage(1)
    shape = (5, 3, 50, 61)
    sb, vb, nb_dense = jpipe.plan_sites(shape, jc, zero_flow)
    want = sb[vb]
    want_dense = int(vb[:nb_dense].sum())
    sites, n_dense = pipeline.plan_sites(shape, config_from_jax(jc),
                                         zero_flow)
    np.testing.assert_array_equal(sites, want)
    assert n_dense == want_dense
    if zero_flow and border_mode == "slide":
        assert 0 < n_dense < len(sites)


def _inds(rng, shape, b, k, pt, ps):
    t_len, c, h, w = shape
    f = rng.integers(0, t_len - pt + 1, (b, k))
    y = rng.integers(0, h - ps + 1, (b, k))
    x = rng.integers(0, w - ps + 1, (b, k))
    inds = (f * c * h * w + y * w + x).astype(np.int32)
    inds[rng.random((b, k)) < 0.1] = -1
    inds[0, :3] = [-1, 0, t_len * c * h * w - 1]
    return inds


def _c_major(p, b, k, pt, c, ps):
    """(B, K, pt, C, ps, ps) -> (B, K, C, pt*ps*ps)."""
    return np.asarray(p).reshape(b, k, pt, c, ps, ps).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, k, c, pt * ps * ps)


@pytest.mark.parametrize("pt,bf16", [(1, True), (2, False), (2, True)])
def test_patch_gather_plain_matches_jax_take_and_pallas(pt, bf16):
    rng = np.random.default_rng(20 + pt)
    shape = (4, 3, 23, 27)
    t_len, c, h, w = shape
    ps, b, k = 7, 9, 11
    video = rng.uniform(0, 255, shape).astype(np.float32)
    inds = _inds(rng, shape, b, k, pt, ps)
    rows = jgather.inds_to_rows(jnp.asarray(inds), shape, ps, pt)
    cols = jgather.im2col_conv(jnp.asarray(video), ps, bf16=bf16)
    cols = np.asarray(cols.astype(jnp.float32)).reshape(-1, c * ps * ps)
    want = _c_major(jgather.fill_patches_cols(jnp.asarray(cols), rows, pt,
                                              ps, c), b, k, pt, c, ps)
    (got,) = patch_gather_plain([torch.from_numpy(video)],
                                torch.from_numpy(inds), ps, pt, bf16)
    np.testing.assert_array_equal(got.numpy(), want)

    # the Pallas row gather (K4 on the TPU), interpret mode, on the
    # lane-padded arena it needs
    d = c * ps * ps
    padded = np.zeros((cols.shape[0], -(-d // 128) * 128), np.float32)
    padded[:, :d] = cols
    pal = gather_rows(jnp.asarray(padded),
                      jnp.asarray(rows).reshape(-1), interpret=True)
    pal = np.asarray(pal)[:, :d].reshape(b, k, pt, c, ps, ps)
    np.testing.assert_array_equal(got.numpy(), _c_major(pal, b, k, pt, c, ps))


@pytest.mark.parametrize("bf16", [False, True])
def test_patch_gather_plain_joint_matches_jax(bf16):
    rng = np.random.default_rng(30)
    shape = (5, 3, 22, 25)
    pt, ps, b, k = 2, 7, 6, 13
    noisy = rng.uniform(0, 255, shape).astype(np.float32)
    basic = rng.uniform(0, 255, shape).astype(np.float32)
    inds = _inds(rng, shape, b, k, pt, ps)
    arena = jgather.arena_conv([jnp.asarray(noisy), jnp.asarray(basic)], ps,
                               pt, bf16=bf16)
    rows = jgather.inds_to_rows(jnp.asarray(inds), shape, ps, pt)
    wn, wb = jgather.fill_patches_cols_joint(arena, rows[:, :, 0], pt, ps, 3)
    gn, gb = patch_gather_plain([torch.from_numpy(noisy),
                                 torch.from_numpy(basic)],
                                torch.from_numpy(inds), ps, pt, bf16)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn, np.float32))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb, np.float32))


def test_patch_gather_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    shape = (3, 3, 15, 16)
    video = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
    inds = torch.from_numpy(_inds(rng, shape, 4, 5, 1, 7))
    before = patch_gather.launches
    (a,) = patch_gather([video], inds, 7, 1, False)
    (b,) = patch_gather_plain([video], inds, 7, 1, False)
    assert torch.equal(a, b) and a.shape == (4, 5, 3, 49)
    assert patch_gather.launches == before
    with pytest.raises(ValueError):
        patch_gather([video, video[:2]], inds, 7, 1, False)
