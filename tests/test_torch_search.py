"""Search parity of the PyTorch port against the JAX package on the CPU.

* the plain K1 distances (ops/patch_dist.patch_dist_plain) against the JAX
  dense candidate planes (search_dense._level_dense) at pyramid levels
  0/1/2, at every in-bounds candidate, to f32 rounding;
* exec_search_dense on a (5, 96, 112) clip for both passes against the
  JAX strided path the pipeline runs: values to one bf16 ulp, indices
  differ only at value ties (protocol of tests/test_search_strided.py);
* a crafted all-ties input pins the earliest-position-first order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import vnlb_tpu.config as jcfg
from vnlb_tpu.ops.search import _avg_pool2 as j_pool
from vnlb_tpu.ops.search_dense import _level_dense, _site_rows
from vnlb_tpu.ops.search_dense import exec_search_dense as j_search

from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops.mask import lattice_sites
from vnlb_tpu_torch.ops.patch_dist import patch_dist, patch_dist_plain
from vnlb_tpu_torch.ops.search import _avg_pool2 as t_pool
from vnlb_tpu_torch.ops.search_dense import (exec_search_dense,
                                             level_queries, search_levels)
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video

torch.set_num_threads(2)


def _phases(shape, cfg):
    end_t = shape[0] - cfg.pt + 1
    return tuple((f % cfg.step_s) if f < end_t - 1 else 0
                 for f in range(end_t))


def _cfg(stage, **kw):
    return jcfg.default_config(20.0, preset="iphone", step_s=6,
                               border_mode="mask", **kw).stage(stage)


@pytest.mark.parametrize("stage,lvl", [(0, 0), (0, 1), (0, 2), (1, 0)])
def test_plain_distances_match_jax_planes(stage, lvl):
    jc = _cfg(stage, needle_scales=3)
    clip = add_noise(synthetic_video(4, 128, 136, seed=2), 20.0, seed=3)
    vid = clip[:, :jc.dist_chnls]
    for _ in range(lvl):
        tv = t_pool(torch.from_numpy(np.array(vid)))
        vid = np.asarray(j_pool(jnp.asarray(vid)))
    t_len, _, h_l, w_l = vid.shape
    ps, pt, w_s = jc.ps, jc.pt, jc.w_s
    half = (w_s - 1) // 2
    hp, wp = h_l - ps + 1, w_l - ps + 1
    sites = lattice_sites((t_len, 3, 128, 136), config_from_jax(jc))
    sites = sites[::7]
    tc = config_from_jax(jc)
    qt, qy, qx = level_queries(torch.from_numpy(sites).long(), lvl, h_l, w_l,
                               tc)
    got = patch_dist_plain(torch.from_numpy(np.array(vid)),
                           qt, qy, qx, -2, 5, pt, ps, w_s).numpy()
    per_dt = _level_dense(jnp.asarray(vid), jc.replace(dense_impl="xla"))
    rows = np.asarray(_site_rows(jnp.asarray(sites), 1 << lvl, hp, wp, h_l,
                                 w_l, ps, half))
    scale = float(np.abs(vid).max()) ** 2 * pt * jc.dist_chnls * ps * ps
    for di, dt in enumerate(range(-2, 3)):
        planes = np.asarray(per_dt(dt))                    # (ws2, F, H', W')
        want = planes.reshape(w_s * w_s, -1)[:, rows].T    # (S, ws2)
        a = np.arange(w_s)
        cy = qy.numpy()[:, None, None] - half + a[None, :, None]
        cx = qx.numpy()[:, None, None] - half + a[None, None, :]
        ft = sites[:, 0] + dt
        ok = ((cy >= 0) & (cy <= h_l - ps) & (cx >= 0) & (cx <= w_l - ps)
              & ((ft >= 0) & (ft <= t_len - pt))[:, None, None])
        ok = ok.reshape(len(sites), -1)
        assert ok.sum() > 0
        # q2 + b2 - 2 cross (JAX) vs sum of squares (port): f32 rounding
        # of terms up to ``scale``
        np.testing.assert_allclose(got[di][ok], want[ok], rtol=0,
                                   atol=2e-6 * scale)
    if lvl:
        np.testing.assert_allclose(tv.numpy(), vid, rtol=0, atol=1e-4)


def _match(va, ia, vb, ib, vtol):
    """Sorted values agree to vtol elementwise; where top-K indices differ
    the two values must be ties at that tolerance."""
    err = np.abs(va - vb)
    finite = np.isfinite(va) & np.isfinite(vb)
    assert np.array_equal(np.isfinite(va), np.isfinite(vb))
    assert (err[finite] <= vtol[finite]).all(), (err - vtol)[finite].max()
    diff = ia != ib
    assert (err[diff & finite] <= vtol[diff & finite]).all()
    return diff.mean()


@pytest.mark.parametrize("stage", [0, 1])
def test_exec_search_dense_matches_jax(stage):
    jc = _cfg(stage)
    tc = config_from_jax(jc)
    clip = add_noise(synthetic_video(5, 96, 112, seed=0), 20.0, seed=1)
    sites = lattice_sites(clip.shape, tc)
    jv, ji = j_search(jnp.asarray(clip), jnp.asarray(sites), jc,
                      qrow0=_phases(clip.shape, jc))
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = exec_search_dense(torch.from_numpy(clip),
                               torch.from_numpy(sites), tc)
    tv, ti = tv.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and tv.shape == jv.shape
    # one bf16 ulp (at most 2^-7 relative) of each pyramid level's term;
    # the level terms are positive, so their sum bounds each
    nlev = len(search_levels(torch.from_numpy(clip), tc))
    vtol = nlev * 2.0 ** -7 * (np.abs(jv) + tc.offset) + 1e-7
    frac = _match(tv, ti, jv, ji, vtol)
    assert frac < 0.02, frac


def test_ties_earliest_position_first():
    """A constant clip makes every in-bounds candidate a tie: the top-K
    must be the first K in (dt, dy, dx) order, as JAX lists them."""
    jc = _cfg(0, npatches=40, nwt_b=2, nwt_f=2)
    tc = config_from_jax(jc)
    clip = np.full((4, 3, 40, 44), 77.0, np.float32)
    sites = lattice_sites(clip.shape, tc)
    jv, ji = j_search(jnp.asarray(clip), jnp.asarray(sites), jc,
                      qrow0=_phases(clip.shape, jc))
    tv, ti = exec_search_dense(torch.from_numpy(clip),
                               torch.from_numpy(sites), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # explicit expectation for one interior and one corner site
    t_len, c, h, w = clip.shape
    half = (tc.w_s - 1) // 2
    for s in (len(sites) // 2, 0):
        t, y, x = sites[s]
        want = []
        for dt in range(-2, 3):
            if not 0 <= t + dt <= t_len - tc.pt:
                continue
            for a in range(tc.w_s):
                for b in range(tc.w_s):
                    yy, xx = y - half + a, x - half + b
                    if 0 <= yy <= h - tc.ps and 0 <= xx <= w - tc.ps:
                        want.append((t + dt) * c * h * w + yy * w + xx)
        np.testing.assert_array_equal(ti.numpy()[s], want[:tc.npatches])


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    vid = torch.from_numpy(rng.uniform(0, 255, (3, 2, 30, 31))
                           .astype(np.float32))
    q = [torch.tensor(v, dtype=torch.int32) for v in ([0, 1, 2], [0, 9, 23],
                                                       [24, 3, 11])]
    before = patch_dist.launches
    a = patch_dist(vid, *q, -1, 3, 1, 7, 15)
    b = patch_dist_plain(vid, *q, -1, 3, 1, 7, 15)
    assert torch.equal(a, b) and a.shape == (3, 3, 225)
    assert patch_dist.launches == before
    with pytest.raises(ValueError):
        patch_dist(vid.to(torch.float64), *q, -1, 3, 1, 7, 15)

