"""The port's ops on the CPU against the port's copy of the NumPy oracle
(vnlb_tpu_torch/testing/npref.py), at the tolerances of tests/test_npref.py:
colour, lattice, flat areas, the Bayes filter (eig_method="xla") at both
steps, the pixel scatter and the row scatter + fold, and the pass epilogue.
The port's rows are c-major (B, K, c, pt*ps*ps); the oracle takes (B, K,
pt, c, ps, ps).  Last, each function of the copy returns what
``vnlb_tpu.testing.npref`` returns, bitwise."""

import numpy as np
import pytest
import torch

from vnlb_tpu.testing import npref as jnpref

from vnlb_tpu_torch.config import default_config
from vnlb_tpu_torch.ops import agg, color, flat
from vnlb_tpu_torch.ops.bayes import bayes_denoise
from vnlb_tpu_torch.ops.gather import inds_to_rows
from vnlb_tpu_torch.ops.mask import lattice_mask
from vnlb_tpu_torch.pipeline import PLAIN
from vnlb_tpu_torch.testing import npref

torch.set_num_threads(2)


def _cfg(step, sigma=20.0, **kw):
    return default_config(sigma, preset="default", **kw).stage(step)


def _rows(p):
    """(B, K, pt, c, ps, ps) -> the port's c-major (B, K, c, pt*ps*ps)."""
    b, k, pt, c, ps, _ = p.shape
    return torch.from_numpy(np.ascontiguousarray(p)).permute(
        0, 1, 3, 2, 4, 5).reshape(b, k, c, -1)


def test_color_roundtrip_matches_reference(rng):
    video = rng.uniform(0, 255, (3, 3, 16, 16)).astype(np.float32)
    got = color.rgb2yuv(torch.from_numpy(video))
    want = npref.rgb2yuv(video.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)

    back = color.yuv2rgb(got).numpy()
    want_back = npref.yuv2rgb(want)
    np.testing.assert_allclose(back, want_back, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(back, video, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape,step_s", [((4, 3, 40, 52), 3),
                                          ((2, 3, 21, 33), 5),
                                          ((3, 3, 64, 64), 7)])
def test_lattice_mask_matches_reference(shape, step_s):
    for step in (0, 1):
        cfg = _cfg(step, step_s=step_s)
        got = lattice_mask(shape, cfg)
        want = npref.fill_mask(shape, cfg.ps, cfg.pt, cfg.w_s, cfg.n_dt,
                               cfg.step_s)
        np.testing.assert_array_equal(got, want)


def test_flat_areas_matches_reference(rng):
    cfg = _cfg(1)
    p = rng.normal(128, 4.0, (32, 60, cfg.pt, 3, cfg.ps, cfg.ps)) \
        .astype(np.float32)
    # make half the groups high-variance (non-flat)
    p[16:] += rng.normal(0, 40.0, p[16:].shape).astype(np.float32)
    got = flat.flat_areas(_rows(p), cfg.gamma, cfg.sigma2).numpy()
    want = npref.flat_areas(p.astype(np.float64), cfg.gamma, cfg.sigma2)
    np.testing.assert_array_equal(got, want)
    assert got[:16].all() and not got[16:].any()


@pytest.mark.parametrize("step", [0, 1])
def test_bayes_matches_reference(rng, step):
    cfg = _cfg(step, eig_method="xla")
    b, k = 6, cfg.npatches
    base = rng.normal(0, 12.0, (b, 1, cfg.pt, 3, cfg.ps, cfg.ps))
    pbasic = (base + rng.normal(0, 2.0, (b, k, cfg.pt, 3, cfg.ps, cfg.ps))) \
        .astype(np.float32) + 120.0
    pnoisy = (pbasic + rng.normal(0, cfg.sigma,
                                  pbasic.shape).astype(np.float32))
    if step == 1:
        fl = np.zeros((b,), bool)
        fl[:2] = True
        got, got_rv = bayes_denoise(_rows(pnoisy), _rows(pbasic),
                                    torch.from_numpy(fl), cfg)
        want, want_rv = npref.bayes_denoise(
            pnoisy, pbasic, fl, step=1, sigma2=cfg.sigma2,
            sigmab2=cfg.sigmab2, rank=cfg.rank, thresh=cfg.thresh,
            cpatches=cfg.cpatches)
    else:
        got, got_rv = bayes_denoise(_rows(pnoisy), None, None, cfg)
        want, want_rv = npref.bayes_denoise(
            pnoisy, None, None, step=0, sigma2=cfg.sigma2,
            sigmab2=cfg.sigmab2, rank=cfg.rank, thresh=cfg.thresh)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3 * scale)
    np.testing.assert_allclose(got_rv.numpy(), want_rv, rtol=1e-3)


def test_agg_matches_reference(rng):
    shape = (3, 3, 24, 28)
    t_len, c, h, w = shape
    cfg = _cfg(0)
    ps, pt = cfg.ps, cfg.pt
    b, k = 8, 10
    chw, hw = c * h * w, h * w

    f = rng.integers(0, t_len - pt + 1, (b, k))
    y = rng.integers(0, h - ps + 1, (b, k))
    x = rng.integers(0, w - ps + 1, (b, k))
    inds = (f * chw + y * w + x).astype(np.int32)
    inds[0, :3] = -1                              # some invalid entries
    patches = rng.normal(0, 1, (b, k, pt, c, ps, ps)).astype(np.float32)

    # oracle
    deno_ref = np.zeros((t_len, c, h, w), np.float64)
    wts_ref = np.zeros((t_len, h, w), np.float64)
    npref.agg_patches(deno_ref, wts_ref, patches.astype(np.float64), inds,
                      ps, pt)

    # the pixel scatter (the reference-order pass)
    deno0 = torch.zeros((t_len * hw, c))
    wts0 = torch.zeros((t_len * hw,))
    valid = torch.ones((b, k), dtype=torch.bool)
    inds_t = torch.from_numpy(inds)
    deno1, wts1 = agg.agg_patches(deno0, wts0, torch.from_numpy(patches),
                                  inds_t, valid, pt, ps, shape)
    got = deno1.numpy().reshape(t_len, h, w, c).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, deno_ref, atol=1e-4)
    np.testing.assert_allclose(wts1.numpy().reshape(t_len, h, w), wts_ref,
                               atol=1e-5)

    # the row scatter + fold (the pipeline's path)
    hp, wp = h - ps + 1, w - ps + 1
    d = c * ps * ps
    rows = inds_to_rows(inds_t, shape, ps, pt)
    acc0 = torch.zeros((t_len * hp * wp, pt * d + 1))
    acc = agg.agg_rows(acc0, torch.from_numpy(patches), rows[:, :, 0],
                       valid & (inds_t >= 0), PLAIN.scatter_rows)
    deno2, wts2 = agg.fold(acc, pt, ps, shape)
    np.testing.assert_allclose(deno2.numpy(), deno_ref, atol=1e-4)
    np.testing.assert_allclose(wts2.numpy(), wts_ref, atol=1e-5)


def test_finalize_matches_reference(rng):
    shape = (2, 3, 8, 8)
    t_len, c, h, w = shape
    deno = rng.normal(0, 1, shape).astype(np.float32)
    wts = rng.integers(0, 3, (t_len, h, w)).astype(np.float32)
    fallback = rng.normal(0, 1, shape).astype(np.float32)
    got = agg.finalize_img(torch.from_numpy(deno), torch.from_numpy(wts),
                           torch.from_numpy(fallback)).numpy()
    want = npref.finalize(deno.astype(np.float64), wts.astype(np.float64),
                          fallback.astype(np.float64))
    np.testing.assert_allclose(got, want, atol=1e-5)


def _agg_call(mod, r):
    shape = (3, 3, 16, 18)
    b, k, pt, ps = 5, 7, 2, 5
    inds = (r.integers(0, 2, (b, k)) * 3 * 16 * 18
            + r.integers(0, 12, (b, k)) * 18
            + r.integers(0, 14, (b, k))).astype(np.int32)
    inds[1, :2] = -1
    deno = np.zeros((shape[0],) + shape[1:], np.float64)
    wts = np.zeros((shape[0],) + shape[2:], np.float64)
    mod.agg_patches(deno, wts, r.normal(0, 1, (b, k, pt, 3, ps, ps)), inds,
                    ps, pt)
    return deno, wts


def _bayes_call(mod, r, step):
    pnoisy = r.normal(100, 20, (3, 12, 2, 3, 5, 5))
    pbasic = pnoisy + r.normal(0, 3, pnoisy.shape)
    return mod.bayes_denoise(pnoisy, pbasic if step else None,
                             np.array([True, False, True]), step=step,
                             sigma2=400.0, sigmab2=400.0 * (1 - step),
                             rank=10, thresh=2.7 if step == 0 else 0.7,
                             cpatches="basic" if step else "noisy")


CALLS = {
    "rgb2yuv": lambda m, r: m.rgb2yuv(r.uniform(0, 255, (2, 3, 9, 11))),
    "yuv2rgb": lambda m, r: m.yuv2rgb(r.normal(0, 80, (2, 3, 9, 11))),
    "fill_mask": lambda m, r: m.fill_mask((4, 3, 23, 29), 5, 2, 9, 5, 3),
    "flat_areas": lambda m, r: m.flat_areas(
        r.normal(128, 6, (6, 10, 2, 3, 5, 5)), 0.95, 36.0),
    "bayes_denoise_step0": lambda m, r: _bayes_call(m, r, 0),
    "bayes_denoise_step1": lambda m, r: _bayes_call(m, r, 1),
    "agg_patches": _agg_call,
    "finalize": lambda m, r: m.finalize(
        r.normal(0, 1, (2, 3, 6, 7)),
        r.integers(0, 3, (2, 6, 7)).astype(np.float64),
        r.normal(0, 1, (2, 3, 6, 7))),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_copy_is_the_original(name):
    """On seeded inputs each function of the port's copy returns what
    vnlb_tpu.testing.npref returns, bit for bit."""
    got = CALLS[name](npref, np.random.default_rng(7))
    want = CALLS[name](jnpref, np.random.default_rng(7))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
