"""The reference-order pass of the PyTorch port (vnlb_tpu_torch/compat.py)
against vnlb_tpu/compat.py on the CPU.

The mask evolves from the top-K indices, which swap at near-ties, so whole
passes are held by PSNR (within 0.05 dB; measured 0.0006 dB on the
3 x 48 x 48 clip by scripts/torch_cpu_parity.py) and by the sites drawn
(within 5%; measured equal), not bit for bit.  Bits are compared for
``_update_mask`` on given indices and for one batch's mask update given
the same sites; ``agg_patches`` and ``finalize`` to 1e-5; a repeat with
the same seed bitwise."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import vnlb_tpu
import vnlb_tpu.compat as jcompat
from vnlb_tpu.ops import agg as jagg
from vnlb_tpu.ops import color as jcolor
from vnlb_tpu.ops import search as jsearch
from vnlb_tpu.ops.mask import lattice_mask as j_lattice_mask

import vnlb_tpu_torch as vt
import vnlb_tpu_torch.compat as tcompat
from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops import agg, color
from vnlb_tpu_torch.ops.mask import lattice_mask
from vnlb_tpu_torch.ops.search import exec_search
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)

SHAPE = (3, 3, 48, 48)


@pytest.fixture(scope="module")
def clip():
    clean = synthetic_video(3, 48, 48, seed=5)
    return clean, add_noise(clean, 20.0, seed=6)


@pytest.mark.parametrize("boost,nkeep", [(True, -1), (False, -1), (True, 5),
                                         (False, 3), (True, 0)])
def test_update_mask_bitwise(boost, nkeep):
    rng = np.random.default_rng(nkeep + 7)
    t, c, h, w = SHAPE
    inds = rng.integers(0, t * c * h * w, (40, 12)).astype(np.int32)
    inds[3, 4] = -1                 # a group with an invalid match
    valid = rng.uniform(size=40) < 0.8
    cfg = vt.default_config(20.0).stage(0)
    want = j_lattice_mask(SHAPE,
                          vnlb_tpu.default_config(20.0).stage(0)).copy()
    got = lattice_mask(SHAPE, cfg).copy()
    np.testing.assert_array_equal(got, want)
    jcompat._update_mask(want, inds, valid, SHAPE, boost, nkeep)
    tcompat._update_mask(got, inds, valid, SHAPE, boost, nkeep)
    np.testing.assert_array_equal(got, want)
    assert got.sum() < lattice_mask(SHAPE, cfg).sum() or nkeep == 0


@pytest.mark.parametrize("pt", [1, 2])
def test_agg_patches_and_finalize_match_jax(pt):
    """Duplicate corners, clipped corners, invalid rows and -1 indices."""
    rng = np.random.default_rng(pt)
    t, c, h, w = 4, 3, 20, 22
    ps, b, k = 5, 6, 9
    shape = (t, c, h, w)
    inds = rng.integers(0, t * c * h * w, (b, k)).astype(np.int32)
    inds[1] = inds[0]                       # whole duplicate groups
    inds[2, :3] = inds[2, 3]                # duplicates within a group
    inds[4, 2] = -1
    valid = np.array([True, True, True, False, True, True])
    patches = rng.normal(100, 30, (b, k, pt, c, ps, ps)).astype(np.float32)
    deno0 = rng.normal(0, 1, (t * h * w, c)).astype(np.float32)
    w0 = rng.uniform(0, 2, (t * h * w,)).astype(np.float32)
    w0[::7] = 0.0
    jd, jw = jagg.agg_patches(jnp.asarray(deno0), jnp.asarray(w0),
                              jnp.asarray(patches), jnp.asarray(inds),
                              jnp.asarray(valid), pt, ps, shape)
    td, tw = agg.agg_patches(torch.from_numpy(deno0.copy()),
                             torch.from_numpy(w0.copy()),
                             torch.from_numpy(patches),
                             torch.from_numpy(inds), torch.from_numpy(valid),
                             pt, ps, shape)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5
                               * np.abs(np.asarray(jd)).max())
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-5)
    fallback = rng.normal(0, 50, shape).astype(np.float32)
    want = jagg.finalize(jd, jw, jnp.asarray(fallback), shape)
    got = agg.finalize(td, tw, torch.from_numpy(fallback), shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (tw.numpy() == 0).any()          # the fallback was taken
    again = agg.agg_patches(torch.from_numpy(deno0.copy()),
                            torch.from_numpy(w0.copy()),
                            torch.from_numpy(patches),
                            torch.from_numpy(inds), torch.from_numpy(valid),
                            pt, ps, shape)
    assert torch.equal(again[0], td) and torch.equal(again[1], tw)


def test_one_batch_mask_update_matches_jax(clip):
    """Given the same first batch of sites, the gather search's indices
    clear the same mask bits in both packages."""
    _, noisy = clip
    jc = vnlb_tpu.default_config(20.0).stage(0).replace(bsize=64)
    cfg = config_from_jax(jc)
    mask = lattice_mask(SHAPE, cfg)
    coords = np.argwhere(mask)
    sites = coords[np.random.default_rng(0).permutation(len(coords))[:64]]
    sites = sites.astype(np.int32)
    zf = np.zeros((3, 2, 48, 48), np.float32)
    yuv = jcolor.rgb2yuv(jnp.asarray(noisy))
    _, jinds = jsearch.exec_search(yuv, jnp.asarray(sites), jnp.asarray(zf),
                                   jnp.asarray(zf), jc,
                                   ctx=jsearch.build_search_ctx(yuv, jc))
    tyuv = color.rgb2yuv(torch.from_numpy(noisy))
    _, tinds = exec_search(tyuv, torch.from_numpy(sites),
                           torch.from_numpy(zf), torch.from_numpy(zf), cfg)
    ok = np.ones(64, bool)
    want, got = mask.copy(), mask.copy()
    jcompat._update_mask(want, np.asarray(jinds), ok, SHAPE, True, -1)
    tcompat._update_mask(got, tinds.numpy(), ok, SHAPE, True, -1)
    np.testing.assert_array_equal(got, want)


def _counting(monkeypatch, module):
    """Sites drawn per batch, through ``module._update_mask``."""
    counts = []
    orig = module._update_mask

    def counting(mask, inds, valid, shape, boost, nkeep):
        counts.append(int(np.sum(valid)))
        orig(mask, inds, valid, shape, boost, nkeep)

    monkeypatch.setattr(module, "_update_mask", counting)
    return counts


def _zero():
    return torch.zeros((3, 2, 48, 48))


def test_proc_nl_compat_matches_jax(clip, monkeypatch):
    clean, noisy = clip
    jc = vnlb_tpu.default_config(20.0).stage(0).replace(bsize=64)
    jn = _counting(monkeypatch, jcompat)
    tn = _counting(monkeypatch, tcompat)
    zf = np.zeros((3, 2, 48, 48), np.float32)
    want = np.asarray(jcompat.proc_nl_compat(noisy, None, None, zf, zf, jc,
                                             seed=3))
    got = tcompat.proc_nl_compat(torch.from_numpy(noisy), None, None,
                                 _zero(), _zero(), config_from_jax(jc),
                                 seed=3).numpy()
    assert abs(compute_psnr(got, clean) - compute_psnr(want, clean)) < 0.05
    assert abs(sum(tn) - sum(jn)) <= 0.05 * sum(jn), (tn, jn)
    assert compute_psnr(got, clean) > compute_psnr(noisy, clean) + 2.0
    again = tcompat.proc_nl_compat(torch.from_numpy(noisy), None, None,
                                   _zero(), _zero(), config_from_jax(jc),
                                   seed=3).numpy()
    np.testing.assert_array_equal(again, got)


def test_denoise_compat_matches_jax(clip, monkeypatch):
    clean, noisy = clip
    jn = _counting(monkeypatch, jcompat)
    tn = _counting(monkeypatch, tcompat)
    jd, jb = jcompat.denoise_compat(
        noisy, 20.0, cfg=vnlb_tpu.default_config(20.0, bsize=[64, 64]))
    deno, basic = tcompat.denoise_compat(
        noisy, 20.0, cfg=vt.default_config(20.0, bsize=[64, 64]),
        device="cpu")
    for got, want in ((basic, jb), (deno, jd)):
        assert abs(compute_psnr(got.numpy(), clean)
                   - compute_psnr(np.asarray(want), clean)) < 0.05
    assert abs(sum(tn) - sum(jn)) <= 0.05 * sum(jn), (tn, jn)
    assert compute_psnr(deno.numpy(), clean) > \
        compute_psnr(noisy, clean) + 3.0
    d2, b2 = tcompat.denoise_compat(
        noisy, 20.0, cfg=vt.default_config(20.0, bsize=[64, 64]),
        device="cpu")
    assert torch.equal(d2, deno) and torch.equal(b2, basic)


def test_compat_seed_changes_the_draw(clip):
    _, noisy = clip
    cfg = vt.default_config(20.0).stage(0).replace(bsize=64)
    x = torch.from_numpy(noisy)
    a = tcompat.proc_nl_compat(x, None, None, None, None, cfg, seed=0)
    b = tcompat.proc_nl_compat(x, None, None, None, None, cfg, seed=1)
    assert not torch.equal(a, b)


def test_paste_trick_reduces_sites(clip, monkeypatch):
    """tests/test_compat.py:47 on the port: the dilation clears more of
    the mask per batch, so fewer sites are drawn."""
    _, noisy = clip
    cfg = vt.default_config(20.0).stage(0).replace(bsize=32)
    counts = {}
    for boost in (True, False):
        n = _counting(monkeypatch, tcompat)
        tcompat.proc_nl_compat(torch.from_numpy(noisy), None, None, None,
                               None, cfg.replace(aggre_boost=boost), seed=0)
        counts[boost] = sum(n)
    assert counts[True] < counts[False], counts
    assert counts[True] < lattice_mask(SHAPE, cfg).sum()
