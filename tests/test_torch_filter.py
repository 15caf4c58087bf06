"""Filter parity of the PyTorch port against the JAX package on the CPU:
the econ filter on both routes at the tolerances of
tests/test_pallas_filter.py, bayes_denoise (with flat-group centring) and
flat_areas."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import vnlb_tpu.config as jcfg
from vnlb_tpu.ops.bayes import bayes_denoise as j_bayes
from vnlb_tpu.ops.flat import flat_areas as j_flat
from vnlb_tpu.ops.polyspec import poly_filter_econ as j_econ

from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops.bayes import bayes_denoise
from vnlb_tpu_torch.ops.econ_filter import econ_filter, econ_filter_plain
from vnlb_tpu_torch.ops.flat import flat_areas

torch.set_num_threads(2)


def _mkdata(g, k, p, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
    xc = base + rng.normal(size=(g, k, p)).astype(np.float32) * 20
    xn = base + rng.normal(size=(g, k, p)).astype(np.float32) * 20
    return xc, xn


def _rms(got, want):
    scale = np.abs(want).mean() + 1e-6
    return np.sqrt(np.mean((got - want) ** 2)) / scale, \
        np.abs(got - want).max() / scale


@pytest.mark.parametrize("stage,g,k,p", [
    (1, 8, 60, 98),      # Gram route (K < p)
    (0, 8, 100, 49),     # matrix route (K >= p)
])
@pytest.mark.parametrize("bf16", [False, True])
def test_econ_filter_matches_jax(stage, g, k, p, bf16):
    jc = jcfg.default_config(20.0, preset="iphone").stage(stage).replace(
        poly_bf16=bf16)
    xc, xn = _mkdata(g, k, p, seed=stage)
    want = np.asarray(j_econ(jnp.asarray(xc), jnp.asarray(xn), jc))
    got = econ_filter(torch.from_numpy(xc), torch.from_numpy(xn),
                      config_from_jax(jc)).numpy()
    rms, mx = _rms(got, want)
    if bf16:
        assert rms < 5e-2, rms
    else:
        assert rms < 1e-4, rms
        assert mx < 1e-3, mx


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("bf16", [False, True])
def test_bayes_denoise_matches_jax(stage, bf16):
    jc = jcfg.default_config(20.0, preset="iphone").stage(stage).replace(
        poly_bf16=bf16)
    tc = config_from_jax(jc)
    rng = np.random.default_rng(10 + stage)
    b, k, c, p = 6, jc.npatches, 3, jc.pdim
    clean = rng.uniform(40, 200, (b, 1, c, p)).astype(np.float32)
    pn = clean + rng.normal(0, 20, (b, k, c, p)).astype(np.float32)
    pb = clean + rng.normal(0, 5, (b, k, c, p)).astype(np.float32)
    flags = np.array([True, False, True, False, False, True])
    if stage == 1:
        want, wvar = j_bayes(jnp.asarray(pn), jnp.asarray(pb),
                             jnp.asarray(flags), jc)
        got, gvar = bayes_denoise(torch.from_numpy(pn), torch.from_numpy(pb),
                                  torch.from_numpy(flags), tc)
    else:
        want, wvar = j_bayes(jnp.asarray(pn), None, None, jc)
        got, gvar = bayes_denoise(torch.from_numpy(pn), None, None, tc)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (b, k, tc.pt, c, tc.ps, tc.ps)
    np.testing.assert_allclose(gvar.numpy(), np.asarray(wvar), rtol=1e-4)
    rms, _ = _rms(got, want)
    assert rms < (5e-3 if bf16 else 1e-5), rms
    if stage == 1:
        # flat groups are centred on the basic mean: moving the basic mean
        # of a flat group moves its output, not that of a non-flat group
        pb2 = pb.copy()
        pb2[:2] += 10.0
        got2, _ = bayes_denoise(torch.from_numpy(pn), torch.from_numpy(pb2),
                                torch.from_numpy(flags), tc)
        moved = np.abs(got2.numpy() - got).reshape(b, -1).max(axis=1)
        assert moved[0] > 1.0 and moved[1] < 0.05, moved


def test_flat_areas_matches_jax():
    rng = np.random.default_rng(4)
    b, k, c, p = 16, 60, 3, 98
    sd = rng.uniform(1, 12, (b, 1, 1, 1)).astype(np.float32)
    x = (100 + sd * rng.normal(size=(b, k, c, p))).astype(np.float32)
    want = np.asarray(j_flat(jnp.asarray(x), 0.2, 400.0))
    got = flat_areas(torch.from_numpy(x), 0.2, 400.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_wrapper_takes_plain_version_on_cpu():
    cfg = config_from_jax(jcfg.default_config(20.0).stage(1))
    xc, xn = _mkdata(4, 60, 98, seed=5)
    xc, xn = torch.from_numpy(xc), torch.from_numpy(xn)
    before = econ_filter.launches
    assert torch.equal(econ_filter(xc, xn, cfg),
                       econ_filter_plain(xc, xn, cfg))
    assert econ_filter.launches == before

