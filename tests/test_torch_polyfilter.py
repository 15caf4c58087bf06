"""The port's polynomial filters against the JAX package on the CPU: the
two-factor ``poly_filter`` (kernel K5's plain version) at both regimes,
against ``polyspec.poly_filter`` and the Pallas kernel in interpret mode;
``poly_filter_fused``; and the econ filter (kernel K2's plain version) at
the group shapes beyond K2's shared memory."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import vnlb_tpu.config as jcfg
from vnlb_tpu.ops import polyspec as jpoly
from vnlb_tpu.ops.pallas_poly import poly_filter_pallas

from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops import polyspec as tpoly
from vnlb_tpu_torch.ops.econ_filter import econ_filter_plain
from vnlb_tpu_torch.ops.poly_filter import poly_filter, poly_filter_plain

torch.set_num_threads(2)


def _groups(rng, g, k, p, scale=30.0):
    """Centred groups with a rank-3 structure over the noise (the inputs of
    tests/test_pallas_poly.py)."""
    base = rng.normal(0, scale, (g, 1, p))
    struct = rng.normal(0, scale / 2, (g, 3, p))
    coefs = rng.normal(0, 1, (g, k, 3))
    x = base + np.einsum("gkr,grp->gkp", coefs, struct) \
        + rng.normal(0, 18.0, (g, k, p))
    x = x - x.mean(axis=1, keepdims=True)
    return x.astype(np.float32)


def _err(got, want):
    scale = np.abs(want).mean() + 1e-6
    return (np.sqrt(np.mean((got - want) ** 2)) / scale,
            np.abs(got - want).max() / scale)


def _run(jfn, tfn, jc, xc, xn):
    want = np.asarray(jfn(jnp.asarray(xc), jnp.asarray(xn), jc))
    got = tfn(torch.from_numpy(xc), torch.from_numpy(xn),
              config_from_jax(jc)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return _err(got, want)


@pytest.mark.parametrize("stage,k,p", [(0, 100, 49),    # right, K >= p
                                       (1, 60, 98)])    # left, K < p
@pytest.mark.parametrize("bf16", [False, True])
def test_poly_filter_matches_jax(stage, k, p, bf16):
    jc = jcfg.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
    rng = np.random.default_rng(20 + stage)
    xc, xn = _groups(rng, 6, k, p), _groups(rng, 6, k, p)
    rms, mx = _run(jpoly.poly_filter, poly_filter, jc, xc, xn)
    if bf16:
        # same cast points; a summation-order difference can flip one bf16
        # rounding, which the sign iteration then carries (measured rms
        # 1.4e-3 at stage 0, 6.8e-3 at stage 1)
        assert rms < 2e-2, rms
    else:
        assert rms < 1e-4 and mx < 1e-3, (rms, mx)


@pytest.mark.parametrize("stage,k,p", [(0, 100, 147),   # couple_channels,
                                       (1, 60, 294)])   # left route both
@pytest.mark.parametrize("bf16", [False, True])
def test_poly_filter_couple_matches_jax(stage, k, p, bf16):
    """The joint groups of couple_channels (kernel K5's batched design on
    the card), 2 groups each; f32 at the file's f32 bounds, bf16 at its
    bf16 bound (measured rms 3.0e-3 at (100, 147), 6.2e-3 at (60, 294):
    a bf16 rounding flipped by a summation order, carried by the sign
    iteration)."""
    jc = jcfg.default_config(20.0, couple_channels=True).stage(stage)
    jc = jc.replace(poly_bf16=bf16)
    rng = np.random.default_rng(50 + stage)
    xc, xn = _groups(rng, 2, k, p), _groups(rng, 2, k, p)
    rms, mx = _run(jpoly.poly_filter, poly_filter, jc, xc, xn)
    if bf16:
        assert rms < 2e-2, rms
    else:
        assert rms < 1e-4 and mx < 1e-3, (rms, mx)


def test_poly_filter_matches_pallas_interpret():
    """The Pallas kernel K5 replaces, run in interpret mode, at the JAX
    suite's tolerance (tests/test_pallas_poly.py: mean |d| / mean |want|
    < 0.02; the kernel rounds other operands than polyspec)."""
    jc = jcfg.default_config(20.0).stage(1)
    rng = np.random.default_rng(8)
    xc, xn = _groups(rng, 3, 60, 98), _groups(rng, 3, 60, 98)
    want = np.asarray(poly_filter_pallas(jnp.asarray(xc), jnp.asarray(xn),
                                         60, jc, interpret=True))
    got = poly_filter_plain(torch.from_numpy(xc), torch.from_numpy(xn),
                            config_from_jax(jc)).numpy()
    rel = np.abs(got - want).mean() / (np.abs(want).mean() + 1e-6)
    assert rel < 0.02, rel


@pytest.mark.parametrize("bf16", [False, True])
def test_poly_filter_fused_matches_jax(bf16):
    jc = jcfg.default_config(20.0).stage(1).replace(poly_bf16=bf16)
    rng = np.random.default_rng(30)
    xc, xn = _groups(rng, 6, 60, 98), _groups(rng, 6, 60, 98)
    rms, mx = _run(jpoly.poly_filter_fused, tpoly.poly_filter_fused, jc,
                   xc, xn)
    # bf16: measured rms 9e-4 (one series, no sign iteration)
    assert rms < (5e-3 if bf16 else 1e-4), (rms, mx)


@pytest.mark.parametrize("preset,stage,k,p", [
    ("default", 0, 100, 98),     # matrix route, pt=2 first pass
    ("iphone", 0, 100, 147),     # Gram route, couple_channels first pass
    ("iphone", 1, 60, 294),      # Gram route, couple_channels second pass
    ("default", 0, 100, 294),    # Gram route, both
])
def test_econ_large_groups_match_jax(preset, stage, k, p):
    """The group shapes K2 keeps partly outside shared memory, at the
    tolerances of tests/test_torch_filter.py."""
    jc = jcfg.default_config(20.0, preset=preset).stage(stage)
    rng = np.random.default_rng(k + p)
    xc, xn = _groups(rng, 4, k, p), _groups(rng, 4, k, p)
    rms, _ = _run(jpoly.poly_filter_econ, econ_filter_plain, jc, xc, xn)
    assert rms < 5e-2, rms
    rms32, mx32 = _run(jpoly.poly_filter_econ, econ_filter_plain,
                       jc.replace(poly_bf16=False), xc, xn)
    assert rms32 < 1e-4 and mx32 < 1e-3, (rms32, mx32)


def test_poly_wrapper_takes_plain_version_on_cpu():
    cfg = config_from_jax(jcfg.default_config(20.0).stage(1))
    rng = np.random.default_rng(5)
    xc = torch.from_numpy(_groups(rng, 2, 60, 98))
    xn = torch.from_numpy(_groups(rng, 2, 60, 98))
    before = poly_filter.launches
    assert torch.equal(poly_filter(xc, xn, cfg),
                       poly_filter_plain(xc, xn, cfg))
    assert poly_filter.launches == before
