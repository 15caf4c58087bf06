"""The aggregation modes of the PyTorch port against the JAX package on the
CPU: ``agg_weight="exp"`` (under both ``dense_rows`` settings),
``only_frame``, ``agg_bf16`` and the econ filter's left regime
(``poly_gram=False`` with K < p), each through ``denoise`` and the second
pass (``proc_nl`` given JAX's first pass), on a (4, 40, 48) clip at
sigma=20 with the API default config, to the limits of
tests/test_torch_pipeline.py: 0.02 dB and a mean abs difference below 0.25
gray levels.  The left regime's filter itself is held to JAX's at the
tolerances of tests/test_torch_filter.py, and K2 refuses its shapes."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import vnlb_tpu
import vnlb_tpu.config as jcfg
from vnlb_tpu.ops.polyspec import poly_filter_econ as j_econ

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops import agg, bayes
from vnlb_tpu_torch.ops import econ_filter as econ_filter_mod
from vnlb_tpu_torch.ops.polyspec import poly_filter_econ
from vnlb_tpu_torch.pipeline import agg_weights
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)

MODES = {
    "exp": dict(agg_weight="exp"),
    "exp_dense_full": dict(agg_weight="exp", dense_rows="full"),
    "only_frame": dict(only_frame=2),
    "agg_bf16": dict(agg_bf16=True),
    "left_regime": dict(poly_gram=False),
}
_JAX = {}


@pytest.fixture(scope="module")
def clip():
    clean = synthetic_video(4, 40, 48, seed=0)
    return clean, add_noise(clean, 20.0, seed=1)


def _jax_run(noisy, mode):
    """JAX's (cfg, basic, deno) of ``denoise`` in ``mode``, run once."""
    if mode not in _JAX:
        cfg = vnlb_tpu.default_config(20.0, **MODES[mode])
        deno, basic, _ = vnlb_tpu.denoise(noisy, 20.0, cfg=cfg)
        _JAX[mode] = (cfg, np.asarray(basic), np.asarray(deno))
    return _JAX[mode]


def _close(got, want, clean):
    dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
    assert dpsnr < 0.02, dpsnr
    mad = np.abs(got - want).mean()
    assert mad < 0.25, mad


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_denoise_matches_jax(clip, mode):
    clean, noisy = clip
    _, jbasic, jdeno = _jax_run(noisy, mode)
    deno, basic, _ = vt.denoise(noisy, 20.0, device="cpu",
                                cfg=vt.default_config(20.0, **MODES[mode]))
    basic, deno = basic.numpy(), deno.numpy()
    assert np.isfinite(deno).all() and deno.shape == noisy.shape
    _close(basic, jbasic, clean)
    _close(deno, jdeno, clean)


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_second_pass_matches_jax(clip, mode):
    """The second pass from JAX's first-pass output (JAX's deno is that
    pass, tests/test_torch_pipeline.py::test_second_pass_matches_jax)."""
    clean, noisy = clip
    jc, jbasic, jdeno = _jax_run(noisy, mode)
    got = vt.proc_nl(torch.from_numpy(noisy), torch.from_numpy(jbasic),
                     None, None, None, config_from_jax(jc.stage(1))).numpy()
    _close(got, jdeno, clean)


def test_modes_change_the_output(clip):
    """No mode is the default pass in disguise: each one's second pass
    differs from the default's (the left regime and agg_bf16 by rounding,
    the weights by more)."""
    _, noisy = clip
    x = torch.from_numpy(noisy)
    basic = vt.proc_nl(x, None, None, None, None,
                       vt.default_config(20.0).stage(0))
    base = vt.proc_nl(x, basic, None, None, None,
                      vt.default_config(20.0).stage(1))
    for mode, kw in MODES.items():
        got = vt.proc_nl(x, basic, None, None, None,
                         vt.default_config(20.0, **kw).stage(1))
        assert not torch.equal(got, base), mode


def test_agg_weights():
    """only_frame filters on the decoded, clipped corner frame before the
    agg_k thinning; exp weighs each candidate by its distance; invalid
    candidates weigh 0."""
    shape = (4, 3, 10, 12)
    chw = 3 * 10 * 12
    inds = torch.tensor([[0, 2 * chw + 5, 3 * chw + 7, -1],
                         [2 * chw, chw, 2 * chw + 1, 2 * chw + 2]],
                        dtype=torch.int32)
    vals = torch.tensor([[-0.1, 0.002, 0.004, float("inf")],
                         [0.0, 0.001, 0.003, 0.005]])
    cfg = vt.default_config(20.0).stage(1)          # pt = 2: frames 0..2
    np.testing.assert_array_equal(
        agg_weights(vals, inds, shape, cfg, 3).numpy(),
        [[1, 1, 1], [1, 1, 1]])
    # frame 3 clips to 2
    np.testing.assert_array_equal(
        agg_weights(vals, inds, shape, cfg.replace(only_frame=2), 3).numpy(),
        [[0, 1, 1], [1, 0, 1]])
    got = agg_weights(vals, inds, shape, cfg.replace(agg_weight="exp"), 4)
    want = np.exp(-np.maximum(vals.numpy(), 0) * 255.0 ** 2
                  / (cfg.agg_h * cfg.sigma2)) * (inds.numpy() >= 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[0, 0] == 1.0 and got[0, 3] == 0.0


def test_agg_rows_bf16_rounds_the_update_rows():
    """agg_bf16 rounds the weighted patch lanes and the weight lane to
    bf16, then adds them exactly into the f32 accumulator."""
    rng = np.random.default_rng(4)
    patches = torch.from_numpy(rng.uniform(0, 255, (3, 4, 2, 3, 2, 2))
                               .astype(np.float32))
    wts = torch.from_numpy(rng.uniform(0.1, 1.0, (3, 4)).astype(np.float32))
    rows = torch.tensor([[0, 1, 1, 5], [2, 0, 7, 1], [3, 3, 3, 6]])
    acc0 = torch.from_numpy(rng.uniform(0, 9, (8, 25)).astype(np.float32))
    got = agg.agg_rows(acc0.clone(), patches, rows, wts, bf16=True)
    upd = torch.cat([patches.reshape(3, 4, 24) * wts[..., None],
                     wts[..., None]], dim=-1).reshape(12, 25)
    upd = upd.to(torch.bfloat16).to(torch.float32)
    want = acc0.clone()
    for i, r in enumerate(rows.reshape(-1).tolist()):
        want[r] += upd[i]
    assert torch.equal(got, want)
    assert not torch.equal(got, agg.agg_rows(acc0.clone(), patches, rows,
                                             wts))


@pytest.mark.parametrize("stage,k,p", [(1, 60, 98), (0, 40, 49)])
@pytest.mark.parametrize("bf16", [False, True])
def test_left_regime_filter_matches_jax(stage, k, p, bf16):
    jc = jcfg.default_config(20.0).stage(stage).replace(
        poly_bf16=bf16, poly_gram=False, npatches=k)
    rng = np.random.default_rng(stage)
    base = rng.normal(size=(8, 1, p)).astype(np.float32) * 30
    xc = base + rng.normal(size=(8, k, p)).astype(np.float32) * 20
    xn = base + rng.normal(size=(8, k, p)).astype(np.float32) * 20
    want = np.asarray(j_econ(jnp.asarray(xc), jnp.asarray(xn), jc))
    got = poly_filter_econ(torch.from_numpy(xc), torch.from_numpy(xn),
                           config_from_jax(jc)).numpy()
    scale = np.abs(want).mean()
    rms = np.sqrt(np.mean((got - want) ** 2)) / scale
    if bf16:
        assert rms < 5e-2, rms
    else:
        assert rms < 1e-4, rms
        assert np.abs(got - want).max() / scale < 1e-3


def test_left_regime_never_reaches_k2(monkeypatch):
    """The econ wrapper sends left-regime groups to the torch chain on
    every device (meta tensors stand in for the card's here), other
    shapes to the kernel, and K2's own wrapper refuses them."""
    cfg = vt.default_config(20.0, poly_gram=False).stage(1)

    def refuse(*_):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(econ_filter_mod, "econ_filter_kernel", refuse)
    assert econ_filter_mod.left_regime(60, 98, cfg)
    gram = cfg.replace(poly_gram=True)
    assert not econ_filter_mod.left_regime(60, 98, gram)
    assert not econ_filter_mod.left_regime(100, 49, cfg)
    xm = torch.empty((4, 60, 98), device="meta")
    assert econ_filter_mod.econ_filter(xm, xm, cfg).shape == (4, 60, 98)
    # the Gram route leaves the plain version for any device but the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        econ_filter_mod.econ_filter(xm, xm, gram)
    monkeypatch.undo()
    xc = torch.zeros((4, 60, 98))
    with pytest.raises(ValueError, match="left regime"):
        econ_filter_mod.econ_filter_kernel(xc, xc, cfg)
    # bayes_denoise's left-regime output is the torch chain's
    rng = np.random.default_rng(3)
    pn = torch.from_numpy(rng.uniform(0, 255, (2, 60, 3, 98))
                          .astype(np.float32))
    flags = torch.zeros(2, dtype=torch.bool)
    got, _ = bayes.bayes_denoise(pn, pn, flags, cfg)
    want, _ = bayes.bayes_denoise(pn, pn, flags, cfg,
                                  econ_fn=poly_filter_econ)
    assert torch.equal(got, want)
