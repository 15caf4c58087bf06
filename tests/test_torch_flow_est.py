"""Optical-flow estimation of the PyTorch port (vnlb_tpu_torch/ops/flow.py)
against vnlb_tpu/ops/flow.py on the CPU.

Tolerances (measured by scripts/torch_cpu_parity.py).  Every helper and
one TV-L1 inner step to 1e-5 (measured: helpers <= 3.9e-7, one inner step
1.2e-7, 25 inner steps 9.5e-7).  The full estimators: ``lk_flow`` to
5e-4 px (measured <= 4.7e-5 px at 72 x 72, 2.8e-4 px on a noisy 480 x 854
pair); ``tvl1_flow`` to a mean |d| of 1e-4 px and a max of 0.25 px
(``TVL1_MEAN``, ``TVL1_MAX``): XLA fuses and contracts each of its 625
inner steps a level in its own way, and the clamp of the data step
amplifies an f32 difference at a few pixels of a noisy frame (measured on
the noisy 5 x 72 x 72 clip: mean <= 5.1e-5 px, max 0.077 px at one pair;
on a noisy 480 x 854 pair mean 3.9e-6, max 1.1e-3; a clean pair max
5.6e-5).  Then the layout of ``estimate_flows``, the
benefit of estimated flows over zero flow (the port's version of
tests/test_flow_benefit.py at its 72-px, motion-4 case), and a denoise
with the port's flows against one with JAX's."""

import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vnlb_tpu.ops import flow as jf

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops import flow as tf
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)

HELPER_TOL = 1e-5
LK_MAX = 5e-4
TVL1_MEAN, TVL1_MAX = 1e-4, 0.25


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max()


def _tvl1_close(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert d.mean() <= TVL1_MEAN and d.max() <= TVL1_MAX, (d.mean(), d.max())


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (23, 37)).astype(np.float32)
    u = rng.normal(0, 2, (23, 37)).astype(np.float32)
    v = rng.normal(0, 2, (23, 37)).astype(np.float32)
    return x, u, v


@pytest.fixture(scope="module")
def pair():
    vid = synthetic_video(2, 72, 72, seed=11, motion=4.0)
    return vid[0], vid[1]


def test_box_matches(arrays):
    x, _, _ = arrays
    for r in (1, 4):
        assert _err(tf._box(_t(x), r), jf._box(x, r)) <= HELPER_TOL


def test_warp_matches(arrays):
    """Bilinear warp with the frame clamps, flows reaching past every
    edge."""
    x, u, v = arrays
    assert _err(tf._warp(_t(x), _t(u), _t(v)), jf._warp(x, u, v)) \
        <= HELPER_TOL
    big = 30.0 * np.sign(u)
    assert _err(tf._warp(_t(x), _t(big), _t(-big)),
                jf._warp(x, big, -big)) <= HELPER_TOL


def test_stencils_match(arrays):
    x, u, v = arrays
    assert _err(tf._blur121(_t(x)), jf._blur121(x)) <= HELPER_TOL
    for got, want in zip(tf._fgrad(_t(x)), jf._fgrad(x)):
        assert _err(got, want) <= HELPER_TOL
    assert _err(tf._div(_t(u), _t(v)), jf._div(u, v)) <= HELPER_TOL
    for got, want in zip(torch.gradient(_t(x)), jnp.gradient(x)):
        assert _err(got, want) <= HELPER_TOL
    assert _err(tf._avg_pool(_t(x)), jf._avg_pool(x)) <= HELPER_TOL


@pytest.mark.parametrize("src,dst", [((11, 19), (23, 39)), ((9, 9), (18, 18)),
                                     ((5, 7), (11, 15))])
def test_upsample_matches_jax_resize(src, dst):
    """Odd pyramid levels upsample by slightly more than 2."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), dst, "bilinear")
    assert _err(tf._upsample(_t(x), dst), want) <= HELPER_TOL


def _gray(pair):
    return [jnp.mean(jnp.asarray(f), axis=0) for f in pair]


def test_tvl1_one_inner_step_matches(pair):
    g0, g1 = _gray(pair)
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.normal(0, 1, g0.shape).astype(np.float32))
    v = jnp.asarray(rng.normal(0, 1, g0.shape).astype(np.float32))
    want = jf._tvl1_level(g0, g1, u, v, 0.15, 0.3, 0.25, 1, 1)
    got = tf._tvl1_level(_t(g0), _t(g1), _t(u), _t(v), 0.15, 0.3, 0.25,
                         1, 1)
    for a, b in zip(got, want):
        assert _err(a, b) <= HELPER_TOL


def test_lk_level_matches(pair):
    g0, g1 = (g / 255.0 for g in _gray(pair))
    z = jnp.zeros_like(g0)
    want = jf._lk_level(g0, g1, z, z, 4, 1, 1e-4)
    got = tf._lk_level(_t(g0), _t(g1), _t(z), _t(z), 4, 1, 1e-4)
    for a, b in zip(got, want):
        assert _err(a, b) <= HELPER_TOL


@pytest.mark.parametrize("method", ["tvl1", "lk"])
def test_full_estimator_matches(pair, method):
    f0, f1 = pair
    fn = {"tvl1": (tf.tvl1_flow, jf.tvl1_flow),
          "lk": (tf.lk_flow, jf.lk_flow)}[method]
    got = fn[0](f0, f1, device="cpu")
    want = np.asarray(fn[1](f0, f1))
    assert got.shape == (2, 72, 72) and got.dtype == torch.float32
    if method == "lk":
        assert _err(got, want) <= LK_MAX
    else:
        _tvl1_close(got, want)
    assert np.abs(want).mean() > 1.0        # it tracked the drift


def test_estimate_flows_layout():
    rng = np.random.default_rng(1)
    video = rng.uniform(0, 255, (3, 3, 48, 48)).astype(np.float32)
    ff, bf = tf.estimate_flows(video, levels=2, iters=1, method="lk",
                               device="cpu")
    jff, jbf = jf.estimate_flows(video, levels=2, iters=1, method="lk")
    assert ff.shape == bf.shape == (3, 2, 48, 48)
    assert ff.device.type == "cpu" and ff.dtype == torch.float32
    assert torch.equal(ff[-1], ff[-2]) and torch.equal(bf[0], bf[1])
    assert _err(ff, jff) <= LK_MAX and _err(bf, jbf) <= LK_MAX
    with pytest.raises(ValueError, match="flow method"):
        tf.estimate_flows(video, method="nope", device="cpu")
    one, back = tf.estimate_flows(video[:1], device="cpu")
    assert one.shape == back.shape == (1, 2, 48, 48) and not one.any()


@pytest.fixture(scope="module")
def drift_clip():
    clean = synthetic_video(5, 72, 72, seed=11, motion=4.0)
    return clean, add_noise(clean, 20.0, seed=12)


@pytest.fixture(scope="module")
def port_flows(drift_clip):
    return tf.estimate_flows(drift_clip[1], device="cpu")


def test_estimated_flow_beats_zero_flow(drift_clip, port_flows):
    """tests/test_flow_benefit.py's 72-px, motion-4 case on the port:
    estimated flows beat zero flow in both passes."""
    clean, noisy = drift_clip
    cfg = vt.default_config(20.0, npatches=[40, 30], bsize=[128, 128])
    assert port_flows[0].abs().mean() > 1.0
    d0, b0, _ = vt.denoise(noisy, 20.0, cfg=cfg, device="cpu")
    d1, b1, _ = vt.denoise(noisy, 20.0, flows=port_flows, cfg=cfg,
                           device="cpu")

    def p(x):
        return compute_psnr(x.numpy(), clean)

    assert p(b1) > p(b0) + 0.08, (p(b0), p(b1))
    assert p(d1) > p(d0) + 0.08, (p(d0), p(d1))


def test_denoise_with_port_flows_matches_jax_flows(drift_clip, port_flows):
    """The port's estimated flows and JAX's drive the port's denoise to
    the same PSNR (within 0.02 dB)."""
    clean, noisy = drift_clip
    jflows = tuple(np.asarray(f) for f in jf.estimate_flows(noisy))
    for got, want in zip(port_flows, jflows):
        _tvl1_close(got, want)
    d_port, b_port, _ = vt.denoise(noisy, 20.0, flows=port_flows,
                                   device="cpu")
    d_jax, b_jax, _ = vt.denoise(noisy, 20.0, flows=jflows, device="cpu")
    for a, b in ((b_port, b_jax), (d_port, d_jax)):
        assert abs(compute_psnr(a.numpy(), clean)
                   - compute_psnr(b.numpy(), clean)) < 0.02


@pytest.mark.parametrize("name", ["estimate_flows", "tvl1_flow", "lk_flow"])
def test_entry_points_default_to_the_card(name):
    """Every flow entry point runs on the card unless the caller asks for
    the CPU."""
    fn = getattr(tf, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
