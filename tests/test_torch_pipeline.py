"""End-to-end parity of the PyTorch port against the JAX package on the CPU:
each pass and the two-pass ``denoise`` on a (5, 96, 112) clip at sigma=20
with the bench config; determinism; unsupported configs raise."""

import numpy as np
import pytest
import torch

import vnlb_tpu
from vnlb_tpu.pipeline import proc_nl as j_proc_nl

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)

BENCH = dict(preset="iphone", eig_method="poly", step_s=6,
             border_mode="mask", topk="exact")


@pytest.fixture(scope="module")
def clip():
    clean = synthetic_video(5, 96, 112, seed=0)
    return clean, add_noise(clean, 20.0, seed=1)


@pytest.fixture(scope="module")
def jax_run(clip):
    clean, noisy = clip
    cfg = vnlb_tpu.default_config(20.0, **BENCH)
    deno, basic, _ = vnlb_tpu.denoise(noisy, 20.0, cfg=cfg)
    return cfg, np.array(basic), np.array(deno)


@pytest.fixture(scope="module")
def port_run(clip):
    clean, noisy = clip
    cfg = vt.default_config(20.0, **BENCH)
    deno, basic, sec = vt.denoise(noisy, 20.0, cfg=cfg, device="cpu")
    return deno.numpy(), basic.numpy(), sec


def _close(got, want, clean):
    dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
    assert dpsnr < 0.02, dpsnr
    mad = np.abs(got - want).mean()
    assert mad < 0.25, mad


def test_first_pass_matches_jax(clip, jax_run):
    clean, noisy = clip
    jc, jbasic, _ = jax_run
    got = vt.proc_nl(torch.from_numpy(noisy), None, None,
                     config_from_jax(jc.stage(0))).numpy()
    _close(got, jbasic, clean)


def test_second_pass_matches_jax(clip, jax_run):
    clean, noisy = clip
    jc, jbasic, jdeno = jax_run
    zf = np.zeros((5, 2, 96, 112), np.float32)
    want = np.asarray(j_proc_nl(noisy, jbasic, None, zf, zf, jc.stage(1),
                                zero_flow=True))
    np.testing.assert_array_equal(want, jdeno)
    got = vt.proc_nl(torch.from_numpy(noisy), torch.from_numpy(jbasic), None,
                     config_from_jax(jc.stage(1))).numpy()
    _close(got, want, clean)


def test_denoise_matches_jax(clip, jax_run, port_run):
    clean, noisy = clip
    _, jbasic, jdeno = jax_run
    deno, basic, sec = port_run
    assert deno.shape == basic.shape == noisy.shape
    assert np.isfinite(deno).all() and sec > 0
    _close(basic, jbasic, clean)
    _close(deno, jdeno, clean)
    assert compute_psnr(deno, clean) >= compute_psnr(noisy, clean) + 6.0


def test_denoise_repeat_is_bitwise(clip, port_run):
    clean, noisy = clip
    deno, basic, _ = vt.denoise(noisy, 20.0, device="cpu",
                                cfg=vt.default_config(20.0, **BENCH))
    np.testing.assert_array_equal(basic.numpy(), port_run[1])
    np.testing.assert_array_equal(deno.numpy(), port_run[0])


@pytest.mark.parametrize("override", [
    dict(border_mode="slide"), dict(topk="stream"), dict(topk="approx"),
    dict(eig_method="jacobi"), dict(poly_econ=False), dict(deno="ave"),
    dict(couple_channels=True), dict(poly_impl="pallas"),
    dict(agg_weight="exp"), dict(poly_gram=False),
])
def test_unsupported_config_raises(clip, override):
    _, noisy = clip
    kw = dict(BENCH, **override)
    cfg = vt.default_config(20.0, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vt.denoise(noisy[:, :, :32, :32], 20.0, cfg=cfg, device="cpu")


def test_nonzero_flow_raises(clip):
    _, noisy = clip
    ff = np.zeros((5, 2, 96, 112), np.float32)
    bf = ff.copy()
    bf[1, 0, 3, 3] = 0.5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vt.denoise(noisy, 20.0, flows=(ff, bf), device="cpu")



def test_site_chunks_do_not_change_output(clip, monkeypatch):
    """The pass runs over chunks of sites; per-site work is independent and
    the scatter keeps the global order, so chunking changes nothing but the
    last bits of the plain filter (CPU batched matmuls are not invariant
    to the batch size; on the card the kernel path is bitwise invariant,
    tests/test_torch_cuda.py)."""
    _, noisy = clip
    cfg = vt.default_config(20.0, **BENCH).stage(1)
    small = torch.from_numpy(noisy[:, :, :48, :64].copy())
    whole = vt.proc_nl(small, small, None, cfg)
    monkeypatch.setattr(vt.pipeline, "SITE_CHUNK", 97)
    chunked = vt.proc_nl(small, small, None, cfg)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-3)
