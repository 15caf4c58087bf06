"""``denoise_streaming`` of the port on the CPU: the clip and config of
tests/test_streaming.py (13x48x48, nwt 1, chunk=3: every window a strict
sub-window), held to the port's own ``denoise`` with that file's bounds
and to ``vnlb_tpu.denoise_streaming`` within 0.02 dB."""

import numpy as np
import pytest
import torch

from vnlb_tpu.api import denoise_streaming as j_streaming
from vnlb_tpu.config import default_config as j_default_config

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clip():
    clean = synthetic_video(13, 48, 48, seed=7)
    return clean, add_noise(clean, 20.0, seed=8)


def _cfg(mod):
    return mod(20.0, preset="iphone", nwt_f=[1, 1], nwt_b=[1, 1])


@pytest.fixture(scope="module")
def streamed(clip):
    _, noisy = clip
    deno, basic, sec = vt.denoise_streaming(noisy, 20.0, chunk=3,
                                            cfg=_cfg(vt.default_config),
                                            device="cpu")
    return deno, basic, sec


@pytest.fixture(scope="module")
def whole(clip):
    _, noisy = clip
    deno, basic, _ = vt.denoise(noisy, 20.0, cfg=_cfg(vt.default_config),
                                device="cpu")
    return deno.numpy(), basic.numpy()


def test_streaming_matches_monolithic(clip, streamed, whole):
    clean, noisy = clip
    d_s, b_s, sec = streamed
    d_full, b_full = whole
    assert isinstance(d_s, np.ndarray) and d_s.shape == noisy.shape
    assert sec > 0
    # the bounds of tests/test_streaming.py: the windows regroup the
    # scatter, so only its summation order differs
    assert np.abs(b_s - b_full).max() < 5e-2, np.abs(b_s - b_full).max()
    assert np.abs(d_s - d_full).max() < 1.2e-1, np.abs(d_s - d_full).max()
    assert np.abs(b_s - b_full).mean() < 1e-3, np.abs(b_s - b_full).mean()
    assert np.abs(d_s - d_full).mean() < 1e-3, np.abs(d_s - d_full).mean()
    assert abs(compute_psnr(d_s, clean) - compute_psnr(d_full, clean)) < 0.01


def test_streaming_single_chunk_is_denoise(clip, whole):
    _, noisy = clip
    d_s, b_s, _ = vt.denoise_streaming(noisy, 20.0, chunk=100,
                                       cfg=_cfg(vt.default_config),
                                       device="cpu")
    np.testing.assert_array_equal(d_s, whole[0])
    np.testing.assert_array_equal(b_s, whole[1])


def test_streaming_matches_jax(clip, streamed):
    clean, noisy = clip
    jd, jb, _ = j_streaming(noisy, 20.0, chunk=3, cfg=_cfg(j_default_config))
    for got, want in ((streamed[1], jb), (streamed[0], jd)):
        dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
        assert dpsnr < 0.02, dpsnr

