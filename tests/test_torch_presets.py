"""Two-pass ``denoise`` of the port against ``vnlb_tpu.denoise`` on the CPU
for every preset other than the API default (tests/test_torch_pipeline.py
covers ``iphone``) and for the filter modes of the second slice, on a
(4, 48, 56) clip, just above the 33-px search region of ``w_s=27``.
Criteria of tests/test_torch_pipeline.py: |dPSNR| < 0.02 dB, MAD < 0.25.

``default`` and ``exp`` run w_s=27 with 13 dt planes and pt=2 in the
first pass (the K=100, p=98 matrix-route groups); ``sss`` w_s=15 with
pt=2; ``sss_v2`` w_s=15 with pt=1, the l2 search in both passes."""

import numpy as np
import pytest
import torch

import vnlb_tpu

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)

# name: (port overrides, JAX overrides or None for the same).  JAX runs
# poly_impl="pallas" through a Pallas call the CPU cannot lower outside
# interpret mode, so the reference is its plain function, polyspec's
# poly_filter (poly_econ and poly_fused off), in both passes.
RUNS = {
    "default": (dict(preset="default"), None),
    "exp": (dict(preset="exp"), None),
    "sss": (dict(preset="sss"), None),
    "sss_v2": (dict(preset="sss_v2"), None),
    "poly_pallas": (dict(poly_impl="pallas"),
                    dict(poly_econ=False, poly_fused=False)),
    "eig_xla": (dict(eig_method="xla"), None),
    "couple_channels": (dict(couple_channels=True), None),
    "deno_ave": (dict(deno="ave"), None),
}


@pytest.fixture(scope="module")
def clip():
    clean = synthetic_video(4, 48, 56, seed=0)
    return clean, add_noise(clean, 20.0, seed=1)


def _close(got, want, clean):
    dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
    assert dpsnr < 0.02, dpsnr
    mad = np.abs(got - want).mean()
    assert mad < 0.25, mad


@pytest.mark.parametrize("name", list(RUNS))
def test_two_pass_matches_jax(clip, name):
    clean, noisy = clip
    kw, jkw = RUNS[name]
    deno, basic, _ = vt.denoise(noisy, 20.0, cfg=vt.default_config(20.0, **kw),
                                device="cpu")
    jdeno, jbasic, _ = vnlb_tpu.denoise(
        noisy, 20.0, cfg=vnlb_tpu.default_config(20.0, **(jkw or kw)))
    deno, basic = deno.numpy(), basic.numpy()
    assert deno.shape == noisy.shape and np.isfinite(deno).all()
    _close(basic, np.asarray(jbasic), clean)
    _close(deno, np.asarray(jdeno), clean)
    if name != "deno_ave":
        assert compute_psnr(deno, clean) >= compute_psnr(noisy, clean) + 6.0
