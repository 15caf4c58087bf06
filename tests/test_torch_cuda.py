"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither jax nor vnlb_tpu, so it runs on a machine that
has only PyTorch; tests/conftest.py imports jax, so run it there with

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Without a CUDA card every test skips (a CUDA kernel has no CPU mode).
"""

import numpy as np
import pytest
import torch

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.ops.econ_filter import econ_filter, econ_filter_plain
from vnlb_tpu_torch.ops.mask import lattice_sites
from vnlb_tpu_torch.ops.patch_dist import patch_dist, patch_dist_plain
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

BENCH = dict(preset="iphone", eig_method="poly", step_s=6,
             border_mode="mask", topk="exact")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1])
def test_patch_dist_kernel_matches_plain(card, stage):
    cfg = vt.default_config(20.0, **BENCH).stage(stage)
    rng = np.random.default_rng(1)
    vid = torch.from_numpy(rng.uniform(0, 255, (5, cfg.dist_chnls, 60, 64))
                           .astype(np.float32)).to(card)
    sites = torch.from_numpy(lattice_sites((5, 3, 60, 64), cfg)).to(card)
    args = (vid, sites[:, 0], sites[:, 1], sites[:, 2], -3, 7, cfg.pt,
            cfg.ps, cfg.w_s)
    before = patch_dist.launches
    got = patch_dist(*args)
    want = patch_dist_plain(*args)
    torch.cuda.synchronize()
    assert patch_dist.launches == before + 1
    # f32 sums of the same squares in another order
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("stage,bf16", [(0, True), (1, True), (0, False),
                                        (1, False)])
def test_econ_filter_kernel_matches_plain(card, stage, bf16):
    cfg = vt.default_config(20.0, **BENCH).stage(stage).replace(
        poly_bf16=bf16)
    k, p = cfg.npatches, cfg.pdim
    rng = np.random.default_rng(stage)
    base = rng.normal(size=(64, 1, p)).astype(np.float32) * 30
    xc = torch.from_numpy(base + rng.normal(size=(64, k, p))
                          .astype(np.float32) * 20).to(card)
    xn = torch.from_numpy(base + rng.normal(size=(64, k, p))
                          .astype(np.float32) * 20).to(card)
    got = econ_filter(xc, xn, cfg)
    want = econ_filter_plain(xc, xn, cfg)
    scale = want.abs().mean()
    rms = ((got - want) ** 2).mean().sqrt() / scale
    # same cast points, other summation order (tolerances of
    # tests/test_pallas_filter.py)
    assert rms < (5e-2 if bf16 else 1e-4), rms.item()


@pytest.mark.cuda
def test_main_path_launches_kernels(card):
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    cfg = vt.default_config(20.0, **BENCH)
    patch_dist.launches = econ_filter.launches = 0
    deno, basic, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert patch_dist.launches > 0 and econ_filter.launches > 0
    again, _, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=card)
    assert torch.equal(deno, again)
    assert compute_psnr(deno.cpu().numpy(), clean) > \
        compute_psnr(noisy, clean) + 6.0


@pytest.mark.cuda
def test_site_chunks_bitwise_on_card(card, monkeypatch):
    """Both kernels work per site / per group and the scatter keeps the
    global order, so the chunk size does not change a bit."""
    noisy = add_noise(synthetic_video(5, 64, 80, seed=2), 20.0, seed=3)
    cfg = vt.default_config(20.0, **BENCH).stage(1)
    vid = torch.from_numpy(noisy).to(card)
    whole = vt.proc_nl(vid, vid, None, cfg)
    monkeypatch.setattr(vt.pipeline, "SITE_CHUNK", 97)
    assert torch.equal(vt.proc_nl(vid, vid, None, cfg), whole)


@pytest.mark.cuda
def test_econ_filter_kernel_refuses_oversized_group(card):
    """A matrix-route group with p=98 at K=100 does not fit the kernel's
    shared memory: it raises, it does not fall back."""
    cfg = vt.default_config(20.0, preset="default").stage(0)
    x = torch.zeros((2, 100, 98), device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        econ_filter(x, x, cfg)
