"""The port's public surface is drop-in for ``vnlb_tpu``'s: the same names
in ``__all__``, ``denoise_mod`` against ``vnlb_tpu.denoise_mod`` on the
CPU (tests/test_torch_presets.py's criteria: |dPSNR| < 0.02 dB, mean |d|
< 0.25), the cached-result readers on what the other package wrote,
``verbose`` and ``gpuid``."""

import numpy as np
import pytest
import torch

import vnlb_tpu
from vnlb_tpu.utils import video_io as jvideo_io

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils import video_io
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)


def test_all_holds_every_jax_name():
    assert set(vnlb_tpu.__all__) <= set(vt.__all__)
    for name in vt.__all__:
        assert callable(getattr(vt, name)) or isinstance(getattr(vt, name),
                                                         tuple)


def test_denoise_mod_matches_jax():
    clean = synthetic_video(3, 40, 40, seed=7)
    noisy = add_noise(clean, 20.0, seed=8)
    deno, basic, sec = vt.denoise_mod(noisy, 20.0, device="cpu")
    jdeno, jbasic, _ = vnlb_tpu.denoise_mod(noisy, 20.0)
    assert sec > 0 and deno.device.type == "cpu"
    for got, want in ((basic, jbasic), (deno, jdeno)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == noisy.shape and np.isfinite(got).all()
        dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
        assert dpsnr < 0.02, dpsnr
        mad = np.abs(got - want).mean()
        assert mad < 0.25, mad
    assert compute_psnr(deno.numpy(), clean) > \
        compute_psnr(noisy, clean) + 2.0


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_cached_results_read_across_packages(tmp_path, monkeypatch, writer,
                                             reader):
    """Both packages keep one result cache (``VNLB_TPU_CACHE``): what one
    writes, the other's ``proc_nn`` / ``proc_nl_cache`` read back."""
    monkeypatch.setenv("VNLB_TPU_CACHE", str(tmp_path))
    save = {"jax": jvideo_io, "torch": video_io}[writer].save_result_sequence
    pkg = {"jax": vnlb_tpu, "torch": vt}[reader]
    seq = synthetic_video(2, 32, 32, seed=9)
    save(seq, "udvd", "set8", "clipA", 20)
    np.testing.assert_allclose(pkg.proc_nn("udvd", "set8", "clipA", 20), seq,
                               atol=1e-5)
    assert pkg.proc_nn("pacnet", "set8", "clipA", 20) is None
    assert pkg.proc_nl_cache("set8", "clipA", 20) is None
    save(seq, "vnlb", "set8", "clipA", 20)
    np.testing.assert_allclose(pkg.proc_nl_cache("set8", "clipA", 20), seq,
                               atol=1e-5)
    np.testing.assert_array_equal(pkg.proc_nn("vnlb", "set8", "clipA", 20),
                                  pkg.proc_nl_cache("set8", "clipA", 20))


def test_proc_nn_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown nn model"):
        vt.proc_nn("nope", "set8", "clipA", 20)


def test_cache_root_follows_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("VNLB_TPU_CACHE", str(tmp_path))
    assert video_io.cache_root() == jvideo_io.cache_root() == tmp_path
    monkeypatch.delenv("VNLB_TPU_CACHE")
    assert video_io.cache_root() == jvideo_io.cache_root()


def test_denoise_verbose_and_gpuid(capsys):
    noisy = add_noise(synthetic_video(3, 40, 40, seed=0), 20.0, seed=1)
    deno, _, _ = vt.denoise(noisy, 20.0, verbose=True, gpuid=3,
                            device="cpu")
    quiet, _, _ = vt.denoise(noisy, 20.0, device="cpu")
    assert "[vnlb_tpu_torch] preset=iphone sigma=20.0" in \
        capsys.readouterr().out
    assert torch.equal(deno, quiet)


def test_streaming_verbose_prints_each_window(capsys):
    noisy = add_noise(synthetic_video(5, 40, 40, seed=0), 20.0, seed=1)
    vt.denoise_streaming(noisy, 20.0, chunk=3, verbose=True, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "streamed frames" in ln]
    assert len(lines) == 4      # two windows in each of the two passes
    assert lines[0].startswith("[vnlb_tpu_torch] pass 0 streamed frames 0:3")
