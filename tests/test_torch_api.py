"""The port's entry points leave the caller's global state as they found
it: ``denoise``, ``denoise_streaming`` and ``denoise_pipelined`` turn TF32
off for their own matrix products and restore both of the caller's flags
on exit, also when the call raises (``vnlb_tpu.denoise`` sets no global)."""

import pytest
import torch

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.parallel.pipe import denoise_pipelined
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.precision import full_f32

torch.set_num_threads(2)

FLAGS = [(True, True), (True, False), (False, True)]


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def set_flags():
    """Sets both flags for the test and puts the originals back after."""
    saved = _flags()

    def put(matmul, cudnn):
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn

    yield put
    put(*saved)


@pytest.fixture(scope="module")
def noisy():
    return add_noise(synthetic_video(4, 64, 72, seed=0), 20.0, seed=1)


def _entries(noisy):
    return {
        "denoise": lambda: vt.denoise(noisy, 20.0, device="cpu"),
        "denoise_streaming": lambda: vt.denoise_streaming(
            noisy, 20.0, chunk=2, device="cpu"),
        "denoise_pipelined": lambda: denoise_pipelined(
            noisy, 20.0, chunk=2, devices=("cpu", "cpu")),
    }


@pytest.mark.parametrize("entry", ["denoise", "denoise_streaming",
                                   "denoise_pipelined"])
def test_entry_restores_tf32_flags(set_flags, noisy, entry):
    set_flags(True, True)
    deno, basic, _ = _entries(noisy)[entry]()
    assert _flags() == (True, True)
    assert deno.shape == noisy.shape and basic.shape == noisy.shape


@pytest.mark.parametrize("entry", ["denoise", "denoise_streaming",
                                   "denoise_pipelined"])
def test_entry_restores_tf32_flags_when_it_raises(set_flags, noisy, entry):
    set_flags(True, True)
    calls = {
        "denoise": lambda: vt.denoise(noisy, 20.0, preset="nope",
                                      device="cpu"),
        "denoise_streaming": lambda: vt.denoise_streaming(
            noisy, 20.0, preset="nope", device="cpu"),
        "denoise_pipelined": lambda: denoise_pipelined(
            noisy, 20.0, preset="nope", devices=("cpu", "cpu")),
    }
    with pytest.raises(ValueError):
        calls[entry]()
    assert _flags() == (True, True)


@pytest.mark.parametrize("matmul,cudnn", FLAGS)
def test_full_f32_inside_and_restored(set_flags, matmul, cudnn):
    set_flags(matmul, cudnn)
    with full_f32():
        assert _flags() == (False, False)
    assert _flags() == (matmul, cudnn)
    with pytest.raises(RuntimeError):
        with full_f32():
            raise RuntimeError("inside")
    assert _flags() == (matmul, cudnn)
