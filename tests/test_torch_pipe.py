"""The port's ``denoise_pipelined(meshes=...)`` (PP x SP) on the CPU.

tests/test_pipe.py:39's clip and config (8x28x56, nwt 1, mask borders,
chunk 2) in a gloo world of 4 ranks (``run_world``, one thread per rank):
2 stages x 2 H strips from ``stage_meshes``.  Every rank returns the same
output, which is

* bitwise the port's ``denoise_streaming(mesh=...)`` in a 2-rank world at
  one thread per rank (each stage runs that program for its pass);
* within the port-vs-JAX bounds of a pass (tests/test_torch_pipeline.py:
  0.02 dB, mean |d| < 0.25) of JAX's ``denoise_pipelined(meshes=(m1,
  m2))`` on 2 + 2 CPU devices;
* within tests/test_halo.py's bound (near-tie top-K swaps) of the port's
  one-process ``denoise_pipelined(devices=("cpu", "cpu"))``.

``stage_meshes`` refuses stage sizes that miss the world or leave a stage
empty, and ``schedule`` holds JAX's windows and dispatch rule.
"""

import jax
import numpy as np
import pytest
import torch

import vnlb_tpu.config as jcfg
from vnlb_tpu.parallel.pipe import _windows as j_windows
from vnlb_tpu.parallel.pipe import denoise_pipelined as j_denoise_pipelined
from vnlb_tpu.parallel.tiled import make_mesh as j_make_mesh

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.parallel.comm import Mesh
from vnlb_tpu_torch.parallel.launch import run_world, sequence
from vnlb_tpu_torch.parallel.pipe import (denoise_pipelined, pipelined_world,
                                          schedule, stage_meshes)
from vnlb_tpu_torch.streaming import windows
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)

CHUNK = 2
# tests/test_pipe.py:13-18's _small_cfg
SMALL = dict(preset="iphone", nwt_b=[1, 1], nwt_f=[1, 1], npatches=[12, 10],
             bsize=[64, 64], border_mode=["mask", "mask"])


@pytest.fixture(scope="module")
def clip():
    clean = synthetic_video(8, 28, 56, seed=4)
    return clean, add_noise(clean, 20.0, seed=5)


@pytest.fixture(scope="module")
def pipe_world(clip):
    """Each rank's (deno, basic, seconds, stats) of the 4-rank world."""
    _, noisy = clip
    ranks = run_world(sequence, 4, device="cpu", threads=1, args=(
        [(pipelined_world, (noisy, 20.0),
          dict(sizes=(2, 2), chunk=CHUNK, cfg=vt.default_config(20.0,
                                                                **SMALL)))],))
    return [r[0][0] for r in ranks]


def test_pipelined_meshes_ranks_agree(clip, pipe_world):
    _, noisy = clip
    deno, basic, sec, _ = pipe_world[0]
    assert deno.shape == noisy.shape and np.isfinite(deno).all()
    assert sec > 0
    for d, b, s, _ in pipe_world[1:]:
        np.testing.assert_array_equal(d, deno)
        np.testing.assert_array_equal(b, basic)
        assert s == sec


def test_pipelined_meshes_stats(clip, pipe_world):
    """Stages 1, 1, 2, 2; each stage-1 rank sends every basic frame once
    (one peer each), each stage-2 rank receives every frame once."""
    _, noisy = clip
    stats = [r[3] for r in pipe_world]
    assert [s["stage"] for s in stats] == [1, 1, 2, 2]
    for s in stats:
        assert s["edge_bytes"] == noisy.nbytes
        assert s["busy_s"] > 0 and s["edge_s"] >= 0


def test_pipelined_meshes_equals_streaming_mesh(clip, pipe_world):
    """Bitwise the 2-rank denoise_streaming(mesh=...) of the same clip."""
    _, noisy = clip
    ranks = run_world(sequence, 2, device="cpu", threads=1, args=(
        [(vt.denoise_streaming, (noisy, 20.0),
          dict(chunk=CHUNK, cfg=vt.default_config(20.0, **SMALL)))],))
    sdeno, sbasic, _ = ranks[0][0][0]
    deno, basic, _, _ = pipe_world[0]
    np.testing.assert_array_equal(basic, sbasic)
    np.testing.assert_array_equal(deno, sdeno)


def test_pipelined_meshes_matches_jax(clip, pipe_world):
    clean, noisy = clip
    devs = jax.devices()
    assert len(devs) >= 4, "conftest provisions an 8-device CPU mesh"
    m1 = j_make_mesh(axis="h", devices=devs[:2])
    m2 = j_make_mesh(axis="h", devices=devs[2:4])
    jdeno, jbasic, _ = j_denoise_pipelined(
        noisy, 20.0, chunk=CHUNK, cfg=jcfg.default_config(20.0, **SMALL),
        meshes=(m1, m2))
    deno, basic, _, _ = pipe_world[0]
    for got, want in ((basic, np.asarray(jbasic)), (deno, np.asarray(jdeno))):
        dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
        assert dpsnr < 0.02, dpsnr
        assert np.abs(got - want).mean() < 0.25


def test_pipelined_meshes_near_devices(clip, pipe_world):
    """The halo split against the one-process pipeline: near-tie top-K
    swaps only (max 0.5, mean 0.02 gray levels)."""
    _, noisy = clip
    ddeno, dbasic, _ = denoise_pipelined(
        noisy, 20.0, chunk=CHUNK, cfg=vt.default_config(20.0, **SMALL),
        devices=("cpu", "cpu"))
    deno, basic, _, _ = pipe_world[0]
    for got, want in ((basic, dbasic), (deno, ddeno)):
        diff = np.abs(got - want)
        assert diff.max() < 0.5, diff.max()
        assert diff.mean() < 0.02, diff.mean()


@pytest.mark.parametrize("world,sizes", [(4, (2, 1)), (4, (3, 2)),
                                         (4, (4, 0)), (4, (0, 4)),
                                         (2, (2, 0))])
def test_stage_meshes_refuses(world, sizes):
    """Checked before any group is made, so no world is needed."""
    mesh = Mesh(None, 0, world, torch.device("cpu"))
    with pytest.raises(ValueError, match="stage"):
        stage_meshes(mesh, sizes)


def _jax_dispatch(t_len, chunk, ctx1, ctx2):
    """vnlb_tpu/parallel/pipe.py:130-143's loop over JAX's windows: the
    pass-2 windows dispatched after each pass-1 chunk is drained."""
    w1, w2 = j_windows(t_len, chunk, ctx1), j_windows(t_len, chunk, ctx2)
    out, p2_next = [], 0
    for j in range(len(w1)):
        basic_final = w1[j][1]
        ready = []
        while p2_next < len(w2) and basic_final >= w2[p2_next][3]:
            ready.append(p2_next)
            p2_next += 1
        out.append(ready)
    return out


@pytest.mark.parametrize("t_len,chunk,ctx1,ctx2", [
    (8, 2, 2, 3), (12, 3, 2, 3), (24, 4, 4, 5), (13, 4, 6, 7),
    (4, 8, 2, 3), (30, 5, 1, 12)])
def test_schedule_matches_jax(t_len, chunk, ctx1, ctx2):
    w1, w2 = windows(t_len, chunk, ctx1), windows(t_len, chunk, ctx2)
    assert w1 == j_windows(t_len, chunk, ctx1)
    assert w2 == j_windows(t_len, chunk, ctx2)
    sched = schedule(w1, w2)
    assert sched == _jax_dispatch(t_len, chunk, ctx1, ctx2)
    assert sorted(i for r in sched for i in r) == list(range(len(w2)))
    # JAX's lag (pipe.py:98): a window whose context is not clipped by the
    # clip's ends starts L = ceil(ctx2 / chunk) chunks after its own
    lag = max(1, -(-ctx2 // chunk))
    win = min(t_len, chunk + 2 * ctx2)
    for j, ready in enumerate(sched):
        for i in ready:
            start, _, lo, _ = w2[i]
            if lo == start - ctx2 and lo + win < t_len:
                assert j - i == lag, (i, j, lag)
