"""The port's other parallel paths on the CPU, in one gloo world of 2 ranks
(``run_world``, one thread per rank):

* ``denoise_sharded`` (site parallelism) against JAX's ``denoise_sharded``
  on a 2-device mesh and against the port's single-device ``denoise``; a
  repeat in the same world is bitwise;
* ``bayes_denoise_tp`` (the filter batch split, padded 21 -> 22) against
  the unsplit ``bayes_denoise`` and against JAX's ``bayes_denoise_tp`` on
  a 2-device mesh;
* ``denoise_streaming(mesh=...)`` against JAX's on a 2-device mesh and
  against the port's one-device streaming;
* ``denoise_pipelined(devices=("cpu", "cpu"))`` bitwise against the port's
  ``denoise_streaming``, and against JAX's ``denoise_pipelined`` over two
  CPU devices.
"""

import jax
import numpy as np
import pytest
import torch

import vnlb_tpu
import vnlb_tpu.config as jcfg
from vnlb_tpu.parallel.pipe import denoise_pipelined as j_denoise_pipelined
from vnlb_tpu.parallel.tiled import denoise_sharded as j_denoise_sharded
from vnlb_tpu.parallel.tiled import make_mesh as j_make_mesh
from vnlb_tpu.parallel.tp import bayes_denoise_tp as j_bayes_denoise_tp

import vnlb_tpu_torch as vt
from vnlb_tpu_torch.config import config_from_jax
from vnlb_tpu_torch.ops.bayes import bayes_denoise
from vnlb_tpu_torch.parallel.launch import run_world, sequence
from vnlb_tpu_torch.parallel.pipe import denoise_pipelined
from vnlb_tpu_torch.parallel.tiled import denoise_sharded
from vnlb_tpu_torch.parallel.tp import bayes_denoise_tp, c_major
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
from vnlb_tpu_torch.utils.metrics import compute_psnr

torch.set_num_threads(2)


def _near_jax(got, want, clean):
    """tests/test_torch_pipeline.py's port-vs-JAX bound of a pass."""
    dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
    assert dpsnr < 0.02, dpsnr
    assert np.abs(got - want).mean() < 0.25


def _assert_close(got, want):
    """tests/test_halo.py's bound: near-tie top-K swaps only."""
    diff = np.abs(got - want)
    assert diff.max() < 0.5, diff.max()
    assert diff.mean() < 0.02, diff.mean()


@pytest.fixture(scope="module")
def sharded_clip():
    """tests/test_sharding.py's clip."""
    clean = synthetic_video(2, 32, 32, seed=2)
    return clean, add_noise(clean, 20.0, seed=3)


@pytest.fixture(scope="module")
def stream_clip():
    """tests/test_streaming.py:70's config, cut to 8x48x48: windows of
    chunk 3, nwt 1, mask borders; two strips of 24 rows."""
    clean = synthetic_video(8, 48, 48, seed=9)
    noisy = add_noise(clean, 20.0, seed=10)
    kw = dict(preset="iphone", nwt_f=[1, 1], nwt_b=[1, 1],
              border_mode=["mask", "mask"])
    return clean, noisy, kw


def _groups(step, b=21, k=40, c=3, ps=7, sigma=20.0):
    """tests/test_tp.py's groups, pt frames deep as the stage's patches."""
    pt = vt.default_config(20.0).stage(step).pt
    rng = np.random.default_rng(step * 10 + b)
    base = rng.normal(size=(b, 1, pt, c, ps, ps)) * 30 + 128
    pn = base + rng.normal(size=(b, k, pt, c, ps, ps)) * sigma
    pb = base + rng.normal(size=(b, k, pt, c, ps, ps)) * (sigma / 4)
    flat = np.zeros((b,), bool)
    flat[::5] = step == 1
    return pn.astype(np.float32), pb.astype(np.float32), flat


@pytest.fixture(scope="module")
def world(sharded_clip, stream_clip):
    """One 2-rank world: every rank's results of each call, by name."""
    _, noisy = sharded_clip
    _, s_noisy, kw = stream_clip
    calls = [("sharded", denoise_sharded, (noisy, 20.0), {}),
             ("sharded_again", denoise_sharded, (noisy, 20.0), {}),
             ("stream", vt.denoise_streaming, (s_noisy, 20.0),
              dict(chunk=3, cfg=vt.default_config(20.0, **kw)))]
    for step in (0, 1):
        pn, pb, flat = _groups(step)
        cfg = vt.default_config(20.0).stage(step)
        calls.append((f"tp{step}", bayes_denoise_tp,
                      (pn, pb if step else None, flat if step else None,
                       cfg), {}))
    ranks = run_world(sequence, 2, device="cpu", threads=1,
                      args=([(fn, a, k) for _, fn, a, k in calls],))
    return {name: [r[i][0] for r in ranks]
            for i, (name, _, _, _) in enumerate(calls)}


def test_denoise_sharded_matches_jax(sharded_clip, world):
    clean, noisy = sharded_clip
    deno, basic = world["sharded"][0]
    assert deno.shape == noisy.shape and np.isfinite(deno).all()
    jdeno, jbasic = j_denoise_sharded(noisy, 20.0, mesh=j_make_mesh(2))
    _near_jax(basic, np.asarray(jbasic), clean)
    _near_jax(deno, np.asarray(jdeno), clean)
    # the same sums in another order as the single-device pass
    sdeno, sbasic, _ = vt.denoise(noisy, 20.0, device="cpu")
    _assert_close(basic, sbasic.numpy())
    _assert_close(deno, sdeno.numpy())


def test_denoise_sharded_repeat_is_bitwise(world):
    for rank in (0, 1):
        for a, b in zip(world["sharded"][rank], world["sharded_again"][rank]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(world["sharded"][0], world["sharded"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("step", [0, 1])
def test_bayes_tp_matches_unsplit(world, step):
    """The split filter equals the whole batch's filter group by group
    (CPU batched products may round differently with the batch size)."""
    pn, pb, flat = _groups(step)
    cfg = vt.default_config(20.0).stage(step)
    want, rv_want = bayes_denoise(
        c_major(torch.from_numpy(pn)),
        c_major(torch.from_numpy(pb)) if step else None,
        torch.from_numpy(flat) if step else None, cfg)
    for out, rv in world[f"tp{step}"]:
        assert out.shape == tuple(want.shape)
        np.testing.assert_allclose(out, want.numpy(), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(rv, rv_want.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("step", [0, 1])
def test_bayes_tp_matches_jax(world, step):
    """Against JAX's split filter on a 2-device mesh, at
    tests/test_torch_filter.py's bound of the port's filter against JAX's
    (relative rms < 5e-3 with bf16-rounded products, rank variances to
    1e-4)."""
    pn, pb, flat = _groups(step)
    jc = jcfg.default_config(20.0).stage(step)
    assert config_from_jax(jc) == vt.default_config(20.0).stage(step)
    want, rv_want = j_bayes_denoise_tp(pn, pb if step else None,
                                       flat if step else None, jc,
                                       j_make_mesh(2, axis="groups"))
    want, rv_want = np.asarray(want), np.asarray(rv_want)
    bound = 5e-3 if jc.poly_bf16 else 1e-5
    for out, rv in world[f"tp{step}"]:
        assert out.shape == want.shape
        rms = np.sqrt(np.mean((out - want) ** 2)) / np.abs(want).mean()
        assert rms < bound, rms
        np.testing.assert_allclose(rv, rv_want, rtol=1e-4)


def test_streaming_mesh_matches_jax(stream_clip, world):
    clean, noisy, kw = stream_clip
    deno, basic, _ = world["stream"][0]
    assert deno.shape == noisy.shape and np.isfinite(deno).all()
    jdeno, jbasic, _ = vnlb_tpu.denoise_streaming(
        noisy, 20.0, chunk=3, mesh=j_make_mesh(2, axis="h"),
        cfg=vnlb_tpu.default_config(20.0, bsize=[32, 32], **kw))
    _near_jax(basic, jbasic, clean)
    _near_jax(deno, jdeno, clean)
    sdeno, sbasic, _ = vt.denoise_streaming(
        noisy, 20.0, chunk=3, cfg=vt.default_config(20.0, **kw),
        device="cpu")
    _assert_close(basic, sbasic)
    _assert_close(deno, sdeno)


@pytest.fixture(scope="module")
def pipe_clip():
    """6 frames in chunks of 2 (pass 2 lags by 2 chunks), 32x32, nwt 1:
    (clean, noisy, config kwargs, the port's pipelined (deno, basic))."""
    clean = synthetic_video(6, 32, 32, seed=4)
    noisy = add_noise(clean, 20.0, seed=5)
    kw = dict(nwt_f=[1, 1], nwt_b=[1, 1])
    deno, basic, sec = denoise_pipelined(noisy, 20.0, chunk=2,
                                         cfg=vt.default_config(20.0, **kw),
                                         devices=("cpu", "cpu"))
    assert sec > 0
    return clean, noisy, kw, deno, basic


def test_pipelined_equals_streaming(pipe_clip):
    _, noisy, kw, deno, basic = pipe_clip
    sdeno, sbasic, _ = vt.denoise_streaming(
        noisy, 20.0, chunk=2, cfg=vt.default_config(20.0, **kw),
        device="cpu")
    np.testing.assert_array_equal(basic, sbasic)
    np.testing.assert_array_equal(deno, sdeno)


def test_pipelined_matches_jax(pipe_clip):
    """JAX's pipelined run, pass 1 and pass 2 on two CPU devices."""
    clean, noisy, kw, deno, basic = pipe_clip
    devs = jax.devices()
    jdeno, jbasic, _ = j_denoise_pipelined(
        noisy, 20.0, chunk=2, cfg=jcfg.default_config(20.0, **kw),
        devices=(devs[0], devs[1]))
    _near_jax(basic, np.asarray(jbasic), clean)
    _near_jax(deno, np.asarray(jdeno), clean)


def test_pipelined_meshes_not_ported():
    noisy = np.zeros((4, 3, 32, 32), np.float32)
    with pytest.raises(NotImplementedError, match="item 17"):
        denoise_pipelined(noisy, 20.0, meshes=(None, None))
