"""``denoise_streaming`` of the port on the CPU: the clip and config of
tests/test_streaming.py (13x48x48, nwt 1, chunk=3), held to the port's own
``denoise`` with that file's bounds and to ``vnlb_tpu.denoise_streaming``
within 0.02 dB; the rolling stream at nwt 2, chunk 2 (a live window of 7
of the 13 frames) with flows, preset ``default``, mask borders and the
all-rows search against ``denoise`` with those bounds; every site accumulated once; the
live frames bounded and flat in the clip's length; the slab fold and the
slab searches against their whole-clip forms."""

import numpy as np
import pytest
import torch

from vnlb_tpu.api import denoise_streaming as j_streaming
from vnlb_tpu.config import default_config as j_default_config

import vnlb_tpu_torch as vt
from vnlb_tpu_torch import pipeline
from vnlb_tpu_torch.ops import agg
from vnlb_tpu_torch.ops.mask import lattice_sites
from vnlb_tpu_torch.ops.search import exec_search
from vnlb_tpu_torch.ops.search_dense import exec_search_dense
from vnlb_tpu_torch.pipeline import plan_sites, prep_flows
from vnlb_tpu_torch.streaming import live_slots, stream_pass
from vnlb_tpu_torch.testing.data import add_noise, drift_flows, synthetic_video
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



# the rolling stream where the live window is a strict sub-window of the
# clip: nwt 2, chunk 2 (at most 2 + 2 + 2 + 1 = 7 live frames of 13, or of
# the 10 of the short clip)
NWT2 = dict(nwt_f=[2, 2], nwt_b=[2, 2])


@pytest.fixture(scope="module")
def short():
    clean = synthetic_video(10, 40, 40, seed=7)
    return clean, add_noise(clean, 20.0, seed=8)
CASES = {
    "iphone": dict(),
    "drift": dict(),
    "default": dict(preset="default"),
    "mask": dict(border_mode="mask"),
    "dense_full": dict(dense_rows="full"),
}


def _flows(case, noisy):
    return drift_flows(*noisy.shape[:1], *noisy.shape[2:]) \
        if case == "drift" else None


@pytest.mark.parametrize("case", sorted(CASES))
def test_rolling_stream_matches_denoise(clip, case):
    clean, noisy = clip
    cfg = vt.default_config(20.0, **NWT2, **CASES[case])
    flows = _flows(case, noisy)
    d_s, b_s, _ = vt.denoise_streaming(noisy, 20.0, chunk=2, flows=flows,
                                       cfg=cfg, device="cpu")
    d_m, b_m, _ = vt.denoise(noisy, 20.0, flows=flows, cfg=cfg, device="cpu")
    for got, want, top in ((b_s, b_m.numpy(), 5e-2), (d_s, d_m.numpy(),
                                                       1.2e-1)):
        diff = np.abs(got - want)
        assert diff.max() < top and diff.mean() < 1e-3, (diff.max(),
                                                          diff.mean())
    assert abs(compute_psnr(d_s, clean) - compute_psnr(d_m.numpy(), clean)) \
        < 0.01


@pytest.mark.parametrize("case", ["iphone", "drift"])
def test_stream_accumulates_every_site_once(short, case, monkeypatch):
    """Each pass hands every site of the whole clip's lattice to
    ``accumulate`` exactly once (global frames from the slab's ``t0``), and
    the counters say so."""
    _, noisy = short
    cfg = vt.default_config(20.0, **NWT2)
    flows = _flows(case, noisy)
    seen = {0: [], 1: []}
    real = pipeline.accumulate

    def record(*args, live=None, **kw):
        sites, scfg = args[5], args[7]
        seen[scfg.step].append(sites.numpy() + [live.t0, 0, 0])
        return real(*args, live=live, **kw)

    monkeypatch.setattr(pipeline, "accumulate", record)
    for k in ("steps", "sites", "live_frames"):
        setattr(stream_pass, k, 0)
    vt.denoise_streaming(noisy, 20.0, chunk=2, flows=flows, cfg=cfg,
                         device="cpu")
    zero = flows is None
    want_sites = 0
    for step in (0, 1):
        scfg = cfg.stage(step)
        want, _ = plan_sites(noisy.shape, scfg, zero)
        got = np.concatenate(seen[step])
        assert len(got) == len(want)
        assert len(np.unique(got, axis=0)) == len(got)
        np.testing.assert_array_equal(np.unique(got, axis=0),
                                      np.unique(want, axis=0))
        assert len(seen[step]) == -(-(noisy.shape[0] - scfg.pt + 1) // 2)
        want_sites += len(want)
    assert stream_pass.sites == want_sites
    assert stream_pass.steps == len(seen[0]) + len(seen[1])


def test_live_frames_bounded_and_flat():
    """The live accumulator holds at most chunk + nwt_b + nwt_f + pt - 1
    frames, and as many at 26 frames as at 13."""
    cfg = vt.default_config(20.0, **NWT2)
    most = []
    for t_len in (13, 26):
        noisy = add_noise(synthetic_video(t_len, 40, 40, seed=3), 20.0,
                          seed=4)
        stream_pass.live_frames = 0
        vt.denoise_streaming(noisy, 20.0, chunk=2, cfg=cfg, device="cpu")
        most.append(stream_pass.live_frames)
    bound = max(live_slots(cfg.stage(i), 10 ** 6, 2) for i in (0, 1))
    assert bound == 2 + 2 + 2 + 1
    assert most[0] == most[1] <= bound


@pytest.mark.parametrize("pt", [1, 2, 3])
def test_fold_slab_is_fold(pt):
    """``fold_slab`` over consecutive pieces of the rows, its carry handed
    on, gives ``fold``'s frames bit for bit (pieces of 1 frame too)."""
    t_len, c, h, w, ps = 7, 3, 12, 11, 3
    hp, wp = h - ps + 1, w - ps + 1
    acc = torch.from_numpy(np.random.default_rng(pt).normal(
        size=(t_len * hp * wp, pt * c * ps * ps + 1)).astype(np.float32))
    want = agg.fold(acc, pt, ps, (t_len, c, h, w))
    carry, got = None, []
    for a, b in ((0, 2), (2, 3), (3, 7)):
        d, wt, carry = agg.fold_slab(acc[a * hp * wp:b * hp * wp], pt, ps,
                                     (b - a, c, h, w), carry)
        got.append((d, wt))
    assert torch.equal(torch.cat([g[0] for g in got]), want[0])
    assert torch.equal(torch.cat([g[1] for g in got]), want[1])


@pytest.mark.parametrize("mode", ["gather", "dense", "dense_full"])
def test_slab_search_sees_the_clip(short, mode):
    """A search on a slab of frames told the clip's bounds finds, for the
    sites of its step, the candidates of the whole-clip search bit for
    bit (indices shifted by the slab's first frame)."""
    _, noisy = short
    # the dense modes under mask borders: every lattice site takes them
    over = {"gather": {}, "dense": dict(border_mode="mask"),
            "dense_full": dict(border_mode="mask", dense_rows="full")}[mode]
    cfg = vt.default_config(20.0, **NWT2, **over).stage(1)
    yuv = torch.from_numpy(noisy)
    shape = tuple(yuv.shape)
    sites = torch.from_numpy(lattice_sites(shape, cfg)).long()
    chw = shape[1] * shape[2] * shape[3]
    for s0, s1 in ((0, 2), (4, 6), (7, 9)):
        lo, hi = max(0, s0 - 2), min(shape[0], s1 - 1 + 2 + cfg.pt)
        mine = sites[(sites[:, 0] >= s0) & (sites[:, 0] < s1)]
        local = mine - torch.tensor([lo, 0, 0])
        if mode == "gather":
            ff, bf, _ = prep_flows(shape, drift_flows(shape[0], shape[2],
                                                      shape[3]))
            want = exec_search(yuv, mine, ff, bf, cfg)
            got = exec_search(yuv[lo:hi], local, ff[lo:hi], bf[lo:hi], cfg,
                              t_bounds=(lo, shape[0]))
        else:
            want = exec_search_dense(yuv, mine, cfg)
            got = exec_search_dense(yuv[lo:hi], local, cfg,
                                    t_bounds=(lo, shape[0]))
        assert torch.equal(got[0], want[0])
        shifted = torch.where(got[1] >= 0, got[1] + lo * chw, got[1])
        assert torch.equal(shifted, want[1])
