#!/usr/bin/env python3
"""Measure how far the port's estimated flows, reference-order pass and
aggregation modes lie from ``vnlb_tpu`` on the CPU: the numbers behind the
tolerances of tests/test_torch_{flow_est,compat,agg_modes}.py.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/torch_cpu_parity.py

Prints one line each: the flow helpers and one / 25 TV-L1 inner steps
(max |d|), ``tvl1_flow`` and ``lk_flow`` on a clean 72x72 pair, on each
forward pair of the noisy 5x72x72 drift clip (seed 11, motion 4, noise
seed 12) and on a noisy 480x854 pair (mean and max |d| in px); then
``denoise_compat`` of the 3x48x48 clip (bsize 64; PSNR of basic and deno
in both packages, sites drawn per batch) and the share of lattice sites
of a 5x96x112 clip among their own matches; then the API-default
``denoise`` of the 4x40x48 clip in each aggregation mode (PSNR gap and
mean |d| in gray levels).  Takes ~2 minutes on 4 threads.  Then (section
``oracle``, ~2 minutes more) the port and ``vnlb_tpu`` against the C++
oracle (``vnlb_tpu_torch.testing.oracle``) and the NumPy oracle
(``testing/npref.py``): the gather search on tests/test_oracle.py's l2
inputs, one stage-0 pass on its 3x32x32 clip, the Bayes filter at both
steps against npref, the oracle's seconds, and both passes of the
3x48x48 clip (``synthetic_video(3, 48, 48, seed=0)``, noise seed 1) in
scripts/compare_oracle.py's config, with ``agg_k=0, cols_bf16=False`` and
with ``eig_method="poly"`` (PSNR of basic / deno and the mean relative
error of each pass).  Section ``small_f32`` (~4 minutes) prints
``vnlb_tpu``'s and the port's PSNRs of basic / deno on chip_smoke.py's
small clip (``synthetic_video(5, 96, 112, seed=0)``, noise seed 1) for the
filter modes without ``poly_bf16`` (``poly_bf16=False``, and with
``poly_econ=False``): chip_smoke.py's ``REF_SMALL_MODES`` constants for
them.  Section ``small_couple`` (~5 minutes) prints the same for the
port's ``poly_impl="pallas", couple_channels=True`` beside ``vnlb_tpu``'s
plain version of that function (``couple_channels=True, poly_econ=False,
poly_fused=False``: the Pallas call has no CPU mode).  Section
``small_f5`` prints the same for four filter modes: ``poly_impl="pallas",
poly_bf16=False``, ``couple_channels=True, poly_bf16=False``, both
together, and preset ``default`` with ``couple_channels=True`` (each
``poly_impl="pallas"`` mode beside ``vnlb_tpu``'s plain version of the
same function, as above): chip_smoke.py's ``REF_SMALL_MODES`` constants
``poly_pallas_f32``, ``couple_f32``, ``poly_pallas_couple_f32`` and
``default_couple``.  Section ``small_default`` prints the same for preset
``default`` in four filter modes: ``poly_impl="pallas"`` with and without
``poly_bf16`` (beside ``vnlb_tpu``'s plain version), ``poly_bf16=False``
and ``poly_econ=False, poly_bf16=False``: chip_smoke.py's
``REF_SMALL_MODES`` constants ``default_pallas``, ``default_pallas_f32``,
``default_f32`` and ``default_econ_off_f32``.  Section ``f5_480p`` (~5
minutes, ~14 GB) prints ``vnlb_tpu``'s PSNRs of noisy, basic and deno and
the port's of basic and deno for preset ``default`` with
``couple_channels=True``
(``vnlb_tpu`` with ``topk="stream"``, equal to the one-shot top-K with far
less peak memory) on the small clip and on rows 208:272 (``F5_ROWS``) of
chip_smoke.py's 480p clip (``synthetic_video(5, 480, 854, seed=0)``, noise
seed 1) at full width: chip_smoke.py's ``REF_BAND_DEFAULT_COUPLE``, the
witness of its ``e2e_default_couple`` gain floor (``E2E_GAIN_DB``).
Arguments name the sections to run (``flows``, ``compat``,
``self_match``, ``modes``, ``oracle``, ``small_f32``, ``small_couple``,
``small_f5``, ``small_default``, ``f5_480p``; all but ``f5_480p`` by
default).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import vnlb_tpu  # noqa: E402
import vnlb_tpu.compat as jcompat  # noqa: E402
from vnlb_tpu.ops import flow as jf  # noqa: E402
from vnlb_tpu.ops.bayes import bayes_denoise as j_bayes  # noqa: E402

import vnlb_tpu_torch as vt  # noqa: E402
import vnlb_tpu_torch.compat as tcompat  # noqa: E402
from vnlb_tpu_torch.ops import flow as tf  # noqa: E402
from vnlb_tpu_torch.ops.bayes import bayes_denoise as t_bayes  # noqa: E402
from vnlb_tpu_torch.ops.search import exec_search  # noqa: E402
from vnlb_tpu_torch.testing import npref  # noqa: E402
from vnlb_tpu_torch.testing import oracle as orc  # noqa: E402
from vnlb_tpu_torch.testing.data import add_noise, synthetic_video  # noqa
from vnlb_tpu_torch.utils.metrics import compute_psnr  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _d(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    return f"max={d.max():.3g} mean={d.mean():.3g}"


def flows():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (23, 37)).astype(np.float32)
    u = rng.normal(0, 2, (23, 37)).astype(np.float32)
    v = rng.normal(0, 2, (23, 37)).astype(np.float32)
    print("[helpers]", "box", _d(tf._box(_t(x), 4), jf._box(x, 4)),
          "| warp", _d(tf._warp(_t(x), _t(u), _t(v)), jf._warp(x, u, v)),
          "| blur", _d(tf._blur121(_t(x)), jf._blur121(x)),
          "| div", _d(tf._div(_t(u), _t(v)), jf._div(u, v)),
          "| resize 11x19->23x39", _d(
              tf._upsample(_t(x[:11, :19]), (23, 39)),
              jax.image.resize(jnp.asarray(x[:11, :19]), (23, 39),
                               "bilinear")), flush=True)
    vid = synthetic_video(2, 72, 72, seed=11, motion=4.0)
    g0, g1 = (jnp.mean(jnp.asarray(f), axis=0) for f in vid)
    z = jnp.zeros_like(g0)
    for iters in (1, 25):
        want = jf._tvl1_level(g0, g1, z, z, 0.15, 0.3, 0.25, 1, iters)
        got = tf._tvl1_level(_t(g0), _t(g1), _t(z), _t(z), 0.15, 0.3, 0.25,
                             1, iters)
        print(f"[tvl1_level] warps=1 iters={iters}", _d(got[0], want[0]),
              flush=True)
    for name, t_fn, j_fn in (("tvl1", tf.tvl1_flow, jf.tvl1_flow),
                             ("lk", tf.lk_flow, jf.lk_flow)):
        print(f"[{name}] clean 72x72",
              _d(t_fn(vid[0], vid[1], device="cpu"), j_fn(vid[0], vid[1])),
              flush=True)
        noisy = add_noise(synthetic_video(5, 72, 72, seed=11, motion=4.0),
                          20.0, seed=12)
        for i in range(4):
            print(f"[{name}] noisy 72x72 pair {i}",
                  _d(t_fn(noisy[i], noisy[i + 1], device="cpu"),
                     j_fn(noisy[i], noisy[i + 1])), flush=True)
        big = add_noise(synthetic_video(2, 480, 854, seed=0, motion=4.0),
                        20.0, seed=1)
        print(f"[{name}] noisy 480x854",
              _d(t_fn(big[0], big[1], device="cpu"), j_fn(big[0], big[1])),
              flush=True)


def compat():
    clean = synthetic_video(3, 48, 48, seed=5)
    noisy = add_noise(clean, 20.0, seed=6)
    counts = {}
    for name, mod in (("jax", jcompat), ("port", tcompat)):
        orig, n = mod._update_mask, []

        def counting(mask, inds, valid, shape, boost, nkeep, orig=orig,
                     n=n):
            n.append(int(np.sum(valid)))
            orig(mask, inds, valid, shape, boost, nkeep)

        mod._update_mask = counting
        try:
            if name == "jax":
                d, b = jcompat.denoise_compat(
                    noisy, 20.0,
                    cfg=vnlb_tpu.default_config(20.0, bsize=[64, 64]))
            else:
                d, b = tcompat.denoise_compat(
                    noisy, 20.0, cfg=vt.default_config(20.0, bsize=[64, 64]),
                    device="cpu")
        finally:
            mod._update_mask = orig
        counts[name] = (n, compute_psnr(np.asarray(b), clean),
                        compute_psnr(np.asarray(d), clean))
    (jn, jb, jd), (tn, tb, td) = counts["jax"], counts["port"]
    print(f"[compat] 3x48x48 bsize 64: basic {jb:.6f} / {tb:.6f}, deno "
          f"{jd:.6f} / {td:.6f} (jax / port); sites per batch jax {jn} "
          f"port {tn}", flush=True)


def self_match():
    """The share of lattice sites whose own corner is among their top-K
    matches (the compat pass clears a drawn site only through a match)."""
    from vnlb_tpu_torch.ops import color
    from vnlb_tpu_torch.ops.mask import lattice_sites
    from vnlb_tpu_torch.ops.search import exec_search

    noisy = add_noise(synthetic_video(5, 96, 112, seed=0), 20.0, seed=1)
    yuv = color.rgb2yuv(torch.from_numpy(noisy))
    zf = torch.zeros((5, 2, 96, 112))
    for stage in (0, 1):
        cfg = vt.default_config(20.0).stage(stage)
        sites = lattice_sites(noisy.shape, cfg)
        _, inds = exec_search(yuv, torch.from_numpy(sites), zf, zf, cfg)
        own = (sites[:, 0] * 3 * 96 * 112 + sites[:, 1] * 112
               + sites[:, 2])
        hit = (inds.numpy() == own[:, None]).any(axis=1)
        print(f"[self_match] 5x96x112 stage {stage} ({cfg.stype}): "
              f"{hit.mean():.4f} of {len(sites)} sites", flush=True)


def modes():
    clean = synthetic_video(4, 40, 48, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    for kw in (dict(agg_weight="exp"),
               dict(agg_weight="exp", dense_rows="full"), dict(only_frame=2),
               dict(agg_bf16=True), dict(poly_gram=False)):
        jd, jb, _ = vnlb_tpu.denoise(noisy, 20.0,
                                     cfg=vnlb_tpu.default_config(20.0, **kw))
        d, b, _ = vt.denoise(noisy, 20.0, cfg=vt.default_config(20.0, **kw),
                             device="cpu")
        gaps = [abs(compute_psnr(x.numpy(), clean)
                    - compute_psnr(np.asarray(y), clean))
                for x, y in ((b, jb), (d, jd))]
        mad = [np.abs(x.numpy() - np.asarray(y)).mean()
               for x, y in ((b, jb), (d, jd))]
        print(f"[mode] {kw}: |dPSNR| basic {gaps[0]:.5f} deno {gaps[1]:.5f} "
              f"dB, mean |d| {mad[0]:.4f} / {mad[1]:.4f}", flush=True)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).mean() / (np.abs(want).mean() + 1e-8)


def oracle():
    import time

    zf32 = np.zeros((3, 2, 32, 32), np.float32)
    orc.lib()
    # the gather search on tests/test_oracle.py::test_search_parity_l2's
    # inputs
    rng = np.random.default_rng(1)
    video = rng.uniform(0, 255, (4, 3, 40, 44)).astype(np.float32)
    ff = rng.uniform(-2, 2, (4, 2, 40, 44)).astype(np.float32)
    bf = rng.uniform(-2, 2, (4, 2, 40, 44)).astype(np.float32)
    scfg = vt.default_config(20.0).stage(1).replace(nwt_b=2, nwt_f=2,
                                                    npatches=12)
    sites = np.array([[1, 4, 6], [2, 20, 30], [0, 0, 0], [2, 33, 37]],
                     np.int32)
    pv, pi = exec_search(_t(video), torch.from_numpy(sites), _t(ff), _t(bf),
                         scfg)
    ov, oi = orc.oracle_search(video, sites, ff, bf, scfg)
    print(f"[oracle] search l2: indices equal {(pi.numpy() == oi).mean():.4f}"
          f", max |dd| {np.abs(pv.numpy() - ov).max():.3g}", flush=True)

    # one stage-0 pass, tests/test_oracle.py::test_end_to_end_parity
    clean = synthetic_video(3, 32, 32, seed=5)
    noisy = add_noise(clean, 20.0, seed=6)
    cfg = vt.default_config(20.0).stage(0).replace(
        stype="l2", agg_k=0, cols_bf16=False, eig_method="jacobi")
    t0 = time.perf_counter()
    want = orc.oracle_proc_nl(noisy, None, zf32, zf32, cfg)
    o_s = time.perf_counter() - t0
    got = vt.proc_nl(_t(noisy), None, None, _t(zf32), _t(zf32), cfg)
    print(f"[oracle] one stage-0 pass 3x32x32: mean relative "
          f"{_rel(got, want):.3g}, max |d| "
          f"{np.abs(got.numpy() - want).max():.3g}; oracle {o_s:.2f} s",
          flush=True)

    # the Bayes filter (eig_method="xla") at both steps against npref
    for step in (0, 1):
        bcfg = vt.default_config(20.0, preset="default",
                                 eig_method="xla").stage(step)
        r = np.random.default_rng(10 + step)
        shp = (6, bcfg.npatches, bcfg.pt, 3, bcfg.ps, bcfg.ps)
        pb = (r.normal(0, 12, shp[:1] + (1,) + shp[2:])
              + r.normal(0, 2, shp)).astype(np.float32) + 120.0
        pn = (pb + r.normal(0, 20, shp)).astype(np.float32)
        fl = np.arange(6) < 2
        want, _ = npref.bayes_denoise(
            pn, pb if step else None, fl, step=step, sigma2=bcfg.sigma2,
            sigmab2=bcfg.sigmab2, rank=bcfg.rank, thresh=bcfg.thresh,
            cpatches=bcfg.cpatches)

        def rows(p):
            return torch.from_numpy(p).permute(0, 1, 3, 2, 4, 5).reshape(
                6, bcfg.npatches, 3, -1)

        got, _ = t_bayes(rows(pn), rows(pb) if step else None,
                         torch.from_numpy(fl) if step else None, bcfg)
        jgot, _ = j_bayes(jnp.asarray(pn), jnp.asarray(pb) if step else None,
                          jnp.asarray(fl) if step else None,
                          vnlb_tpu.default_config(
                              20.0, preset="default",
                              eig_method="xla").stage(step))
        scale = np.abs(want).max()
        print(f"[oracle] bayes step {step} vs npref: port "
              f"{np.abs(got.numpy() - want).max() / scale:.3g}, vnlb_tpu "
              f"{np.abs(np.asarray(jgot) - want).max() / scale:.3g} of the "
              f"scale", flush=True)

    # both passes, 3x48x48, scripts/compare_oracle.py's config
    clean = synthetic_video(3, 48, 48, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    base = dict(preset="iphone", stype=["l2", "l2"], eig_method="jacobi")
    exact = dict(base, agg_k=0, cols_bf16=False)
    t0 = time.perf_counter()
    o_d, o_b = orc.oracle_denoise(noisy, 20.0, vt.default_config(20.0,
                                                                 **base))
    o_s = time.perf_counter() - t0
    print(f"[oracle] both passes 3x48x48: oracle {o_s:.2f} s, basic / deno "
          f"{compute_psnr(o_b, clean):.5f} / {compute_psnr(o_d, clean):.5f} "
          f"dB", flush=True)
    runs = [("port preset", "port", base), ("vnlb_tpu preset", "jax", base),
            ("port exact", "port", exact), ("vnlb_tpu exact", "jax", exact),
            ("port exact poly", "port", dict(exact, eig_method="poly"))]
    for name, side, kw in runs:
        if side == "port":
            d, b, _ = vt.denoise(noisy, 20.0, cfg=vt.default_config(20.0, **kw),
                                 device="cpu")
        else:
            d, b, _ = vnlb_tpu.denoise(
                noisy, 20.0, cfg=vnlb_tpu.default_config(20.0, **kw))
        d, b = np.asarray(d), np.asarray(b)
        print(f"[oracle] {name}: basic / deno {compute_psnr(b, clean):.5f} / "
              f"{compute_psnr(d, clean):.5f} dB, mean relative "
              f"{_rel(b, o_b):.3g} / {_rel(d, o_d):.3g}", flush=True)


def small_f32():
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    for kw in (dict(poly_bf16=False), dict(poly_econ=False, poly_bf16=False)):
        jd, jb, _ = vnlb_tpu.denoise(noisy, 20.0,
                                     cfg=vnlb_tpu.default_config(20.0, **kw))
        d, b, _ = vt.denoise(noisy, 20.0, cfg=vt.default_config(20.0, **kw),
                             device="cpu")
        print(f"[small_f32] {kw}: vnlb_tpu basic / deno "
              f"{compute_psnr(np.asarray(jb), clean):.6f} / "
              f"{compute_psnr(np.asarray(jd), clean):.6f} dB; port "
              f"{compute_psnr(b.numpy(), clean):.6f} / "
              f"{compute_psnr(d.numpy(), clean):.6f} dB", flush=True)


def small_couple():
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    jkw = dict(couple_channels=True, poly_econ=False, poly_fused=False)
    kw = dict(couple_channels=True, poly_impl="pallas")
    jd, jb, _ = vnlb_tpu.denoise(noisy, 20.0,
                                 cfg=vnlb_tpu.default_config(20.0, **jkw))
    d, b, _ = vt.denoise(noisy, 20.0, cfg=vt.default_config(20.0, **kw),
                         device="cpu")
    print(f"[small_couple] vnlb_tpu {jkw}: basic / deno "
          f"{compute_psnr(np.asarray(jb), clean):.6f} / "
          f"{compute_psnr(np.asarray(jd), clean):.6f} dB; port {kw}: "
          f"{compute_psnr(b.numpy(), clean):.6f} / "
          f"{compute_psnr(d.numpy(), clean):.6f} dB", flush=True)


def _small_modes(tag, modes):
    clean = synthetic_video(5, 96, 112, seed=0)
    noisy = add_noise(clean, 20.0, seed=1)
    for name, kw, jkw in modes:
        jd, jb, _ = vnlb_tpu.denoise(noisy, 20.0,
                                     cfg=vnlb_tpu.default_config(20.0, **jkw))
        d, b, _ = vt.denoise(noisy, 20.0, cfg=vt.default_config(20.0, **kw),
                             device="cpu")
        print(f"[{tag}] {name}: vnlb_tpu {jkw}: basic / deno "
              f"{compute_psnr(np.asarray(jb), clean):.6f} / "
              f"{compute_psnr(np.asarray(jd), clean):.6f} dB; port {kw}: "
              f"{compute_psnr(b.numpy(), clean):.6f} / "
              f"{compute_psnr(d.numpy(), clean):.6f} dB", flush=True)


# chip_smoke.py's name, the port's config, vnlb_tpu's (poly_impl="pallas"
# held to the plain version of the same function)
SMALL_F5 = (
    ("poly_pallas_f32", dict(poly_impl="pallas", poly_bf16=False),
     dict(poly_econ=False, poly_fused=False, poly_bf16=False)),
    ("couple_f32", dict(couple_channels=True, poly_bf16=False),
     dict(couple_channels=True, poly_bf16=False)),
    ("poly_pallas_couple_f32",
     dict(poly_impl="pallas", couple_channels=True, poly_bf16=False),
     dict(couple_channels=True, poly_econ=False, poly_fused=False,
          poly_bf16=False)),
    ("default_couple", dict(preset="default", couple_channels=True),
     dict(preset="default", couple_channels=True)))


def small_f5():
    _small_modes("small_f5", SMALL_F5)


# preset default (pt=2 in the first pass: (100, 98) groups) in the filter
# modes that take K5 or split TF32: chip_smoke.py's name, the port's config,
# vnlb_tpu's (poly_impl="pallas" held to the plain version, as above)
SMALL_DEFAULT = (
    ("default_pallas", dict(preset="default", poly_impl="pallas"),
     dict(preset="default", poly_econ=False, poly_fused=False)),
    ("default_pallas_f32",
     dict(preset="default", poly_impl="pallas", poly_bf16=False),
     dict(preset="default", poly_econ=False, poly_fused=False,
          poly_bf16=False)),
    ("default_f32", dict(preset="default", poly_bf16=False),
     dict(preset="default", poly_bf16=False)),
    ("default_econ_off_f32",
     dict(preset="default", poly_econ=False, poly_bf16=False),
     dict(preset="default", poly_econ=False, poly_bf16=False)))


def small_default():
    _small_modes("small_default", SMALL_DEFAULT)


# the band of chip_smoke.py's 480p clip that f5_480p denoises: 64 of every
# frame's rows at full width (vnlb_tpu on the CPU needs over 28 GB for the
# whole frame in this configuration)
F5_ROWS = (208, 272)


def f5_480p():
    # topk="stream" (bit-equal to the one-shot top-K, far less peak
    # memory), first on the small clip beside small_f5's number
    jkw = dict(SMALL_F5[-1][2], topk="stream")
    r0, r1 = F5_ROWS
    for t, h, w, rows in ((5, 96, 112, slice(None)),
                          (5, 480, 854, slice(r0, r1))):
        clean = synthetic_video(t, h, w, seed=0)
        noisy = add_noise(clean, 20.0, seed=1)[..., rows, :]
        clean = clean[..., rows, :]
        t0 = time.perf_counter()
        jd, jb, _ = vnlb_tpu.denoise(noisy, 20.0,
                                     cfg=vnlb_tpu.default_config(20.0, **jkw))
        jd, jb = np.asarray(jd), np.asarray(jb)
        print(f"[f5_480p] default_couple: vnlb_tpu {jkw} at {t}x{h}x{w}, "
              f"rows {rows.start}:{rows.stop}: noisy / basic / deno "
              f"{compute_psnr(noisy, clean):.6f} / "
              f"{compute_psnr(jb, clean):.6f} / {compute_psnr(jd, clean):.6f}"
              f" dB, {time.perf_counter() - t0:.1f} s", flush=True)
        del jd, jb
        d, b, _ = vt.denoise(np.ascontiguousarray(noisy), 20.0,
                             cfg=vt.default_config(20.0, **SMALL_F5[-1][1]),
                             device="cpu")
        print(f"[f5_480p] default_couple: port {SMALL_F5[-1][1]}: basic / "
              f"deno {compute_psnr(b.numpy(), clean):.6f} / "
              f"{compute_psnr(d.numpy(), clean):.6f} dB", flush=True)


SECTIONS = dict(flows=flows, compat=compat, self_match=self_match,
                modes=modes, oracle=oracle, small_f32=small_f32,
                small_couple=small_couple, small_f5=small_f5,
                small_default=small_default, f5_480p=f5_480p)

if __name__ == "__main__":
    torch.set_num_threads(4)
    for name in sys.argv[1:] or [s for s in SECTIONS if s != "f5_480p"]:
        SECTIONS[name]()
