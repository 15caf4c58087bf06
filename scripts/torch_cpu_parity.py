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
mean |d| in gray levels).  Takes ~2 minutes on 4 threads.
"""

import os
import sys

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

import vnlb_tpu_torch as vt  # noqa: E402
import vnlb_tpu_torch.compat as tcompat  # noqa: E402
from vnlb_tpu_torch.ops import flow as tf  # noqa: E402
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


if __name__ == "__main__":
    torch.set_num_threads(4)
    flows()
    compat()
    self_match()
    modes()
