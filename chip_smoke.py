#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the kernels from vnlb_tpu_torch/csrc, checks each kernel against its
plain PyTorch version at the shapes of the main paths (K6, the row
scatter, bitwise on one chunk of each pass; K1 timed at each of
its launch shapes, ``k1_cases``, beside its bound and its FP32 issue
floor, with its launch plan held to the library's), holds small-clip
PSNRs of every preset and filter mode, and of ``denoise_mod``, to the JAX
package's, then runs the
two-pass ``denoise`` on a 5x480x854 clip at sigma=20 nineteen ways and checks
each output: the bench config (preset iphone, eig_method poly, step_s 6,
border_mode mask, topk exact, zero flow), the API default (``denoise(noisy,
sigma)`` with no cfg: step_s 3, sliding borders) with zero flow and with
the clip's own drift flow, the API default with ``poly_impl="pallas"``
(kernel K5's tensor-core design in both passes) and the ``default`` preset
(w_s=27, pt=2 in the first pass: K2's wide tensor-core design on (100,
98) groups), the API default with ``couple_channels`` (K2's streamed Gram
route on the joint (100, 147) and (60, 294) groups), without
``poly_bf16`` (K2's wide design and streamed Gram route in split TF32) and
with ``poly_econ=False, poly_bf16=False`` (K5 in split TF32 in the first
pass), the API default with ``poly_impl="pallas", couple_channels=True``
(K5's batched tensor-core design on the joint (100, 147) and (60, 294)
groups of both passes), the same three filter paths without ``poly_bf16``
(``poly_impl="pallas"``: K5's tensor-core design in split TF32 in both
passes; ``couple_channels``: K2's streamed Gram route in split TF32; both:
K5's batched design in split TF32), preset ``default`` with
``couple_channels`` (K2's streamed Gram route on (100, 294) groups),
preset ``default``'s (100, 98) first pass through K5 (``poly_impl="pallas"``
with and without ``poly_bf16``, and ``poly_econ=False, poly_bf16=False``:
K5's tensor-core design in bf16 and in split TF32) and through K2 in split
TF32 (``poly_bf16=False``), the API default with
the all-rows dense search (``dense_rows="full"``: kernel K3) and the exact
and the streaming top-K; then ``denoise_streaming`` of a 24x480x854 clip
against the whole-clip ``denoise``, and ``denoise_pipelined`` with both
passes on this card (``devices=``) bitwise against it.  Then the
halo-sharded pass
(``vnlb_tpu_torch.parallel``): K1's tile entry against its plain version
on the strips of a 4-strip split, the one-card strip runner over all four
strips of both passes against the mask-border ``proc_nl``, and a 2-rank
gloo world on the one card (``denoise_halo`` bitwise against the 2-strip
composition, ``proc_nl_halo`` with the drift flow, ``denoise_sharded``,
``denoise_streaming(mesh=...)`` of a 12x480x854 clip), and
``denoise_pipelined(meshes=...)`` over two stage groups of a 4-rank gloo
world on the card (2 stages x 2 strips) bitwise against that 2-rank
``denoise_streaming(mesh=...)``.  Then the paths of
estimated flow, the reference-order pass and the aggregation modes:
``estimate_flows`` (TV-L1 and LK) of a 5x480x854 clip that moves 4 px a
frame, on the card against the CPU, ``denoise`` with those flows (every
site on K1's window-start entry) beside zero flow, ``denoise_compat``
of the clip's first 3 frames (its plain-version pass takes over a minute
at 5) with the kernels, the plain versions and a repeat (K1, K2, K4), and
one ``denoise`` per aggregation mode (``agg_weight="exp"`` under both
``dense_rows``, ``only_frame``, ``agg_bf16``, ``poly_gram=False``, whose
second pass runs no K2) against its plain-version pass; the port's
CLI (``scripts/torch_example.py --dataset davis``, a subprocess) on the
main clip, its PSNRs and launches equal to the API default's, and the
two analysis scripts (``scripts/torch_deno_v_basic.py``,
``exps/torch_interp_square.py``) the same way; last, the
card against the C++ oracle (``vnlb_tpu_torch/testing/oracle.py``, built
with g++; its passes run in threads beside the card's checks) and the
NumPy oracle (``testing/npref.py``): colour and lattice, the gather search
on K1's window-start entry and the dense search on K1's dense entry and on
K3 (indices differ only at ties), K4 bitwise, scatter (K6), fold and
finalize,
one pass with the kernels and both passes of a 3x48x48 clip (the
oracle's semantics within 2e-3 mean relative error and 0.01 dB; K2's
poly run within 0.1 dB of the jacobi run).  K2's and
K5's lines name the design each group shape takes (tensor cores at width 64 or
128, bf16 or split-TF32 operands, K5's batched design, or shared memory), a
tensor-core design's plan against its Python mirror and its stated blocks
per SM (the batched design's padded sizes, tiles, sub-batch and
workspace), and the shared-memory design's time on the same inputs; each
group shape's repeat run is bitwise equal; the batched design's output on
a workspace of stale 0xFF bytes is bitwise its output on a fresh one
(``k5_tcb_stale_ws``); and every 480p run logs K1's,
K2's and K5's device time and launches (CUDA events around each launch,
in one extra run); the API default's K1 launches are
logged by shape (``k1_api_default``).  Every phase prints
one line; any
failure raises and the script exits nonzero.  The second-to-last line is the kernel table as JSON (each kernel's time, its
plain version's and its bound: the larger of its bytes over the memory
rate and its operations over the peak rate of their type), the last line
the device record.  Without a CUDA card, or without the repository beside
it, the script fails and prints no result.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

T, H, W, SIGMA = 5, 480, 854, 20.0
BENCH = dict(preset="iphone", eig_method="poly", step_s=6,
             border_mode="mask", topk="exact")
# the JAX package on the CPU, (5, 96, 112) clip, seed 0, noise seed 1:
# bench config, and the API default with zero flow and with the drift flow
REF_SMALL = dict(basic=30.025878, deno=30.125710)
REF_SMALL_API = {"zero": dict(basic=29.962152, deno=30.117215),
                 "drift": dict(basic=30.156511, deno=30.210914)}
# the same clip, zero flow: the other presets, and the API default with
# each filter mode (overrides of default_config).  poly_impl="pallas" is
# held to JAX's plain version of the same function (poly_econ and
# poly_fused off), which the JAX package runs on the CPU.
REF_SMALL_MODES = {
    "preset_default": (dict(preset="default"),
                       dict(basic=29.581324, deno=30.194836)),
    "preset_exp": (dict(preset="exp"), dict(basic=29.581324, deno=30.194836)),
    "preset_sss": (dict(preset="sss"), dict(basic=29.752531, deno=30.200173)),
    "preset_sss_v2": (dict(preset="sss_v2"),
                      dict(basic=30.110754, deno=30.214864)),
    "eig_xla": (dict(eig_method="xla"), dict(basic=30.032406, deno=30.152225)),
    "eig_jacobi": (dict(eig_method="jacobi"),
                   dict(basic=30.032417, deno=30.152266)),
    "eig_rational": (dict(eig_method="rational"),
                     dict(basic=29.437425, deno=30.118546)),
    "poly_econ_off": (dict(poly_econ=False),
                      dict(basic=30.020913, deno=30.133796)),
    "poly_pallas": (dict(poly_impl="pallas"),
                    dict(basic=30.020913, deno=30.153355)),
    "couple_channels": (dict(couple_channels=True),
                        dict(basic=29.922595, deno=30.464622)),
    # K5 on the joint groups (scripts/torch_cpu_parity.py small_couple:
    # JAX's plain version, couple_channels with poly_econ and poly_fused
    # off)
    "poly_pallas_couple": (dict(poly_impl="pallas", couple_channels=True),
                           dict(basic=30.007073, deno=30.161786)),
    # without poly_bf16 (scripts/torch_cpu_parity.py small_f32): K2 and K5
    # in split TF32 on the card
    "poly_bf16_off": (dict(poly_bf16=False),
                      dict(basic=29.962205, deno=30.117504)),
    "poly_econ_off_f32": (dict(poly_econ=False, poly_bf16=False),
                          dict(basic=30.020904, deno=30.133784)),
    # scripts/torch_cpu_parity.py small_f5: K5 "tc" in split TF32 (held to
    # JAX's plain version of the same function, poly_econ and poly_fused
    # off), K2 "tcg" in split TF32, K5 "tcb" in split TF32 (the same plain
    # version with couple_channels), K2 "tcg" on preset default's (100,
    # 294) groups
    "poly_pallas_f32": (dict(poly_impl="pallas", poly_bf16=False),
                        dict(basic=30.020904, deno=30.153356)),
    "couple_f32": (dict(couple_channels=True, poly_bf16=False),
                   dict(basic=29.919244, deno=30.461341)),
    "poly_pallas_couple_f32": (dict(poly_impl="pallas", couple_channels=True,
                                    poly_bf16=False),
                               dict(basic=30.007160, deno=30.162052)),
    "default_couple": (dict(preset="default", couple_channels=True),
                       dict(basic=27.258612, deno=27.303437)),
    # scripts/torch_cpu_parity.py small_default: preset default's (100, 98)
    # first pass through K5 "tc" (bf16 and split TF32; poly_impl="pallas"
    # held to JAX's plain version, poly_econ and poly_fused off), through
    # K2 in split TF32, and through K5 in split TF32 with poly_econ off
    "default_pallas": (dict(preset="default", poly_impl="pallas"),
                       dict(basic=29.731524, deno=30.215664)),
    "default_pallas_f32": (dict(preset="default", poly_impl="pallas",
                                poly_bf16=False),
                           dict(basic=29.731644, deno=30.215794)),
    "default_f32": (dict(preset="default", poly_bf16=False),
                    dict(basic=29.583775, deno=30.195204)),
    "default_econ_off_f32": (dict(preset="default", poly_econ=False,
                                  poly_bf16=False),
                             dict(basic=29.731644, deno=30.221270)),
    "deno_ave": (dict(deno="ave"), dict(basic=22.119456, deno=22.119456)),
    "dense_full": (dict(dense_rows="full"),
                   dict(basic=29.962152, deno=30.117215)),
    "topk_stream": (dict(topk="stream"), dict(basic=29.962152, deno=30.117215)),
    "topk_approx": (dict(topk="approx"), dict(basic=29.962152, deno=30.117215)),
}
# preset default with couple_channels on rows 208:272 of the 480p clip at
# full width, vnlb_tpu on the CPU (scripts/torch_cpu_parity.py f5_480p,
# topk="stream"; the whole frame needs more memory than its host had)
REF_BAND_DEFAULT_COUPLE = dict(rows=(208, 272), noisy=22.101752,
                               basic=27.502580, deno=27.457833)
# the least gain of deno over noisy at 480p: 6 dB, but 5 dB for preset
# default with couple_channels, whose joint (100, 294) / (60, 294) groups
# the algorithm filters worse: vnlb_tpu gains 5.36 dB on the band above
# (deno below basic, as at 480p on the card) and 5.18 dB on the small
# clip (REF_SMALL_MODES), and the port 5.44 dB on the whole 480p clip on
# an NVIDIA H100 80GB HBM3 at 700 W
E2E_GAIN_DB = {"e2e_default_couple": 5.0}
# the same clip through denoise_mod (the four-pass variant pipeline)
REF_SMALL_MOD = dict(basic=29.962574, deno=30.117078)
# the all-rows search and the streaming run (24 frames: windows of 12 / 14
# frames are strict sub-windows)
DENSE_FULL = dict(dense_rows="full")
STREAM_T, STREAM_CHUNK = 24, 4
STREAM_CFG = dict(nwt_f=2, nwt_b=2, dense_rows="full", topk="stream")
# the halo-sharded pass: the API default under mask borders in 4 strips
# (one card) and in a 2-rank world; its streaming run, 12 frames in chunks
# of 4, nwt 2
HALO_CFG = dict(border_mode="mask")
# the halo tile's all-rows branch (K3 planes of each tile)
HALO_ALL_ROWS = dict(dense_rows="full", topk="stream")
HALO_STREAM_T, HALO_STREAM_CFG = 12, dict(nwt_f=2, nwt_b=2,
                                          border_mode="mask")
# H100 SXM data-sheet peaks: f32 on CUDA cores, bf16 on tensor cores (a
# product of bf16-rounded operands accumulated in f32 is exactly what a
# bf16 tensor-core MMA computes), TF32 on tensor cores (an f32 product in
# split TF32 is three of them), HBM3
PEAK_F32, PEAK_BF16, PEAK_TF32, HBM_BPS = 67e12, 989e12, 494.7e12, 3.35e12


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warmup."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def clock_under(fn, reps):
    """(median SM clock MHz, median power W) that nvidia-smi samples every
    50 ms while ``fn`` runs ``reps`` times back to back."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-i", "0", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.2)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = []
    for ln in out.splitlines():
        try:
            rows.append([float(v) for v in ln.split(",")[:2]])
        except ValueError:      # a field nvidia-smi reports as [N/A]
            continue
    # the samples of the loaded part: the last three quarters
    rows = rows[len(rows) // 4:]
    if not rows:
        return float("nan"), float("nan")
    return (float(np.median([r[0] for r in rows])),
            float(np.median([r[1] for r in rows])))


def tie_aware(name, vk, ik, vp, ip, tol):
    """Tie-aware top-K comparison: the inf pattern agrees, sorted values
    agree within ``tol`` elementwise (so an index mismatch is a tie);
    returns the index agreement."""
    fin = torch.isfinite(vp)
    if not torch.equal(fin, torch.isfinite(vk)):
        raise AssertionError(f"{name}: inf pattern differs")
    err = torch.where(fin, (vk - vp).abs(), torch.zeros_like(vp))
    if (err > tol).any():
        raise AssertionError(f"{name}: top-K values beyond tolerance")
    return (ik == ip).float().mean().item()


def rel_err(got, want):
    return ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()


def bound(f32_flops, bf16_flops, nbytes, x3_flops=0):
    """(least ms the card could take, what bounds it); ``x3_flops`` are f32
    products that take the lesser of f32 CUDA cores and split TF32 (three
    TF32 products each; the lesser is split TF32)."""
    t_ops = (f32_flops / PEAK_F32 + bf16_flops / PEAK_BF16
             + min(x3_flops / PEAK_F32, 3 * x3_flops / PEAK_TF32))
    t_mem = nbytes / HBM_BPS
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def k1_work(sites, vid, scfg, starts=0, planes=7, cands=None):
    """bound() of K1 over ``planes`` dt planes: per (site, dt, candidate,
    pixel) a subtraction and a multiply-add in f32, for ``cands`` computed
    (site, dt, candidate) triples (all of them by default; the tile entry
    skips the ones outside the frame); the video and the (S, 3) query
    sites (and ``starts`` (planes, S) int32 window-start tensors) read
    once, the distances written once."""
    n = sites.shape[0]
    if cands is None:
        cands = n * planes * scfg.w_s ** 2
    flops = 3 * cands * scfg.pt * vid.shape[1] * scfg.ps ** 2
    nbytes = (vid.numel() * 4 + sites.numel() * sites.element_size()
              + starts * planes * n * 4 + n * planes * scfg.w_s ** 2 * 4)
    return bound(flops, 0, nbytes)


def k1_fp32_issue_ms(pairs, vid, scfg):
    """The FP32 issue floor of K1: each term is an FADD and an FFMA, two
    instructions on 132 SMs x 128 lanes at the 1.98 GHz boost clock."""
    terms = pairs * scfg.w_s ** 2 * scfg.pt * vid.shape[1] * scfg.ps ** 2
    return 2 * terms / (132 * 128 * 1.98e9) * 1e3


def k1_cases(vt, yuv, bench, dev):
    """[(name, stage config, args, window-start kwargs)]: K1 at the main
    path's launch shapes on the 480p clip ``yuv``: a 4096-site chunk of the
    API default's interior sites at stage 0 levels 0, 1, 2 and stage 1
    level 0 (one launch per chunk and level), the window-start entry on
    4096 border sites of each stage (uniform random starts inside the
    frame), and the bench config's 46,046 stage-1 sites in one launch."""
    from vnlb_tpu_torch.ops.mask import interior_split, lattice_sites
    from vnlb_tpu_torch.ops.search import eff_dt_range, search_levels
    from vnlb_tpu_torch.ops.search_dense import level_queries

    shape = tuple(yuv.shape)
    api = vt.default_config(SIGMA)
    cases = []
    for stage, lvls in ((0, (0, 1, 2)), (1, (0,))):
        scfg = api.stage(stage)
        lo, hi = eff_dt_range(scfg, shape[0])
        n_dt = hi - lo + 1
        levels = search_levels(yuv, scfg)
        inner, border = interior_split(lattice_sites(shape, scfg), shape,
                                       scfg)
        sites = torch.from_numpy(inner[:4096]).to(dev).long()
        for lvl in lvls:
            v = levels[lvl]
            # int32, as the wrapper hands them on: the timing then holds
            # the kernel alone
            q = [c.int() for c in level_queries(sites, lvl, v.shape[2],
                                                v.shape[3], scfg)]
            cases.append((f"s{stage}.l{lvl}", scfg,
                          (v, *q, lo, n_dt, scfg.pt, scfg.ps, scfg.w_s), {}))
        sites = torch.from_numpy(border[:4096]).to(dev).int()
        rng = np.random.default_rng(stage)
        starts = {k: torch.from_numpy(rng.integers(
            0, n - scfg.ps - scfg.w_s + 2, (n_dt, sites.shape[0]))
            .astype(np.int32)).to(dev) for k, n in (("sy", shape[2]),
                                                    ("sx", shape[3]))}
        cases.append((f"s{stage}.windows", scfg,
                      (levels[0], sites[:, 0], sites[:, 1], sites[:, 2], lo,
                       n_dt, scfg.pt, scfg.ps, scfg.w_s), starts))
    s1 = bench.stage(1)
    lo, hi = eff_dt_range(s1, shape[0])
    sites = torch.from_numpy(lattice_sites(shape, s1)).to(dev).int()
    cases.append(("s1.l0.bench_all", s1,
                  (search_levels(yuv, s1)[0], sites[:, 0], sites[:, 1],
                   sites[:, 2], lo, hi - lo + 1, s1.pt, s1.ps, s1.w_s), {}))
    return cases


def k1_api_phase(per, k1_shapes, api_cfg):
    """The API default's K1 launches by shape (``per``: its timed run's
    {(pt, C, level height, window starts): (device ms, launches)}) beside
    each shape's standalone time and bound: one line per shape."""
    heights = {H: 0, H // 2: 1, H // 4: 2}
    total_ms = total_n = 0
    for (pt, c, h, win), (ms, n) in sorted(per.items()):
        stage = 0 if pt == api_cfg.stage(0).pt else 1
        name = f"s{stage}.l{heights[h]}" + (".windows" if win else "")
        timed = (f"s{stage}.windows" if win and heights[h] == 0
                 else None if win else name)
        extra = {}
        if timed in k1_shapes:
            kms, _, (bms, by), fp32_ms = k1_shapes[timed]
            extra = dict(chunk_kernel_ms=f"{kms:.4f}",
                         chunk_bound_ms=f"{bms:.4f}", bound_by=by,
                         chunk_fp32_issue_ms=f"{fp32_ms:.4f}")
        log("k1_api_default", shape=name,
            level_rows=h, pt_c=pt * c, window_starts=win, launches=n,
            device_ms=f"{ms:.3f}", **extra)
        total_ms += ms
        total_n += n
    log("k1_api_default_total", launches=total_n, device_ms=f"{total_ms:.2f}")


def sym(q):
    """Multiply-adds of a q x q product whose result is symmetric, over
    those of the full product: the outputs on and above the diagonal."""
    return (q + 1) / (2 * q)


def econ_work(g, k, p, scfg):
    """(f32 flops, bf16-operand flops, bytes, split-TF32 flops) of K2 on g
    groups of (k, p): the covariance or Gram (symmetric) and xn xc^T take
    f32 operands, the chain and the applications bf16-rounded ones (all f32
    without poly_bf16); every f32 product is bounded as split TF32.
    Without poly_bf16 the chain's products, polynomials in the symmetric
    covariance or Gram, are symmetric too."""
    from vnlb_tpu_torch.ops.polyspec import econ_params

    ep = econ_params(scfg)
    chain = {4: 3, 3: 2, 2: 1}[ep["s"]] + ep["m"] - 1
    q = k if k < p else p
    f32 = k * k * p * (sym(k) + 1) if k < p else k * p * p * sym(p)
    chain_q = chain * q ** 3 * (1 if ep["rnd"] else sym(q))
    if k < p:
        low = chain_q + k ** 3 + k * k * p
    else:
        low = chain_q + k * p * p
    if not ep["rnd"]:
        return 0, 0, 3 * g * k * p * 4, 2 * g * (f32 + low)
    return 0, 2 * g * low, 3 * g * k * p * 4, 2 * g * f32


def poly_work(g, k, p, scfg):
    """(f32 flops, bf16-operand flops, bytes, split-TF32 flops) of K5 on g
    groups of (k, p): the covariance (symmetric) and the xn-side product
    (xn W left, xn F right) take f32 operands; the sign gate, the T_j
    products and F = W Q bf16-rounded ones (all f32 without poly_bf16);
    every f32 product is bounded as split TF32.  Without poly_bf16 the
    gate's products, T_j and F, polynomials in the symmetric covariance,
    are symmetric too; under it st() breaks that (st(S^2) S is not
    symmetric), so they count in full."""
    from vnlb_tpu_torch.ops.polyspec import poly_params

    pp = poly_params(scfg)
    s = 1 if pp["rnd"] else sym(p)
    gate = (3 * pp["n_aggr"] + 2 * pp["n_polish"]) * p ** 3 * s
    f32 = k * p * p * (sym(p) + 1)
    if k >= p:
        low = gate + pp["wdeg"] * p ** 3 * s
    else:
        low = gate + pp["wdeg"] * k * p * p
    if not pp["rnd"]:
        return 0, 0, 3 * g * k * p * 4, 2 * g * (f32 + low)
    return 0, 2 * g * low, 3 * g * k * p * 4, 2 * g * f32


def tcb_stale_ws_phase(dev, a0, a1):
    """K5's batched design on a stale workspace
    (``testing.stale_ws.tcb_stale_workspace``): at couple_channels'
    (100, 147) and (60, 294) groups (4096, the main clip's chunk), bf16
    and split TF32, a launch on a fresh workspace, one on the freed block
    of 0xFF bytes that the caching allocator hands back (the same
    ``data_ptr``) and the wrapper's own launch: all bitwise equal."""
    from vnlb_tpu_torch.testing.stale_ws import tcb_stale_workspace

    rng = np.random.default_rng(5)
    for scfg, k, p in ((a0, 100, 147), (a1, 60, 294)):
        base = rng.normal(size=(4096, 1, p)).astype(np.float32) * 30
        xc, xn = (torch.from_numpy(base + rng.normal(size=(4096, k, p))
                                   .astype(np.float32) * 20).to(dev)
                  for _ in range(2))
        for bf16 in (True, False):
            r = tcb_stale_workspace(xc, xn, scfg.replace(poly_bf16=bf16))
            fresh, stale = r["fresh"], r["stale"]
            same = torch.equal(stale, fresh)
            own = torch.equal(r["own"], fresh)
            log("k5_tcb_stale_ws", K=k, p=p, G=4096,
                operands="bf16" if bf16 else "split_tf32",
                ws_mib=f"{r['ws_bytes'] / 2 ** 20:.1f}",
                poisoned_block_reused=r["reused"],
                stale_bitwise_fresh=same, own_bitwise_fresh=own,
                max_abs_stale_fresh=(stale - fresh).abs().max().item(),
                finite=bool(torch.isfinite(stale).all()))
            if not r["reused"]:
                raise AssertionError(f"k5_tcb_stale_ws ({k}, {p}): the "
                                     f"allocator did not hand back the "
                                     f"poisoned block")
            if not (same and own and torch.isfinite(fresh).all()):
                raise AssertionError(f"k5_tcb_stale_ws ({k}, {p}): the "
                                     f"output depends on the workspace")
            del r, fresh, stale


def k3_work(vid, n_f, scfg):
    """bound() of K3 on one plane: per output value 2*pt*C f32 operations
    for the channel products, 2*(ps-1) for the separable box and 3 for
    q2 + b2 - 2 cross; the level video read once, the plane written
    once.  This is the function's work: the kernel forms each pixel
    product once per offset but repeats a tile's ps - 1 halo rows and a
    strip's ps - 1 halo columns (14.4 FMAs an output at stage 1, 2.4 at
    stage 0), and sums the box directly (2*(ps-1) adds)."""
    _, c, h, w = vid.shape
    n_out = n_f * (h - scfg.ps + 1) * (w - scfg.ps + 1) * scfg.w_s ** 2
    ops = 2 * scfg.pt * c + 2 * (scfg.ps - 1) + 3
    return bound(n_out * ops, 0, vid.numel() * 4 + n_out * 4)


def k3_launches(yuv, cfg):
    """K3 launches of one ``denoise`` under dense_rows="full": one per
    (pyramid level, dt) of each pass."""
    from vnlb_tpu_torch.ops.search import eff_dt_range, search_levels

    n = 0
    for i in (0, 1):
        lo, hi = eff_dt_range(cfg.stage(i), yuv.shape[0])
        n += len(search_levels(yuv, cfg.stage(i))) * (hi - lo + 1)
    return n


def e2e(vt, name, noisy, clean, dev, counters, expect, cfg=None,
        flows=None, min_gain_db=6.0):
    """The main path at full size: one counted warmup run, best of 3 with a
    bitwise repeat check, one run with CUDA events around each K1, K2, K3
    and K5 launch, the output checks (deno >= noisy + ``min_gain_db``) and
    the plain-version pass (basic and deno within 0.01 dB).
    ``expect`` names the counters that must launch (the others must not).
    Returns (launches, deno, basic, {(pt, C, level height, window starts): (K1
    device ms, launches)} of the timed run)."""
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    for c in counters:
        c.launches = 0
        for kind in getattr(c, "by_design", {}):
            c.by_design[kind] = 0
    deno, basic, first_s = vt.denoise(noisy, SIGMA, flows=flows, cfg=cfg,
                                      device=dev)
    launches = {c.__name__: c.launches for c in counters}
    if any((n > 0) != (c in expect) for c, n in launches.items()):
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"kernels {sorted(expect)}")
    # the launches of each design of a kernel with several ("econ_filter.tcw")
    launches.update({f"{c.__name__}.{kind}": n for c in counters
                     for kind, n in getattr(c, "by_design", {}).items()})
    log(f"{name}_warmup", seconds=f"{first_s:.3f}", **launches)

    noisy_t = torch.from_numpy(noisy).to(dev)
    times = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats(dev)
        d2, b2, sec = vt.denoise(noisy_t, SIGMA, flows=flows, cfg=cfg,
                                 device=dev)
        times.append(sec)
        if not (torch.equal(d2, deno) and torch.equal(b2, basic)):
            raise AssertionError(f"{name}: repeat run is not bitwise equal")
    peak = torch.cuda.max_memory_allocated(dev)
    deno_np, basic_np = deno.cpu().numpy(), basic.cpu().numpy()
    if not (deno_np.shape == noisy.shape and np.isfinite(deno_np).all()
            and np.isfinite(basic_np).all()):
        raise AssertionError(f"{name}: output has the wrong shape or "
                             f"non-finite values")
    p_noisy = compute_psnr(noisy, clean)
    p_basic = compute_psnr(basic_np, clean)
    p_deno = compute_psnr(deno_np, clean)
    best = min(times)
    timed, k1_shapes = {}, {}
    if expect & {"econ_filter", "patch_dist"}:
        run_s, per = timed_run(vt, noisy_t, dev, cfg, flows)
        for kern, tag in (("econ_filter", "k2"), ("patch_dist", "k1"),
                          ("dense_dist", "k3"), ("poly_filter", "k5")):
            if kern not in expect:
                continue
            ms = sum(v[0] for k, v in per.items() if k[0] == kern)
            n = sum(v[1] for k, v in per.items() if k[0] == kern)
            timed.update({f"{tag}_device_ms": f"{ms:.1f}",
                          f"{tag}_launches": n,
                          f"{tag}_share": f"{ms / 1e3 / run_s:.3f}"})
        timed["timed_run_seconds"] = f"{run_s:.4f}"
        k1_shapes = {k[1:]: v for k, v in per.items()
                     if k[0] == "patch_dist"}
    log(name, seconds=",".join(f"{t:.4f}" for t in times),
        fps=f"{T / best:.3f}", psnr_noisy=f"{p_noisy:.4f}",
        psnr_basic=f"{p_basic:.4f}", psnr_deno=f"{p_deno:.4f}",
        peak_mem_gib=f"{peak / 2 ** 30:.3f}", repeat_bitwise=True, **timed)
    if not p_deno >= p_noisy + min_gain_db:
        raise AssertionError(f"{name}: deno {p_deno} < noisy {p_noisy} + "
                             f"{min_gain_db}")

    t0 = time.perf_counter()
    dp, bp, plain_s = vt.denoise(noisy_t, SIGMA, flows=flows, cfg=cfg,
                                 device=dev, kernels=vt.PLAIN)
    pp_basic = compute_psnr(bp.cpu().numpy(), clean)
    pp_deno = compute_psnr(dp.cpu().numpy(), clean)
    log(f"{name}_plain", seconds=f"{plain_s:.4f}",
        psnr_basic=f"{pp_basic:.4f}", psnr_deno=f"{pp_deno:.4f}",
        gap_basic_db=f"{p_basic - pp_basic:+.4f}",
        gap_deno_db=f"{p_deno - pp_deno:+.4f}",
        mean_abs_diff=f"{(dp - deno).abs().mean().item():.4g}",
        wall=f"{time.perf_counter() - t0:.2f}")
    if not (abs(pp_basic - p_basic) < 0.01 and abs(pp_deno - p_deno) < 0.01):
        raise AssertionError(f"{name}: kernel path and plain path differ by "
                             f">= 0.01 dB")
    return launches, deno, basic, k1_shapes


def timed_run(vt, noisy_t, dev, cfg, flows):
    """One more run of a path with CUDA events around each K2, K1, K3 and
    K5 launch: (wall seconds, {(kernel, *shape key): (device ms,
    launches)});
    K1's key is (pt, C, level height, window starts given)."""
    from vnlb_tpu_torch.ops.dense_dist import dense_dist
    from vnlb_tpu_torch.ops.econ_filter import econ_filter
    from vnlb_tpu_torch.ops.patch_dist import patch_dist
    from vnlb_tpu_torch.ops.poly_filter import poly_filter

    events = []

    def timing(fn, key):
        def run(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            events.append((key(*a, **kw), ev))
            return out
        return run

    kernels = vt.KERNELS._replace(
        econ_filter=timing(econ_filter, lambda *a, **kw: ("econ_filter",)),
        patch_dist=timing(patch_dist, lambda vid, qt, qy, qx, dt_lo, n_dt,
                          pt, ps, w_s, sy=None, sx=None: (
                              "patch_dist", pt, vid.shape[1], vid.shape[2],
                              sy is not None)),
        dense_dist=timing(dense_dist, lambda *a, **kw: ("dense_dist",)),
        poly_filter=timing(poly_filter, lambda *a, **kw: ("poly_filter",)))
    _, _, sec = vt.denoise(noisy_t, SIGMA, flows=flows, cfg=cfg, device=dev,
                           kernels=kernels)
    per = {}
    for key, (a, b) in events:
        ms, n = per.get(key, (0.0, 0))
        per[key] = (ms + a.elapsed_time(b), n + 1)
    return sec, per


def assert_close(name, got, want):
    """tests/test_halo.py's bound: max |d| <= 0.5, mean |d| <= 0.02 gray
    levels (near-tie top-K swaps only); returns (max, mean)."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    if not (diff.max() <= 0.5 and diff.mean() <= 0.02):
        raise AssertionError(f"{name}: max |d| {diff.max()}, mean |d| "
                             f"{diff.mean()}")
    return diff.max(), diff.mean()


def strip_tile(img, strip, hs, halo):
    """Rows [strip*hs - halo, (strip+1)*hs + halo) of (T, C, H, W), zeros
    past the frame."""
    base = strip * hs - halo
    tile = img.new_zeros(img.shape[:2] + (hs + 2 * halo, img.shape[3]))
    lo, hi = max(base, 0), min(base + hs + 2 * halo, img.shape[2])
    tile[:, :, lo - base:hi - base] = img[:, :, lo:hi]
    return tile


def k1_tile_phase(yuv, shape, dev):
    """K1's tile entry against its plain version: the four strips of a
    4-strip split, level 0 of each pass, one chunk of 4096 home-strip
    sites each (the first; the last on the last strip), every dt plane; then the whole frame as the tile, bitwise
    against K1 plus the mask-border +inf.  Returns (max |d| of the finite
    values, timing record of strip 1, stage 1)."""
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch.ops.mask import lattice_sites
    from vnlb_tpu_torch.ops.patch_dist import (patch_dist, patch_dist_tile,
                                               patch_dist_tile_plain,
                                               tile_oob)
    from vnlb_tpu_torch.ops.search import eff_dt_range
    from vnlb_tpu_torch.parallel.halo import (_plan_strip_sites,
                                              _strip_geometry)

    err, record = 0.0, None
    for stage in (0, 1):
        scfg = vt.default_config(SIGMA, **HALO_CFG).stage(stage)
        halo, hs, h_run = _strip_geometry(shape, scfg, 4)
        dt_lo, dt_hi = eff_dt_range(scfg, shape[0])
        n_dt = dt_hi - dt_lo + 1
        hp_g, wp = h_run - scfg.ps + 1, W - scfg.ps + 1
        v0 = yuv[:, :scfg.dist_chnls].contiguous()
        for strip in range(4):
            # the last strip's last chunk reaches its zero-filled bottom rows
            sites, _ = _plan_strip_sites(shape, scfg, 4, halo, strip)
            sites = sites[-4096:] if strip == 3 else sites[:4096]
            sites = torch.from_numpy(sites).to(dev)
            tile = strip_tile(v0, strip, hs, halo)
            args = (tile, sites[:, 0], sites[:, 1], sites[:, 2], dt_lo, n_dt,
                    scfg.pt, scfg.ps, scfg.w_s, strip * hs - halo, hp_g, wp)
            got = patch_dist_tile(*args)
            want = patch_dist_tile_plain(*args)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            if not torch.equal(torch.isfinite(got), fin):
                raise AssertionError(f"K1 tile s{stage} strip {strip}: +inf "
                                     f"positions differ")
            rel = rel_err(got[fin], want[fin])
            err = max(err, (got[fin] - want[fin]).abs().max().item())
            if not rel < 1e-5:
                raise AssertionError(f"K1 tile s{stage} strip {strip}: max "
                                     f"relative error {rel}")
            kms = cuda_ms(lambda: patch_dist_tile(*args), 5)
            pms = cuda_ms(lambda: patch_dist_tile_plain(*args), 1)
            bms, by = k1_work(sites, tile, scfg, planes=n_dt,
                              cands=int(fin.sum().item()))
            fp32_ms = k1_fp32_issue_ms(sites.shape[0] * n_dt, tile, scfg)
            log("k1_tile", stage=stage, strip=strip,
                tile=f"{tile.shape[2]}x{tile.shape[3]}",
                base_row=strip * hs - halo, sites=sites.shape[0],
                dt_planes=n_dt, inf_share=f"{1 - fin.float().mean().item():.4f}",
                max_rel_err=f"{rel:.3g}", kernel_ms=f"{kms:.3f}",
                plain_ms=f"{pms:.3f}", bound_ms=f"{bms:.4f}", bound_by=by,
                over_bound=f"{kms / bms:.2f}",
                fp32_issue_ms_all_cands=f"{fp32_ms:.4f}")
            if (stage, strip) == (1, 1):
                record = (kms, pms, (bms, by))
            del got, want
        # the whole frame as the tile: K1 plus the mask, bit for bit
        sites = torch.from_numpy(lattice_sites(shape, scfg)[:4096]).to(dev)
        args = (v0, sites[:, 0], sites[:, 1], sites[:, 2], dt_lo, n_dt,
                scfg.pt, scfg.ps, scfg.w_s)
        bad = tile_oob(sites[:, 1], sites[:, 2], scfg.w_s, 0, H - scfg.ps + 1,
                       wp)
        if not torch.equal(patch_dist_tile(*args, 0, H - scfg.ps + 1, wp),
                           patch_dist(*args).masked_fill(bad[None],
                                                         float("inf"))):
            raise AssertionError(f"K1 tile s{stage}: whole frame not bitwise "
                                 f"K1 + mask")
        log("k1_tile_whole_frame", stage=stage, sites=sites.shape[0],
            bitwise_equal_k1_plus_mask=True)
    return err, record


def tile_full_phase(yuv, shape, dev):
    """The halo tile's all-rows search (``exec_search_dense_tile`` under
    HALO_ALL_ROWS: K3 planes of the tile and of the full-frame coarse
    levels, no bf16 rounding) against its plain version, stage 0, the first
    4096 sites of strip 0 and the last 4096 of strip 3 of the 4-strip
    split, one K3 launch per (level, dt): the f32 rounding of the
    distances, |d| <= 1e-5 (q2 + b2) + 1e-3 per level in raw units, with
    (q2 + b2) / norm <= 2."""
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch.ops.dense_dist import dense_dist
    from vnlb_tpu_torch.ops.search import eff_dt_range
    from vnlb_tpu_torch.ops.search_dense import exec_search_dense_tile
    from vnlb_tpu_torch.parallel.halo import (_coarse, _plan_strip_sites,
                                              _strip_geometry)

    scfg = vt.default_config(SIGMA, **HALO_CFG, **HALO_ALL_ROWS).stage(0)
    halo, hs, h_run = _strip_geometry(shape, scfg, 4)
    coarse = _coarse(yuv, scfg, hs)
    dt_lo, dt_hi = eff_dt_range(scfg, shape[0])
    planes = (1 + len(coarse)) * (dt_hi - dt_lo + 1)
    plain = dict(dist_fn=vt.PLAIN.patch_dist,
                 tile_fn=vt.PLAIN.patch_dist_tile,
                 dense_fn=vt.PLAIN.dense_dist)
    hp_g = h_run - scfg.ps + 1
    norm = scfg.pt * scfg.dist_chnls * scfg.ps ** 2 * 255.0 ** 2
    tol = (1 + len(coarse)) * (2e-5 + 1e-3 / norm)
    for strip in (0, 3):
        sites, gy = _plan_strip_sites(shape, scfg, 4, halo, strip)
        part = slice(-4096, None) if strip == 3 else slice(0, 4096)
        sites = torch.from_numpy(sites[part]).to(dev)
        gy = torch.from_numpy(gy[part]).to(dev)
        tile = strip_tile(yuv, strip, hs, halo)
        args = (tile, sites, gy, scfg, strip * hs - halo, hp_g, coarse)
        dense_dist.launches = 0
        vk, ik = exec_search_dense_tile(*args)
        launched = dense_dist.launches
        vp, ip = exec_search_dense_tile(*args, **plain)
        if launched != planes or dense_dist.launches != launched:
            raise AssertionError(f"tile_full strip {strip}: K3 launches "
                                 f"{launched}, plain run "
                                 f"{dense_dist.launches - launched}")
        agree = tie_aware(f"tile_full strip {strip}", vk, ik, vp, ip, tol)
        log("tile_full", stage=0, strip=strip, sites=sites.shape[0],
            tile=f"{tile.shape[2]}x{tile.shape[3]}", levels=1 + len(coarse),
            k3_launches=launched, value_tol=f"{tol:.3g}",
            index_agreement=f"{agree:.4f}")


def halo_strips_phase(vt, noisy, clean, dev, counters, mono):
    """strip_runner over the four strips of both passes, then
    combine_strips, against the one-card pass under mask borders
    (``mono`` = its (deno, basic)); one strip again with the plain
    versions.  Returns the launches of the composed run."""
    from vnlb_tpu_torch.parallel.halo import combine_strips, strip_runner
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    cfg = vt.default_config(SIGMA, **HALO_CFG)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    basic = None
    for stage in (0, 1):
        tiles, meta = [], None
        for i in range(4):
            run, meta = strip_runner(noisy, basic, cfg.stage(stage), 4, i,
                                     device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            ts = time.perf_counter()
            tiles.append(run())
            torch.cuda.synchronize()
            log("halo_strip", stage=stage, strip=i, sites=meta["sites"],
                tile=f"{meta['hs'] + 2 * meta['halo']}x{W}",
                seconds=f"{time.perf_counter() - ts:.4f}",
                peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f}",
                held_before_gib=f"{base / 2 ** 30:.3f}")
            del run
        out = combine_strips(tiles, cfg.stage(stage), noisy, basic, meta)
        del tiles
        if stage == 0:
            basic = out
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    need = ("patch_dist", "patch_dist_tile", "econ_filter", "patch_gather")
    if any(launches[k] == 0 for k in need) or launches["dense_dist"] \
            or launches["poly_filter"]:
        raise AssertionError(f"halo_strips: launches {launches}")
    deno_np, basic_np = out.cpu().numpy(), basic.cpu().numpy()
    m_deno, m_basic = (x.cpu().numpy() for x in mono)
    stats = {}
    for name, got, want in (("basic", basic_np, m_basic),
                            ("deno", deno_np, m_deno)):
        mx, mean = assert_close(f"halo_strips {name}", got, want)
        dpsnr = abs(compute_psnr(got, clean) - compute_psnr(want, clean))
        if not dpsnr <= 0.02:
            raise AssertionError(f"halo_strips {name}: PSNR differs by "
                                 f"{dpsnr} dB")
        stats[name] = f"{mx:.4g}/{mean:.4g}/{dpsnr:.4g}"
    log("halo_strips", seconds=f"{wall:.3f}",
        psnr_basic=f"{compute_psnr(basic_np, clean):.4f}",
        psnr_deno=f"{compute_psnr(deno_np, clean):.4f}",
        basic_max_mean_dpsnr=stats["basic"],
        deno_max_mean_dpsnr=stats["deno"], **launches)

    # one strip with the plain versions: the same tile within the
    # plain-pass bound of the e2e phases (0.02 dB of the normalized tile)
    scfg = cfg.stage(0)
    run, meta = strip_runner(noisy, None, scfg, 4, 1, device=dev)
    got = run()
    run_p, _ = strip_runner(noisy, None, scfg, 4, 1, device=dev,
                            kernels=vt.PLAIN)
    t0 = time.perf_counter()
    want = run_p()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    lo = meta["halo"]
    hi = lo + meta["hs"]
    ref = torch.from_numpy(clean[:, :, meta["hs"]:2 * meta["hs"]]).to(dev)
    norm = []
    for d, w in (got, want):
        d, w = d[:, :, lo:hi], w[:, lo:hi]
        norm.append(d / w.clamp(min=1e-6)[:, None])
    from vnlb_tpu_torch.ops import color

    psnrs = [compute_psnr(color.yuv2rgb(x).cpu().numpy(), ref.cpu().numpy())
             for x in norm]
    mad = (norm[0] - norm[1]).abs().mean().item()
    log("halo_strip_plain", strip=1, stage=0, seconds=f"{plain_s:.3f}",
        psnr_kernels=f"{psnrs[0]:.4f}", psnr_plain=f"{psnrs[1]:.4f}",
        mean_abs_diff=f"{mad:.4g}")
    if not abs(psnrs[0] - psnrs[1]) < 0.02:
        raise AssertionError("halo_strip_plain: kernels and plain versions "
                             "differ by >= 0.02 dB")
    return launches


# the kernels each program of the 2-rank world must launch on every rank
# (the others must not)
WORLD_EXPECT = {
    "denoise_halo": {"patch_dist_tile", "patch_dist", "econ_filter",
                     "patch_gather", "scatter_rows"},
    "flow_halo": {"patch_dist", "econ_filter", "patch_gather",
                  "scatter_rows"},
    "all_rows_halo": {"dense_dist", "econ_filter", "patch_gather",
                      "scatter_rows"},
    "denoise_sharded": {"patch_dist", "econ_filter", "patch_gather",
                        "scatter_rows"},
    "streaming_mesh": {"patch_dist_tile", "patch_dist", "econ_filter",
                       "patch_gather", "scatter_rows"},
}
# the pipelined world's stages run streaming_mesh's two passes apart: stage
# 2 (stype "l2") builds no coarse level, so it launches no K1 dense entry
PIPE_EXPECT = {1: WORLD_EXPECT["streaming_mesh"],
               2: WORLD_EXPECT["streaming_mesh"] - {"patch_dist"}}


def halo_world_phase(vt, noisy, clean, dev, drift, mono):
    """A 2-rank gloo world on the one card: denoise_halo bitwise against
    the 2-strip composition, proc_nl_halo with the drift flow against the
    one-card flow pass, the all-rows tile branch (dense_rows="full",
    topk="stream", stage 0: K3 on the tiles, no bf16 rounding) against the
    one-card pass without the rounding, denoise_sharded against the
    mask-border denoise (``mono``), denoise_streaming(mesh=...) of a
    12-frame clip against the one-card streaming.  Every rank's launches of
    every program are checked against WORLD_EXPECT."""
    from vnlb_tpu_torch.parallel.halo import (combine_strips, denoise_halo,
                                              proc_nl_halo, strip_runner)
    from vnlb_tpu_torch.parallel.launch import run_world, sequence
    from vnlb_tpu_torch.parallel.tiled import denoise_sharded
    from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
    from vnlb_tpu_torch.utils.flow_io import expand_flows

    cfg = vt.default_config(SIGMA, **HALO_CFG)
    ff, bf = expand_flows(*drift)
    s_clean = synthetic_video(HALO_STREAM_T, H, W, seed=0)
    s_noisy = add_noise(s_clean, SIGMA, seed=1)
    s_cfg = vt.default_config(SIGMA, **HALO_STREAM_CFG)
    full_cfg = vt.default_config(SIGMA, **HALO_CFG, **HALO_ALL_ROWS).stage(0)
    calls = {
        "denoise_halo": (denoise_halo, (noisy, SIGMA), dict(cfg=cfg)),
        "flow_halo": (proc_nl_halo, (noisy, None, ff, bf,
                                     vt.default_config(SIGMA).stage(0)), {}),
        "all_rows_halo": (proc_nl_halo, (noisy, None, None, None, full_cfg),
                          {}),
        "denoise_sharded": (denoise_sharded, (noisy, SIGMA), dict(cfg=cfg)),
        "streaming_mesh": (vt.denoise_streaming, (s_noisy, SIGMA),
                           dict(chunk=STREAM_CHUNK, cfg=s_cfg)),
    }
    t0 = time.perf_counter()
    # the ranks at this process's torch threads: on the host the plain
    # versions' batched products round with the thread count
    ranks = run_world(sequence, 2, args=(list(calls.values()),),
                      device=str(dev), threads=torch.get_num_threads())
    world_s = time.perf_counter() - t0
    for rank, outs in enumerate(ranks):
        for name, (_, _, launches) in zip(calls, outs):
            log("halo_world_launches", rank=rank, program=name, **launches)
            if any((n > 0) != (k in WORLD_EXPECT[name])
                   for k, n in launches.items()):
                raise AssertionError(f"halo_world {name} rank {rank}: "
                                     f"launches {launches}, expected "
                                     f"{sorted(WORLD_EXPECT[name])}")
    out = {name: o for name, o in zip(calls, ranks[0])}
    for r in ranks[1:]:
        for (a, _, _), (b, _, _) in zip(ranks[0], r):
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            if not all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2])):
                raise AssertionError("halo_world: the ranks' outputs differ")

    # denoise_halo against the 2-strip composition on this process
    basic = None
    for stage in (0, 1):
        tiles, meta = [], None
        for i in range(2):
            run, meta = strip_runner(noisy, basic, cfg.stage(stage), 2, i,
                                     device=dev)
            tiles.append(run())
        basic_or_deno = combine_strips(tiles, cfg.stage(stage), noisy, basic,
                                       meta)
        if stage == 0:
            basic = basic_or_deno
    comp = (basic_or_deno.cpu().numpy(), basic.cpu().numpy())
    if not all(np.array_equal(a, b)
               for a, b in zip(out["denoise_halo"][0], comp)):
        raise AssertionError("halo_world: denoise_halo is not bitwise equal "
                             "to the 2-strip composition")
    noisy_t = torch.from_numpy(noisy).to(dev)
    flow_ref = vt.proc_nl(noisy_t, None, None, torch.from_numpy(ff).to(dev),
                          torch.from_numpy(bf).to(dev),
                          vt.default_config(SIGMA).stage(0)).cpu().numpy()
    flow_err = assert_close("halo_world flow", out["flow_halo"][0], flow_ref)
    full_ref = vt.proc_nl(noisy_t, None, None, None, None,
                          full_cfg.replace(search_bf16=False)).cpu().numpy()
    full_err = assert_close("halo_world all rows", out["all_rows_halo"][0],
                            full_ref)
    m_deno, m_basic = (x.cpu().numpy() for x in mono)
    sh_out = out["denoise_sharded"][0]
    sh_err = [assert_close(f"halo_world sharded {n}", g, w)
              for n, g, w in (("deno", sh_out[0], m_deno),
                              ("basic", sh_out[1], m_basic))]
    t1 = time.perf_counter()
    sd, sb, one_s = vt.denoise_streaming(s_noisy, SIGMA, chunk=STREAM_CHUNK,
                                         cfg=s_cfg, device=dev)
    st_out = out["streaming_mesh"][0]
    st_err = [assert_close(f"halo_world streaming {n}", g, w)
              for n, g, w in (("deno", st_out[0], sd),
                              ("basic", st_out[1], sb))]
    log("halo_world", ranks=2, backend="gloo", device=str(dev),
        world_seconds=f"{world_s:.2f}",
        denoise_halo_s=f"{out['denoise_halo'][1]:.3f}",
        bitwise_equal_2_strip_composition=True,
        flow_halo_s=f"{out['flow_halo'][1]:.3f}",
        flow_max_mean=f"{flow_err[0]:.4g}/{flow_err[1]:.4g}",
        all_rows_halo_s=f"{out['all_rows_halo'][1]:.3f}",
        all_rows_max_mean=f"{full_err[0]:.4g}/{full_err[1]:.4g}",
        sharded_s=f"{out['denoise_sharded'][1]:.3f}",
        sharded_deno_max_mean=f"{sh_err[0][0]:.4g}/{sh_err[0][1]:.4g}",
        streaming_mesh_s=f"{out['streaming_mesh'][1]:.3f}",
        streaming_one_card_s=f"{one_s:.3f}",
        streaming_deno_max_mean=f"{st_err[0][0]:.4g}/{st_err[0][1]:.4g}",
        reference_s=f"{time.perf_counter() - t1:.2f}")
    return out["streaming_mesh"], one_s


def pipe_world_phase(vt, dev, mesh_stream, one_s):
    """denoise_pipelined(meshes=...) in a 4-rank gloo world on the one card
    (2 stages x 2 strips, ``pipelined_world``) on halo_world's 12-frame
    clip: bitwise equal to the 2-rank denoise_streaming(mesh=...) of
    ``mesh_stream`` ((deno, basic, seconds), in-world wall), at the same
    torch threads; each rank's launches against its stage's PIPE_EXPECT.
    Logs the walls, each stage's busy seconds and the stage edge's bytes
    and seconds."""
    from vnlb_tpu_torch.parallel.launch import run_world, sequence
    from vnlb_tpu_torch.parallel.pipe import pipelined_world
    from vnlb_tpu_torch.testing.data import add_noise, synthetic_video

    s_noisy = add_noise(synthetic_video(HALO_STREAM_T, H, W, seed=0), SIGMA,
                        seed=1)
    s_cfg = vt.default_config(SIGMA, **HALO_STREAM_CFG)
    t0 = time.perf_counter()
    ranks = run_world(sequence, 4, args=(
        [(pipelined_world, (s_noisy, SIGMA),
          dict(sizes=(2, 2), chunk=STREAM_CHUNK, cfg=s_cfg))],),
        device=str(dev), threads=torch.get_num_threads())
    world_s = time.perf_counter() - t0
    (sdeno, sbasic, _), stream_wall = mesh_stream[0], mesh_stream[1]
    stats, walls = [], []
    for rank, ((deno, basic, secs, st), wall, ln) in enumerate(
            r[0] for r in ranks):
        if not (np.array_equal(deno, sdeno) and np.array_equal(basic, sbasic)):
            raise AssertionError(f"pipe_world rank {rank}: not bitwise equal "
                                 f"to the 2-rank streaming_mesh output")
        log("pipe_world_launches", rank=rank, stage=st["stage"], **ln)
        if any((n > 0) != (k in PIPE_EXPECT[st["stage"]])
               for k, n in ln.items()):
            raise AssertionError(f"pipe_world rank {rank}: launches {ln}, "
                                 f"expected "
                                 f"{sorted(PIPE_EXPECT[st['stage']])}")
        stats.append(st)
        walls.append(wall)
    if [st["stage"] for st in stats] != [1, 1, 2, 2]:
        raise AssertionError(f"pipe_world: stages {stats}")
    log("pipe_world", ranks=4, stages="2x2", backend="gloo", device=str(dev),
        frames=HALO_STREAM_T, chunk=STREAM_CHUNK,
        bitwise_equal_streaming_mesh=True,
        world_seconds=f"{world_s:.2f}", pipelined_s=f"{secs:.3f}",
        in_world_s=",".join(f"{w:.3f}" for w in walls),
        streaming_mesh_2rank_s=f"{stream_wall:.3f}",
        streaming_one_card_s=f"{one_s:.3f}",
        busy_s=",".join(f"{st['busy_s']:.3f}" for st in stats),
        edge_bytes_sent=sum(st["edge_bytes"] for st in stats[:2]),
        edge_send_s=",".join(f"{st['edge_s']:.4f}" for st in stats[:2]),
        edge_wait_s=",".join(f"{st['edge_s']:.4f}" for st in stats[2:]))


def run_script(name, script, args, launches_api, cache=None):
    """A script of the repository as a subprocess on the card with the
    main clip (``--dataset davis``: synthetic seed 0, noise seed 1, no
    data root; ``cache``: its VNLB_TPU_CACHE): (stdout, wall seconds,
    kernel launches), the launches read in the subprocess after the
    script ends and held equal to the API-default e2e run's
    (``launches_api``)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(root, script)
    code = ("import json, runpy, sys; "
            f"sys.argv = {[script, '--dataset', 'davis', *args]!r}; "
            f"runpy.run_path({script!r}, run_name='__main__'); "
            "from vnlb_tpu_torch.pipeline import KERNELS; "
            "print(json.dumps({k.__name__: k.launches for k in KERNELS}))")
    env = dict(os.environ, VNLB_TPU_DATA=os.path.join(root, "build",
                                                      "no_data"))
    if cache is not None:
        env["VNLB_TPU_CACHE"] = cache
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{name}: exit {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
    launches = json.loads(res.stdout.strip().splitlines()[-1])
    for k, n in launches.items():
        if n != launches_api.get(k, 0):
            raise AssertionError(f"{name}: launches {launches}, the API "
                                 f"default's {launches_api}")
    return res.stdout, wall, launches


def cli_phase(launches_api, psnr_api):
    """``scripts/torch_example.py --dataset davis`` as a subprocess on the
    card: its printed PSNRs equal the API-default e2e run's (``psnr_api``
    = (basic, deno)) to the printed decimals, and its kernel launches
    equal that run's (``launches_api``)."""
    stdout, wall, launches = run_script(
        "cli", "scripts/torch_example.py", [], launches_api)
    out = stdout.strip().splitlines()
    printed = {m.group(1): m.group(2) for m in (
        re.match(r"psnr\s+(\w+): ([\d.]+) dB", line) for line in out) if m}
    ssim = re.search(r"ssim\s+deno: ([\d.]+) \(([\d.]+)s\)", stdout)
    want = {"basic": f"{psnr_api[0]:.3f}", "deno": f"{psnr_api[1]:.3f}"}
    if {k: printed.get(k) for k in want} != want:
        raise AssertionError(f"cli: printed PSNRs {printed}, the API "
                             f"default's {want}")
    denoise_s = re.search(r"time: ([\d.]+)s", stdout).group(1)
    log("cli", command="scripts/torch_example.py --dataset davis",
        wall_s=f"{wall:.2f}", denoise_s=denoise_s,
        psnr_noisy=printed["noisy"], psnr_basic=printed["basic"],
        psnr_deno=printed["deno"], api_default=f"{want['basic']}/"
        f"{want['deno']}", ssim=ssim.group(1), ssim_s=ssim.group(2),
        ssim_share=f"{float(ssim.group(2)) / wall:.3f}", **launches)


def analysis_scripts_phase(launches_api, psnr_api):
    """The two analysis scripts as subprocesses on the card, on the main
    clip, under a new result cache: ``scripts/torch_deno_v_basic.py``
    prints the API-default e2e run's basic / deno PSNRs (``psnr_api``) to
    its 3 decimals and a line per frame and region;
    ``exps/torch_interp_square.py`` makes its vnlb output with the API
    default and its blurred stand-ins, and its vnlb vertex (alpha, beta) =
    (1, 0) is that run's deno PSNR to 4 decimals.  Each launches the API
    default's kernels as often as that run (``launches_api``)."""
    import tempfile

    stdout, wall, launches = run_script(
        "analysis_scripts deno_v_basic", "scripts/torch_deno_v_basic.py", [],
        launches_api)
    total = re.search(r"basic: ([\d.]+) dB\s+deno: ([\d.]+) dB", stdout)
    frames = re.findall(r"frame (\d+) (edge|flat): basic ([\d.]+)\s+deno "
                        r"([\d.]+)\s+delta ([+-][\d.]+) dB", stdout)
    want = (f"{psnr_api[0]:.3f}", f"{psnr_api[1]:.3f}")
    if total is None or total.groups() != want or len(frames) != 2 * T:
        raise AssertionError(f"analysis_scripts: torch_deno_v_basic.py "
                             f"printed {stdout[:2000]!r}, the API default's "
                             f"basic / deno {want}")
    deltas = {r: [float(f[4]) for f in frames if f[1] == r]
              for r in ("edge", "flat")}
    log("analysis_scripts", script="scripts/torch_deno_v_basic.py",
        wall_s=f"{wall:.2f}", psnr_basic=want[0], psnr_deno=want[1],
        frame_lines=len(frames),
        edge_delta_db=",".join(f"{d:+.3f}" for d in deltas["edge"]),
        flat_delta_db=",".join(f"{d:+.3f}" for d in deltas["flat"]),
        **launches)
    with tempfile.TemporaryDirectory() as cache:
        stdout, wall, launches = run_script(
            "analysis_scripts interp_square", "exps/torch_interp_square.py",
            [], launches_api, cache=cache)
    # the surface, then the launches line
    table = json.loads(stdout.strip().rsplit("\n", 1)[0])
    vertex = {(r["alpha"], r["beta"]): r["psnr"] for r in table["surface"]}
    if f"{vertex[1.0, 0.0]:.4f}" != f"{psnr_api[1]:.4f}":
        raise AssertionError(f"analysis_scripts: torch_interp_square.py's "
                             f"vnlb vertex {vertex[1.0, 0.0]}, the API "
                             f"default's deno {psnr_api[1]}")
    log("analysis_scripts", script="exps/torch_interp_square.py",
        wall_s=f"{wall:.2f}", points=len(vertex),
        vnlb_vertex_psnr=f"{vertex[1.0, 0.0]:.6f}",
        api_default_deno=f"{psnr_api[1]:.6f}",
        vertex_minus_api_db=f"{vertex[1.0, 0.0] - psnr_api[1]:.3g}",
        best=f"{table['best']['alpha']},{table['best']['beta']}",
        best_psnr=f"{table['best']['psnr']:.4f}", **launches)


# the estimated-flow, reference-order and aggregation-mode phases: a
# 480p clip that moves 4 px a frame; TV-L1 and LK on the card against the
# same function on the CPU at tests/test_torch_flow_est.py's tolerances
FLOW_MOTION = 4.0
TVL1_MEAN, TVL1_MAX, LK_MAX = 1e-4, 0.25, 5e-4
# the reference-order pass runs the main clip's first 3 frames: its
# plain-version pass took 90-95 s at 5 (one host round trip per batch)
COMPAT_FRAMES = 3
# one API-default denoise per aggregation mode (tests/test_torch_agg_modes)
AGG_MODES = {"exp": dict(agg_weight="exp"),
             "exp_dense_full": dict(agg_weight="exp", dense_rows="full"),
             "only_frame": dict(only_frame=2), "agg_bf16": dict(agg_bf16=True),
             "left_regime": dict(poly_gram=False)}


def flow_est_phase(vt, noisy, dev):
    """``estimate_flows`` of a 5x480x854 clip on the card, TV-L1 and LK:
    wall per frame pair (synced; the best of a cold run and its bitwise
    repeat), peak memory, mean |flow|; the first
    forward and last backward pair held to the same function on the CPU.
    Returns the TV-L1 (fflow, bflow) on the card."""
    from vnlb_tpu_torch.ops.flow import estimate_flows, lk_flow, tvl1_flow

    out = None
    for method, one in (("tvl1", tvl1_flow), ("lk", lk_flow)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, runs = [], []
        for _ in range(2):          # the first run is cold, the second warm
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            runs.append(estimate_flows(noisy, method=method, device=dev))
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        (ff, bf), again = runs
        peak = torch.cuda.max_memory_allocated(dev)
        pairs = 2 * (noisy.shape[0] - 1)
        t0 = time.perf_counter()
        cpu = [one(noisy[0], noisy[1], device="cpu"),
               one(noisy[-1], noisy[-2], device="cpu")]
        cpu_s = (time.perf_counter() - t0) / 2
        d = torch.stack([(ff[0].cpu() - cpu[0]).abs(),
                         (bf[-1].cpu() - cpu[1]).abs()])
        mag = ff[:-1].abs().mean().item()
        repeat = torch.equal(again[0], ff) and torch.equal(again[1], bf)
        log("flow_est", method=method, frames=noisy.shape[0], pairs=pairs,
            seconds=",".join(f"{w:.4f}" for w in walls),
            ms_per_pair=f"{1e3 * min(walls) / pairs:.2f}",
            cold_ms_per_pair=f"{1e3 * walls[0] / pairs:.2f}",
            cpu_ms_per_pair=f"{1e3 * cpu_s:.1f}",
            peak_mem_gib=f"{peak / 2 ** 30:.3f}", mean_abs_flow=f"{mag:.4f}",
            card_vs_cpu_max=f"{d.max().item():.3g}",
            card_vs_cpu_mean=f"{d.mean().item():.3g}",
            repeat_bitwise=repeat)
        ok = (d.max().item() <= LK_MAX if method == "lk" else
              d.mean().item() <= TVL1_MEAN and d.max().item() <= TVL1_MAX)
        if not (ok and repeat and mag > 1.0 and torch.isfinite(ff).all()):
            raise AssertionError(f"flow_est {method}: card vs CPU max "
                                 f"{d.max().item()} mean {d.mean().item()}, "
                                 f"mean |flow| {mag}, repeat {repeat}")
        if method == "tvl1":
            out = (ff, bf)
        del ff, bf, again, runs
    return out


def gather_launches(yuv, cfg):
    """K1 launches of one ``denoise`` whose every site takes the gather
    search: one per (site chunk, pyramid level) of each pass."""
    from vnlb_tpu_torch.ops.mask import lattice_sites
    from vnlb_tpu_torch.ops.search import search_levels
    from vnlb_tpu_torch.pipeline import SITE_CHUNK

    n = 0
    for i in (0, 1):
        s = lattice_sites(tuple(yuv.shape), cfg.stage(i)).shape[0]
        n += -(-s // SITE_CHUNK) * len(search_levels(yuv, cfg.stage(i)))
    return n


def e2e_flow_phase(vt, noisy, clean, dev, counters, expect, flows):
    """``denoise`` with the estimated flows (e2e: best of 3, a bitwise
    repeat, the plain-version pass within 0.01 dB), every site on the
    gather search (K1's window-start entry: its launches equal one per
    site chunk and level), beside the zero-flow run of the same clip."""
    from vnlb_tpu_torch.ops import color
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    launches, deno, basic, per = e2e(vt, "e2e_flow_est", noisy, clean, dev,
                                     counters, expect, flows=flows)
    want = gather_launches(color.rgb2yuv(torch.from_numpy(noisy).to(dev)),
                           vt.default_config(SIGMA))
    windows = sum(n for k, (_, n) in per.items() if k[-1])
    if not (launches["patch_dist"] == want == windows):
        raise AssertionError(f"e2e_flow_est: {launches['patch_dist']} K1 "
                             f"launches, {windows} with window starts, "
                             f"predicted {want}")
    z_deno, z_basic, z_s = vt.denoise(noisy, SIGMA, device=dev)
    zero = [compute_psnr(x.cpu().numpy(), clean) for x in (z_basic, z_deno)]
    gain = [compute_psnr(x.cpu().numpy(), clean) - z
            for x, z in zip((basic, deno), zero)]
    log("e2e_flow_est_vs_zero", k1_launches=want, k1_window_starts=windows,
        zero_flow_seconds=f"{z_s:.4f}", zero_flow_psnr_basic=f"{zero[0]:.4f}",
        zero_flow_psnr_deno=f"{zero[1]:.4f}", gain_basic_db=f"{gain[0]:.4f}",
        gain_deno_db=f"{gain[1]:.4f}")
    return launches


def compat_phase(vt, noisy, clean, dev):
    """``denoise_compat`` (the reference-order pass) with the kernels, with
    the plain versions and a repeat: each pass's wall, batches and sites
    drawn, K1 / K2 / K4 launches, PSNR, peak memory.  Returns the kernel
    run's launches."""
    import vnlb_tpu_torch.compat as compat
    from vnlb_tpu_torch.ops.econ_filter import econ_filter
    from vnlb_tpu_torch.ops.patch_dist import patch_dist
    from vnlb_tpu_torch.ops.patch_gather import patch_gather
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    counters = (patch_dist, econ_filter, patch_gather)
    orig = compat.proc_nl_compat
    walls, calls = [], []

    def timed(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        return out

    def counting(gather):
        def run(videos, inds, *a):
            calls.append((len(videos), inds.shape[0]))
            return gather(videos, inds, *a)
        return run

    runs = {}
    compat.proc_nl_compat = timed
    try:
        for tag, kern in (("kernels", vt.KERNELS), ("plain", vt.PLAIN),
                          ("repeat", vt.KERNELS)):
            for c in counters:
                c.launches = 0
            walls.clear()
            calls.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            deno, basic = compat.denoise_compat(
                noisy, SIGMA, device=dev,
                kernels=kern._replace(
                    patch_gather=counting(kern.patch_gather)))
            peak = torch.cuda.max_memory_allocated(dev)
            n = {c.__name__: c.launches for c in counters}
            pb = compute_psnr(basic.cpu().numpy(), clean)
            pd = compute_psnr(deno.cpu().numpy(), clean)
            per = [(sum(1 for v, _ in calls if v == nv),
                    sum(b for v, b in calls if v == nv)) for nv in (1, 2)]
            runs[tag] = (deno, basic, pb, pd, n)
            log("e2e_compat", run=tag, frames=noisy.shape[0],
                reduced=f"{noisy.shape[0]} of {T} frames",
                pass_seconds=",".join(f"{w:.3f}" for w in walls),
                batches=f"{per[0][0]},{per[1][0]}",
                sites=f"{per[0][1]},{per[1][1]}",
                psnr_basic=f"{pb:.4f}", psnr_deno=f"{pd:.4f}",
                peak_mem_gib=f"{peak / 2 ** 30:.3f}", **n)
    finally:
        compat.proc_nl_compat = orig
    d, b, pb, pd, n = runs["kernels"]
    _, _, qb, qd, m = runs["plain"]
    if not (min(n.values()) > 0 and max(m.values()) == 0):
        raise AssertionError(f"e2e_compat: launches {n}, plain {m}")
    if not (abs(pb - qb) < 0.02 and abs(pd - qd) < 0.02):
        raise AssertionError(f"e2e_compat: kernels {pb}/{pd} vs plain "
                             f"{qb}/{qd}")
    if not (torch.equal(runs["repeat"][0], d)
            and torch.equal(runs["repeat"][1], b)):
        raise AssertionError("e2e_compat: repeat run is not bitwise equal")
    if not pd >= compute_psnr(noisy, clean) + 6.0:
        raise AssertionError(f"e2e_compat: deno {pd}")
    return n


def agg_modes_phase(vt, noisy, clean, dev, counters):
    """One API-default ``denoise`` per aggregation mode with the kernels
    (counted), a bitwise repeat and the plain-version pass within 0.02
    dB; the left regime launches K2 only for the first pass's chunks."""
    from vnlb_tpu_torch.ops import color
    from vnlb_tpu_torch.pipeline import SITE_CHUNK, plan_sites
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    shape = tuple(noisy.shape)
    launches = {}
    for name, kw in AGG_MODES.items():
        cfg = vt.default_config(SIGMA, **kw)
        for c in counters:
            c.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        deno, basic, sec = vt.denoise(noisy, SIGMA, cfg=cfg, device=dev)
        n = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated(dev)
        d2, b2, sec2 = vt.denoise(noisy, SIGMA, cfg=cfg, device=dev)
        if not (torch.equal(d2, deno) and torch.equal(b2, basic)):
            raise AssertionError(f"agg mode {name}: repeat not bitwise")
        dp, bp, plain_s = vt.denoise(noisy, SIGMA, cfg=cfg, device=dev,
                                     kernels=vt.PLAIN)
        ps_ = [compute_psnr(x.cpu().numpy(), clean)
               for x in (basic, deno, bp, dp)]
        extra = {}
        if name == "left_regime":
            sites, n_dense = plan_sites(shape, cfg.stage(0), True)
            s0_chunks = (-(-n_dense // SITE_CHUNK)
                         + -(-(sites.shape[0] - n_dense) // SITE_CHUNK))
            extra = dict(stage0_chunks=s0_chunks)
            if n["econ_filter"] != s0_chunks:
                raise AssertionError(f"left regime: {n['econ_filter']} K2 "
                                     f"launches, {s0_chunks} first-pass "
                                     f"chunks")
        if name == "exp_dense_full" and n["dense_dist"] != k3_launches(
                color.rgb2yuv(torch.from_numpy(noisy).to(dev)), cfg):
            raise AssertionError(f"{name}: K3 launches {n}")
        log("e2e_agg_modes", mode=name, seconds=f"{sec:.4f},{sec2:.4f}",
            plain_seconds=f"{plain_s:.3f}", psnr_basic=f"{ps_[0]:.4f}",
            psnr_deno=f"{ps_[1]:.4f}", plain_psnr_basic=f"{ps_[2]:.4f}",
            plain_psnr_deno=f"{ps_[3]:.4f}",
            peak_mem_gib=f"{peak / 2 ** 30:.3f}", repeat_bitwise=True,
            **n, **extra)
        if not (abs(ps_[0] - ps_[2]) < 0.02 and abs(ps_[1] - ps_[3]) < 0.02
                and min(n["patch_dist"], n["patch_gather"]) > 0
                and np.isfinite(deno.cpu().numpy()).all()):
            raise AssertionError(f"agg mode {name}: PSNR {ps_}, launches {n}")
        launches[name] = n
        del deno, basic, d2, b2, dp, bp
    return launches


# the oracle phase: the card's kernels and passes against the C++ oracle
# (vnlb_tpu_torch/oracle/vnlb_oracle.cpp, sequential f64) and the NumPy
# oracle (testing/npref.py).  (b)-(e) on a 5x96x112 clip; (f) the one-pass
# clip and config of tests/test_oracle.py::test_end_to_end_parity; (g)
# scripts/compare_oracle.py's size and config (l2 in both passes), once
# with the oracle's own semantics (all K aggregated, f32 columns)
ORACLE_CLIP = (5, 96, 112)
ORACLE_SITES, ORACLE_AGG_SITES = 256, 4096
ORACLE_E2E = dict(stype="l2", agg_k=0, cols_bf16=False, eig_method="jacobi")
ORACLE_G = dict(preset="iphone", stype=["l2", "l2"], eig_method="jacobi")
ORACLE_EXACT = dict(agg_k=0, cols_bf16=False)


def oracle_topk(name, vals, inds, o_vals, o_inds, tol=1e-5):
    """tests/test_oracle.py::assert_topk_match's rule: indices differ only
    where the distances agree within ``tol``; the values agree to rtol
    1e-4, atol 1e-5.  Returns (index agreement, max |dv| over finite
    values)."""
    vals, inds = vals.cpu().numpy(), inds.cpu().numpy()
    neq = np.where(inds != o_inds)
    if neq[0].size and not np.abs(vals[neq] - o_vals[neq]).max() < tol:
        raise AssertionError(f"oracle {name}: indices differ beyond ties")
    np.testing.assert_allclose(vals, o_vals, rtol=1e-4, atol=1e-5,
                               err_msg=f"oracle {name}")
    fin = np.isfinite(o_vals)
    return 1.0 - neq[0].size / inds.size, float(np.abs(vals - o_vals)[fin]
                                                 .max())


def rel_mean(got, want):
    """Mean relative error: mean |got - want| / mean |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).mean() / (np.abs(want).mean() + 1e-10))


def launches_of(counters, name, want):
    """The launches of each counter since they were set to 0; raises
    unless the kernels in ``want`` launched."""
    got = {c.__name__: c.launches for c in counters}
    if not all(got[k] > 0 for k in want):
        raise AssertionError(f"oracle {name}: launches {got}, expected "
                             f"{sorted(want)} > 0")
    return got


def oracle_phase(vt, dev):
    """The card against both oracles: (a) colour and lattice, (b) the gather
    search on K1's window-start entry, (c) the dense search on K1's dense
    entry and on K3, (d) K4 bitwise, (e) scatter, fold and finalize against
    npref, (f) one pass and (g) both passes against the oracle's, with K2
    (poly) held to the jacobi run.  The oracle's passes of (f) and (g) run
    in threads beside the card's checks (ctypes releases the GIL).  One
    line per check with its seconds, then the phase's."""
    from concurrent.futures import ThreadPoolExecutor

    from vnlb_tpu_torch.ops import agg, color
    from vnlb_tpu_torch.ops.dense_dist import dense_dist
    from vnlb_tpu_torch.ops.econ_filter import econ_filter
    from vnlb_tpu_torch.ops.gather import inds_to_rows
    from vnlb_tpu_torch.ops.mask import lattice_mask
    from vnlb_tpu_torch.ops.patch_dist import patch_dist
    from vnlb_tpu_torch.ops.patch_gather import patch_gather
    from vnlb_tpu_torch.ops.search import exec_search
    from vnlb_tpu_torch.ops.search_dense import exec_search_dense
    from vnlb_tpu_torch.testing import npref
    from vnlb_tpu_torch.testing import oracle as orc
    from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    counters = (patch_dist, dense_dist, patch_gather, econ_filter)

    def zero():
        for c in counters:
            c.launches = 0

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0

    t_phase = time.perf_counter()
    path = orc.library_path()
    compiled = not path.exists()
    _, build_s = timed(orc.lib)
    log("oracle_build", seconds=f"{build_s:.2f}", library=path.name,
        compiled=compiled)

    f_clean = synthetic_video(3, 32, 32, seed=5)
    f_noisy = add_noise(f_clean, SIGMA, seed=6)
    zf32 = np.zeros((3, 2, 32, 32), np.float32)
    f_cfg = vt.default_config(SIGMA, preset="iphone").stage(0).replace(
        **ORACLE_E2E)
    g_clean = synthetic_video(3, 48, 48, seed=0)
    g_noisy = add_noise(g_clean, SIGMA, seed=1)
    g_cfg = vt.default_config(SIGMA, **ORACLE_G)
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        g_job = pool.submit(timed, orc.oracle_denoise, g_noisy, SIGMA, g_cfg)
        f_job = pool.submit(timed, orc.oracle_proc_nl, f_noisy, None, zf32,
                            zf32, f_cfg)
        oracle_s = 0.0

        # ---- (a) colour and lattice ----
        t0 = time.perf_counter()
        t_len, h, w = ORACLE_CLIP
        v = np.random.default_rng(0).uniform(
            0, 255, (t_len, 3, h, w)).astype(np.float32)
        v_t = torch.from_numpy(v).to(dev)
        err = [np.abs(fn(v_t).cpu().numpy() - ofn(v)).max() for fn, ofn in
               ((color.rgb2yuv, orc.oracle_rgb2yuv),
                (color.yuv2rgb, orc.oracle_yuv2rgb))]
        if not max(err) <= 1e-3:
            raise AssertionError(f"oracle colour: max |d| {err}")
        n_lat = 0
        for shape in ((3, 3, 32, 32), (4, 3, 41, 37), (t_len, 3, h, w),
                      (T, 3, H, W)):
            for kw in (dict(preset="iphone"), dict(preset="iphone",
                                                   step_s=6)):
                for stage in vt.default_config(SIGMA, **kw).stages:
                    if not np.array_equal(lattice_mask(shape, stage),
                                          orc.oracle_lattice(shape, stage)):
                        raise AssertionError(f"oracle lattice {shape}")
                    n_lat += 1
        log("oracle_color_lattice", rgb2yuv_max=f"{err[0]:.3g}",
            yuv2rgb_max=f"{err[1]:.3g}", atol=1e-3, lattices_equal=n_lat,
            seconds=f"{time.perf_counter() - t0:.2f}")

        # ---- (b) the gather search on K1's window-start entry ----
        clean = synthetic_video(t_len, h, w, seed=0)
        yuv_np = color.rgb2yuv(torch.from_numpy(add_noise(
            clean, SIGMA, seed=1))).numpy()
        yuv2_np = color.rgb2yuv(torch.from_numpy(clean)).numpy()
        yuv = torch.from_numpy(yuv_np).to(dev)
        rng = np.random.default_rng(1)
        cases = []
        # tests/test_oracle.py::test_search_parity_l2 and _needle's inputs
        r = np.random.default_rng(1)
        vid = r.uniform(0, 255, (4, 3, 40, 44)).astype(np.float32)
        ffl = r.uniform(-2, 2, (4, 2, 40, 44)).astype(np.float32)
        bfl = r.uniform(-2, 2, (4, 2, 40, 44)).astype(np.float32)
        cases.append(("l2_test", vid, ffl, bfl, np.array(
            [[1, 4, 6], [2, 20, 30], [0, 0, 0], [2, 33, 37]], np.int32),
            vt.default_config(SIGMA).stage(1).replace(nwt_b=2, nwt_f=2,
                                                      npatches=12)))
        r = np.random.default_rng(2)
        vid = r.uniform(0, 255, (3, 3, 64, 64)).astype(np.float32)
        z64 = np.zeros((3, 2, 64, 64), np.float32)
        cases.append(("needle_test", vid, z64, z64, np.array(
            [[1, 10, 12], [0, 40, 40]], np.int32),
            vt.default_config(SIGMA).stage(0).replace(
                nwt_b=1, nwt_f=1, npatches=10, stype="needle")))
        s1 = vt.default_config(SIGMA).stage(1)
        ffl = rng.uniform(-2, 2, (t_len, 2, h, w)).astype(np.float32)
        bfl = rng.uniform(-2, 2, (t_len, 2, h, w)).astype(np.float32)
        sites = np.stack([rng.integers(0, t_len - s1.pt + 1, ORACLE_SITES),
                          rng.integers(0, h - s1.ps + 1, ORACLE_SITES),
                          rng.integers(0, w - s1.ps + 1, ORACLE_SITES)],
                         1).astype(np.int32)
        cases.append(("flow_s1", yuv_np, ffl, bfl, sites, s1))
        found = {}
        for name, vid, ffl, bfl, sites, cfg in cases:
            t0 = time.perf_counter()
            zero()
            vals, inds = exec_search(*(torch.from_numpy(a).to(dev) for a in
                                       (vid, sites, ffl, bfl)), cfg)
            n = launches_of(counters, f"search {name}", {"patch_dist"})
            card_s = time.perf_counter() - t0
            (o_vals, o_inds), o_s = timed(orc.oracle_search, vid, sites, ffl,
                                          bfl, cfg)
            oracle_s += o_s
            agree, dv = oracle_topk(f"search {name}", vals, inds, o_vals,
                                    o_inds)
            found[name] = (vid, inds, cfg)
            log("oracle_search", case=name, entry="K1 window starts",
                stype=cfg.stype, sites=len(sites), k=cfg.npatches,
                index_agreement=f"{agree:.6f}", max_abs_dv=f"{dv:.3g}",
                k1_launches=n["patch_dist"], seconds=f"{card_s:.2f}",
                oracle_seconds=f"{o_s:.2f}")

        # ---- (c) the dense search at zero flow on K1's dense entry and on
        # K3, interior sites; no bf16 rounding of the distances (the
        # oracle's f64 sums: search_bf16=False) ----
        half = (s1.w_s - 1) // 2
        isites = np.stack([
            rng.integers(0, t_len - s1.pt + 1, ORACLE_SITES),
            rng.integers(half, h - s1.ps - half + 1, ORACLE_SITES),
            rng.integers(half, w - s1.ps - half + 1, ORACLE_SITES)],
            1).astype(np.int32)
        z = np.zeros((t_len, 2, h, w), np.float32)
        d_cfg = s1.replace(search_bf16=False, cols_bf16=False)
        (o_vals, o_inds), o_s = timed(orc.oracle_search, yuv_np, isites, z, z,
                                      d_cfg)
        oracle_s += o_s
        for rows, kern in (("auto", "patch_dist"), ("full", "dense_dist")):
            t0 = time.perf_counter()
            zero()
            vals, inds = exec_search_dense(
                yuv, torch.from_numpy(isites).to(dev),
                d_cfg.replace(dense_rows=rows))
            n = launches_of(counters, f"dense {rows}", {kern})
            card_s = time.perf_counter() - t0
            agree, dv = oracle_topk(f"dense {rows}", vals, inds, o_vals,
                                    o_inds)
            log("oracle_dense", dense_rows=rows,
                entry="K1 dense" if rows == "auto" else "K3",
                sites=len(isites), search_bf16=False,
                index_agreement=f"{agree:.6f}", max_abs_dv=f"{dv:.3g}",
                launches=n[kern], seconds=f"{card_s:.2f}",
                oracle_seconds=f"{o_s:.2f}")

        # ---- (d) K4 at (b)'s indices, bitwise ----
        for name, (vid, inds, cfg) in found.items():
            t0 = time.perf_counter()
            # the large case reads two videos, as the second pass does
            vids = [vid] + ([yuv2_np] if name == "flow_s1" else [])
            zero()
            outs = patch_gather([torch.from_numpy(x).to(dev) for x in vids],
                                inds, cfg.ps, cfg.pt, False)
            n = launches_of(counters, f"gather {name}", {"patch_gather"})
            card_s = time.perf_counter() - t0
            i_np = inds.cpu().numpy()
            for x, out in zip(vids, outs):
                want, o_s = timed(orc.oracle_fill_patches, x, i_np, cfg.pt,
                                  cfg.ps)
                oracle_s += o_s
                b, k = i_np.shape
                want = want.transpose(0, 1, 3, 2, 4, 5).reshape(b, k, 3, -1)
                if not np.array_equal(out.cpu().numpy(), want):
                    raise AssertionError(f"oracle gather {name}: K4 is not "
                                         f"bitwise the oracle's")
            log("oracle_gather", case=name, videos=len(vids),
                groups=f"{i_np.shape[0]}x{i_np.shape[1]}",
                patch=f"{cfg.pt}x3x{cfg.ps}x{cfg.ps}", bitwise=True,
                k4_launches=n["patch_gather"], seconds=f"{card_s:.2f}")

        # ---- (e) scatter, fold and finalize against npref,
        # tests/test_npref.py's inputs at 4096 sites ----
        t0 = time.perf_counter()
        shape = (t_len, 3, h, w)
        cfg = vt.default_config(SIGMA, preset="default").stage(0)
        ps, pt, b, k = cfg.ps, cfg.pt, ORACLE_AGG_SITES, 10
        r = np.random.default_rng(3)
        inds = (r.integers(0, t_len - pt + 1, (b, k)) * 3 * h * w
                + r.integers(0, h - ps + 1, (b, k)) * w
                + r.integers(0, w - ps + 1, (b, k))).astype(np.int32)
        inds[0, :3] = -1
        patches = r.normal(0, 1, (b, k, pt, 3, ps, ps)).astype(np.float32)
        want_d = np.zeros(shape)
        want_w = np.zeros((t_len, h, w))
        npref.agg_patches(want_d, want_w, patches.astype(np.float64), inds,
                          ps, pt)
        ref_s = time.perf_counter() - t0
        p_t = torch.from_numpy(patches).to(dev)
        i_t = torch.from_numpy(inds).to(dev)
        valid = torch.ones((b, k), dtype=torch.bool, device=dev)
        d1, w1 = agg.agg_patches(torch.zeros((t_len * h * w, 3), device=dev),
                                 torch.zeros(t_len * h * w, device=dev), p_t,
                                 i_t, valid, pt, ps, shape)
        d1 = d1.cpu().numpy().reshape(t_len, h, w, 3).transpose(0, 3, 1, 2)
        w1 = w1.cpu().numpy().reshape(t_len, h, w)
        hp, wp = h - ps + 1, w - ps + 1
        acc = torch.zeros((t_len * hp * wp, pt * 3 * ps * ps + 1),
                          device=dev)
        acc = agg.agg_rows(acc, p_t, inds_to_rows(i_t, shape, ps, pt)[:, :, 0],
                           valid & (i_t >= 0), vt.KERNELS.scatter_rows)
        d2, w2 = (x.cpu().numpy() for x in agg.fold(acc, pt, ps, shape))
        errs = dict(pixel=(np.abs(d1 - want_d).max(),
                           np.abs(w1 - want_w).max()),
                    rows_fold=(np.abs(d2 - want_d).max(),
                               np.abs(w2 - want_w).max()))
        for key, (de, we) in errs.items():
            if not (de <= 1e-4 and we <= 1e-5):
                raise AssertionError(f"oracle agg {key}: max |d| {de}, "
                                     f"weights {we}")
        fd = r.normal(0, 1, shape).astype(np.float32)
        fw = r.integers(0, 3, (t_len, h, w)).astype(np.float32)
        fb = r.normal(0, 1, shape).astype(np.float32)
        got = agg.finalize_img(*(torch.from_numpy(x).to(dev)
                                 for x in (fd, fw, fb))).cpu().numpy()
        fin_err = np.abs(got - npref.finalize(fd.astype(np.float64),
                                              fw.astype(np.float64),
                                              fb.astype(np.float64))).max()
        if not fin_err <= 1e-5:
            raise AssertionError(f"oracle finalize: max |d| {fin_err}")
        log("oracle_agg", sites=b, k=k, patch=f"{pt}x3x{ps}x{ps}",
            shape="x".join(map(str, shape)),
            pixel_max=f"{errs['pixel'][0]:.3g}",
            pixel_weights_max=f"{errs['pixel'][1]:.3g}",
            rows_fold_max=f"{errs['rows_fold'][0]:.3g}",
            rows_fold_weights_max=f"{errs['rows_fold'][1]:.3g}",
            finalize_max=f"{fin_err:.3g}", atol="1e-4/1e-5/1e-5",
            seconds=f"{time.perf_counter() - t0:.2f}",
            npref_seconds=f"{ref_s:.2f}")

        # ---- (f) one pass with the kernels ----
        t0 = time.perf_counter()
        zt = torch.from_numpy(zf32).to(dev)
        zero()
        got = vt.proc_nl(torch.from_numpy(f_noisy).to(dev), None, None, zt,
                         zt, f_cfg).cpu().numpy()
        n = launches_of(counters, "one pass", {"patch_dist", "patch_gather"})
        card_s = time.perf_counter() - t0
        want, o_s = f_job.result()
        oracle_s += o_s
        rel, mx = rel_mean(got, want), float(np.abs(got - want).max())
        log("oracle_pass", clip="3x32x32", config="iphone s0, l2, agg_k=0, "
            "f32 columns, jacobi", mean_rel_err=f"{rel:.3g}",
            max_abs_err=f"{mx:.3g}", k1_launches=n["patch_dist"],
            k4_launches=n["patch_gather"], seconds=f"{card_s:.2f}",
            oracle_seconds=f"{o_s:.2f}")
        if not (rel < 2e-3 and mx < 10.0):
            raise AssertionError(f"oracle pass: mean relative {rel}, max "
                                 f"{mx}")

        # ---- (g) both passes at 3x48x48 ----
        runs = {}
        for name, kw, kerns in (
                ("jacobi", ORACLE_EXACT, {"patch_dist", "patch_gather"}),
                ("poly", dict(ORACLE_EXACT, eig_method="poly"),
                 {"patch_dist", "patch_gather", "econ_filter"}),
                ("preset", {}, {"patch_dist", "patch_gather"})):
            t0 = time.perf_counter()
            zero()
            d, b_, _ = vt.denoise(g_noisy, SIGMA, cfg=vt.default_config(
                SIGMA, **dict(ORACLE_G, **kw)), device=dev)
            n = launches_of(counters, f"denoise {name}", kerns)
            runs[name] = (b_.cpu().numpy(), d.cpu().numpy(), n,
                          time.perf_counter() - t0)
        t_wait = time.perf_counter()
        (o_deno, o_basic), g_s = g_job.result()
        wait_s = time.perf_counter() - t_wait
        oracle_s += g_s
        o_psnr = (compute_psnr(o_basic, g_clean), compute_psnr(o_deno,
                                                               g_clean))
        psnr = {}
        for name, (b_, d, n, card_s) in runs.items():
            psnr[name] = (compute_psnr(b_, g_clean), compute_psnr(d, g_clean))
            rel = (rel_mean(b_, o_basic), rel_mean(d, o_deno))
            gate = {"jacobi": "rel<2e-3,|dpsnr|<=0.01 vs oracle",
                    "poly": "|dpsnr|<=0.1 vs jacobi"}.get(name, "none")
            log("oracle_denoise", run=name, clip="3x48x48",
                psnr_basic=f"{psnr[name][0]:.5f}",
                psnr_deno=f"{psnr[name][1]:.5f}",
                oracle_basic=f"{o_psnr[0]:.5f}",
                oracle_deno=f"{o_psnr[1]:.5f}",
                dpsnr_basic=f"{psnr[name][0] - o_psnr[0]:+.5f}",
                dpsnr_deno=f"{psnr[name][1] - o_psnr[1]:+.5f}",
                mean_rel_basic=f"{rel[0]:.3g}", mean_rel_deno=f"{rel[1]:.3g}",
                gate=gate, k1_launches=n["patch_dist"],
                k4_launches=n["patch_gather"],
                k2_launches=n["econ_filter"], seconds=f"{card_s:.2f}")
            if name == "jacobi" and not (
                    max(rel) < 2e-3 and all(abs(p - o) <= 0.01 for p, o in
                                            zip(psnr[name], o_psnr))):
                raise AssertionError(f"oracle denoise jacobi: relative "
                                     f"{rel}, PSNR {psnr[name]} against "
                                     f"{o_psnr}")
        dpoly = [p - j for p, j in zip(psnr["poly"], psnr["jacobi"])]
        if not all(abs(x) <= 0.1 for x in dpoly):
            raise AssertionError(f"oracle denoise poly: {dpoly} dB from the "
                                 f"jacobi run")
    finally:
        pool.shutdown(wait=True)
    total = time.perf_counter() - t_phase
    log("oracle", seconds=f"{total:.2f}", oracle_seconds=f"{oracle_s:.2f}",
        oracle_denoise_seconds=f"{g_s:.2f}", waited_for_oracle_s=
        f"{wait_s:.2f}", poly_minus_jacobi_basic=f"{dpoly[0]:+.5f}",
        poly_minus_jacobi_deno=f"{dpoly[1]:+.5f}")


def k6_phase(yuv, shape, dev, cases):
    """K6 against its plain version on one 4096-site chunk of each
    ``(name, stage config)``: the dense search's top-K of the first 4096
    lattice sites gives the rows and weights, as the pass makes them, and
    a random filter output in its c-major layout the patches.  Bitwise
    (NaN bits included) and a repeat bitwise; the kernel's time beside its
    bound (the update rows
    read once, the distinct accumulator rows, counted here, read and
    written once, the sorted keys and permutation read once), the plain
    version's and ``index_add_``'s on the plain version's update rows (a
    yardstick: it adds duplicates in no fixed order, and the port never
    calls it).  Returns {name: (kernel ms, plain ms, (bound ms, by),
    index_add_ ms)}."""
    from vnlb_tpu_torch.ops.gather import inds_to_rows
    from vnlb_tpu_torch.ops.mask import lattice_sites
    from vnlb_tpu_torch.ops.scatter_rows import (scatter_rows,
                                                 scatter_rows_plain)
    from vnlb_tpu_torch.ops.search import search_levels
    from vnlb_tpu_torch.ops.search_dense import exec_search_dense
    from vnlb_tpu_torch.pipeline import agg_weights

    t_len, c, h, w = shape
    times = {}
    for name, scfg in cases:
        ka = (scfg.agg_k if scfg.agg_k and scfg.agg_k < scfg.npatches
              else scfg.npatches)
        lanes = scfg.pt * c * scfg.ps ** 2 + 1
        sites = torch.from_numpy(lattice_sites(shape, scfg)[:4096]).to(dev)
        vals, inds = exec_search_dense(yuv, sites, scfg,
                                       levels=search_levels(yuv, scfg))
        b, k = inds.shape
        rows = inds_to_rows(inds[:, :ka], shape, scfg.ps, scfg.pt)[:, :, 0]
        wts = agg_weights(vals, inds, shape, scfg, ka)
        gen = torch.Generator(device=dev).manual_seed(0)
        # the filter's c-major output: (B, C, K, pt, ps, ps) in memory
        pfilt = (torch.randn((b, c, k, scfg.pt, scfg.ps, scfg.ps),
                             device=dev, generator=gen) * 30 + 100) \
            .permute(0, 2, 3, 1, 4, 5)
        acc0 = torch.randn((t_len * (h - scfg.ps + 1) * (w - scfg.ps + 1),
                            lanes), device=dev, generator=gen)
        srt, perm = torch.sort(rows.to(torch.int32).reshape(-1), stable=True)
        args = (pfilt, wts, srt, perm, scfg.agg_bf16)
        want, got, again = acc0.clone(), acc0.clone(), acc0.clone()
        scatter_rows_plain(want, *args)
        scatter_rows(got, *args)
        scatter_rows(again, *args)
        torch.cuda.synchronize()
        if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
                and torch.equal(again.view(torch.int32),
                                got.view(torch.int32))):
            raise AssertionError(f"K6 {name}: not bitwise the plain version "
                                 f"or its repeat")
        n = srt.numel()
        distinct = torch.unique_consecutive(srt).numel()
        kms = cuda_ms(lambda: scatter_rows(acc0, *args), 20)
        pms = cuda_ms(lambda: scatter_rows_plain(acc0, *args), 3)
        vm = wts[:, :, None]
        upd = torch.cat([pfilt[:, :ka].reshape(b, ka, lanes - 1) * vm, vm],
                        dim=-1).reshape(n, lanes)
        flat = rows.reshape(-1).long()
        lms = cuda_ms(lambda: acc0.index_add_(0, flat, upd), 20)
        nbytes = n * (lanes - 1) * 4 + n * 4 + 2 * distinct * lanes * 4 \
            + n * (4 + 8)
        times[name] = (kms, pms, bound(0, 0, nbytes), lms)
        log("k6", case=name, B=b, ka=ka, lanes=lanes, updates=n,
            distinct_rows=distinct, mean_occurrences=f"{n / distinct:.4f}",
            bitwise=True, kernel_ms=f"{kms:.4f}", plain_ms=f"{pms:.3f}",
            index_add_ms=f"{lms:.4f}", mb=f"{nbytes / 1e6:.1f}",
            kernel_gb_s=f"{nbytes / 1e6 / kms:.1f}",
            bound_ms=f"{times[name][2][0]:.4f}", bound_by=times[name][2][1])
        del pfilt, acc0, want, got, again, upd
    return times


def windowed(vt, noisy, cfg, chunk, dev):
    """(deno, basic) of the windowed composition on ``dev``: each pass over
    ``streaming.windows``, as ``denoise_pipelined(devices=)`` runs it."""
    from vnlb_tpu_torch.streaming import (host_inputs, window_pass,
                                          window_stream)

    nz, ff, bf, zf = host_inputs(noisy, None)

    def window(scfg, basic_full, lo, hi):
        return window_pass(scfg, nz, basic_full, ff, bf, zf, lo, hi, dev)

    basic = window_stream(cfg.stage(0), nz, None, chunk, window)
    return window_stream(cfg.stage(1), nz, basic, chunk, window), basic


def cell_limits():
    """The check limits of the benchmark's long-clip cell."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "perfbench", "workloads",
                        "iphone-480p-t48-stream.json")
    with open(path) as f:
        return json.load(f)["limits"]


def gaps(deno, basic, d_ref, b_ref):
    """The cell check's numbers of one call against another (gray
    levels): mean |d| and root mean square of both passes."""
    out = {}
    for tag, got, want in (("basic", basic, b_ref), ("deno", deno, d_ref)):
        d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
        out[f"{tag}_mean_abs"] = float(np.abs(d).mean())
        out[f"{tag}_rms"] = float(np.sqrt((d * d).mean()))
    return out


def stream_phase(vt, dev, counters, launches):
    """The rolling stream: the API default on a 36x480x854 clip (3 steps a
    pass, a live window of 33 of its 36 frames) against the whole-clip
    ``denoise`` within the long-clip cell's limits, every site once and
    its peak flat from 36 to 72 frames; STREAM_CFG's 24-frame run (nwt 2,
    the all-rows search, chunk 4) against ``denoise``; and
    ``denoise_pipelined(devices=)`` bitwise the windowed composition it
    runs, with its launches."""
    from vnlb_tpu_torch.ops.dense_dist import dense_dist
    from vnlb_tpu_torch.parallel.pipe import denoise_pipelined
    from vnlb_tpu_torch.pipeline import plan_sites
    from vnlb_tpu_torch.streaming import live_slots, stream_pass
    from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    # ---- 8c. the API default's rolling stream ----
    a_clean = synthetic_video(36, H, W, seed=0)
    a_noisy = add_noise(a_clean, SIGMA, seed=1)
    api = vt.default_config(SIGMA)
    torch.cuda.empty_cache()
    dm, bm, mono_s = vt.denoise(a_noisy, SIGMA, device=dev)
    dm, bm = dm.cpu().numpy(), bm.cpu().numpy()
    torch.cuda.empty_cache()
    peaks, secs = [], []
    for t_len in (36, 72):
        noisy = a_noisy if t_len == 36 else add_noise(
            synthetic_video(t_len, H, W, seed=0), SIGMA, seed=1)
        for k in ("steps", "sites", "live_frames"):
            setattr(stream_pass, k, 0)
        torch.cuda.reset_peak_memory_stats(dev)
        ds, bs, sec = vt.denoise_streaming(noisy, SIGMA, device=dev)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        secs.append(sec)
        want_sites = sum(len(plan_sites(noisy.shape, api.stage(i), True)[0])
                         for i in (0, 1))
        if stream_pass.sites != want_sites or stream_pass.live_frames > max(
                live_slots(api.stage(i), t_len, 12) for i in (0, 1)):
            raise AssertionError(f"stream_api {t_len}: sites "
                                 f"{stream_pass.sites} of {want_sites}, "
                                 f"{stream_pass.live_frames} live frames")
        if t_len == 36:
            got, lim = gaps(ds, bs, dm, bm), cell_limits()
        del ds, bs
        torch.cuda.empty_cache()
    log("stream_api", frames="36,72", chunk=12, seconds=",".join(
        f"{x:.3f}" for x in secs), whole_seconds=f"{mono_s:.3f}",
        peak_mem_gib=",".join(f"{p / 2 ** 30:.3f}" for p in peaks),
        **{k: f"{v:.4g}" for k, v in got.items()},
        limits=",".join(f"{k}={v}" for k, v in lim.items()))
    over = [k for k, v in lim.items() if not got[k] <= v]
    if over or abs(peaks[1] - peaks[0]) > 0.05 * peaks[0]:
        raise AssertionError(f"stream_api: over the cell's limits {over} "
                             f"or peak not flat {peaks}")

    # ---- 8d. STREAM_CFG's run against the whole-clip denoise ----
    s_clean = synthetic_video(STREAM_T, H, W, seed=0)
    s_noisy = add_noise(s_clean, SIGMA, seed=1)
    s_cfg = vt.default_config(SIGMA, **STREAM_CFG)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    dm, bm, mono_s = vt.denoise(s_noisy, SIGMA, cfg=s_cfg, device=dev)
    mono_peak = torch.cuda.max_memory_allocated(dev)
    dm, bm = dm.cpu().numpy(), bm.cpu().numpy()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    ds, bs, str_s = vt.denoise_streaming(s_noisy, SIGMA, chunk=STREAM_CHUNK,
                                         cfg=s_cfg, device=dev)
    str_peak = torch.cuda.max_memory_allocated(dev)
    mad_b, mad_d = np.abs(bs - bm).mean(), np.abs(ds - dm).mean()
    dpsnr = abs(compute_psnr(ds, s_clean) - compute_psnr(dm, s_clean))
    log("streaming", frames=STREAM_T, chunk=STREAM_CHUNK,
        seconds=f"{str_s:.3f}", fps=f"{STREAM_T / str_s:.3f}",
        whole_seconds=f"{mono_s:.3f}",
        psnr_noisy=f"{compute_psnr(s_noisy, s_clean):.4f}",
        psnr_deno=f"{compute_psnr(ds, s_clean):.4f}",
        whole_psnr_deno=f"{compute_psnr(dm, s_clean):.4f}",
        mean_abs_diff_basic=f"{mad_b:.3g}", mean_abs_diff_deno=f"{mad_d:.3g}",
        peak_mem_gib=f"{str_peak / 2 ** 30:.3f}",
        whole_peak_mem_gib=f"{mono_peak / 2 ** 30:.3f}",
        k3_launches=dense_dist.launches)
    if not (mad_b < 1e-3 and mad_d < 1e-3 and dpsnr < 0.01
            and str_peak < mono_peak and dense_dist.launches > 0):
        raise AssertionError("streaming: differs from the whole-clip run or "
                             "needs more memory")

    # ---- 8e. denoise_pipelined(devices=) of the same clip, both passes on
    # this card: bitwise the windowed composition, with its launches ----
    for c in counters:
        c.launches = 0
    wd, wb = windowed(vt, s_noisy, s_cfg, STREAM_CHUNK, dev)
    win_launches = {c.__name__: c.launches for c in counters}
    for c in counters:
        c.launches = 0
    pd, pb, pipe_s = denoise_pipelined(s_noisy, SIGMA, chunk=STREAM_CHUNK,
                                       cfg=s_cfg, devices=(dev, dev))
    launches["pipe_devices"] = {c.__name__: c.launches for c in counters}
    if not (np.array_equal(pd, wd) and np.array_equal(pb, wb)):
        raise AssertionError("pipe_devices: not bitwise equal to the "
                             "windowed composition")
    if launches["pipe_devices"] != win_launches:
        raise AssertionError(f"pipe_devices: launches "
                             f"{launches['pipe_devices']}, windowed "
                             f"{win_launches}")
    log("pipe_devices", frames=STREAM_T, chunk=STREAM_CHUNK,
        devices=f"{dev},{dev}", seconds=f"{pipe_s:.3f}",
        streaming_seconds=f"{str_s:.3f}", bitwise_equal_windowed=True,
        **launches["pipe_devices"])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch import _build
    from vnlb_tpu_torch.ops import color
    from vnlb_tpu_torch.ops.dense_dist import (_box_ps, dense_dist,
                                               dense_dist_plain)
    from vnlb_tpu_torch.ops.dense_dist import card_plan as k3_card_plan
    from vnlb_tpu_torch.ops.dense_dist import plan as plan_k3
    from vnlb_tpu_torch.ops import poly_filter as k5
    from vnlb_tpu_torch.ops.econ_filter import blocks_per_sm as k2_blocks
    from vnlb_tpu_torch.ops.econ_filter import design as econ_design
    from vnlb_tpu_torch.ops.econ_filter import width as k2_width
    from vnlb_tpu_torch.ops.econ_filter import (econ_filter,
                                                econ_filter_kernel,
                                                econ_filter_plain,
                                                smem_bytes)
    from vnlb_tpu_torch.ops.econ_filter import tc_plan as econ_tc_plan
    from vnlb_tpu_torch.ops.mask import interior_split, lattice_sites
    from vnlb_tpu_torch.ops.patch_dist import (card_plan, patch_dist,
                                               patch_dist_plain,
                                               patch_dist_tile)
    from vnlb_tpu_torch.ops.patch_dist import plan as plan_k1
    from vnlb_tpu_torch.ops.patch_gather import (patch_gather,
                                                 patch_gather_plain)
    from vnlb_tpu_torch.ops.poly_filter import poly_filter, poly_filter_plain
    from vnlb_tpu_torch.ops.scatter_rows import scatter_rows
    from vnlb_tpu_torch.ops.search import exec_search, search_levels
    from vnlb_tpu_torch.ops.search_dense import (exec_search_dense,
                                                 level_queries)
    from vnlb_tpu_torch.testing.data import (add_noise, drift_flows,
                                             synthetic_video)
    from vnlb_tpu_torch.utils.flow_io import expand_flows
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # ---- 2. build ----
    path, build_s = _build.build(verbose=True)
    _build.library()
    log("build", seconds=f"{build_s:.2f}", library=path.name)

    cfg = vt.default_config(SIGMA, **BENCH)
    s0, s1 = cfg.stage(0), cfg.stage(1)
    api_cfg = vt.default_config(SIGMA)
    a0, a1 = api_cfg.stage(0), api_cfg.stage(1)
    clean = synthetic_video(T, H, W, seed=0)
    noisy = add_noise(clean, SIGMA, seed=1)
    noisy_t = torch.from_numpy(noisy).to(dev)
    yuv = color.rgb2yuv(noisy_t)
    shape = tuple(noisy.shape)
    drift = drift_flows(T, H, W)
    ff, bf = (torch.from_numpy(f).to(dev) for f in expand_flows(*drift))

    # ---- 3. K1 vs plain at main-path shapes (dense entry) ----
    k1_err = 0.0
    for name, scfg, lvl in (("s0.l0", s0, 0), ("s0.l1", s0, 1),
                            ("s0.l2", s0, 2), ("s1.l0", s1, 0)):
        levels = search_levels(yuv, scfg)
        v_l = levels[lvl]
        sites = torch.from_numpy(lattice_sites(shape, scfg)).to(dev).long()
        qt, qy, qx = level_queries(sites, lvl, v_l.shape[2], v_l.shape[3],
                                   scfg)
        args = (v_l, qt, qy, qx, -1, 3, scfg.pt, scfg.ps, scfg.w_s)
        got = patch_dist(*args)
        want = patch_dist_plain(*args)
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        k1_err = max(k1_err, (got - want).abs().max().item())
        if not rel < 1e-5:
            raise AssertionError(f"K1 {name}: max relative error {rel}")
        log("k1", shape=name, sites=sites.shape[0],
            level=f"{v_l.shape[2]}x{v_l.shape[3]}", dt_planes=3,
            max_rel_err=f"{rel:.3g}")
    for name, scfg in (("s0", s0), ("s1", s1)):
        sites = torch.from_numpy(lattice_sites(shape, scfg)[:4096]).to(dev)
        levels = search_levels(yuv, scfg)
        vk, ik = exec_search_dense(yuv, sites, scfg, levels=levels,
                                   dist_fn=patch_dist)
        vp, ip = exec_search_dense(yuv, sites, scfg, levels=levels,
                                   dist_fn=patch_dist_plain)
        # one bf16 ulp per pyramid level
        tol = 3 * 2.0 ** -7 * (vp.abs() + scfg.offset) + 1e-7
        agree = tie_aware(f"K1 top-K {name}", vk, ik, vp, ip, tol)
        log("k1_topk", stage=name, sites=sites.shape[0],
            index_agreement=f"{agree:.6f}", mismatches_are_ties=True)
    k1_shapes = {}
    for name, scfg, args, kw in k1_cases(vt, yuv, cfg, dev):
        got = patch_dist(*args, **kw)
        want = patch_dist_plain(*args, **kw)
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        k1_err = max(k1_err, (got - want).abs().max().item())
        if not rel < 1e-5:
            raise AssertionError(f"K1 {name}: max relative error {rel}")
        vid, n_dt = args[0], args[5]
        sites = torch.stack(args[1:4], 1)
        kms = cuda_ms(lambda: patch_dist(*args, **kw), 10)
        pms = cuda_ms(lambda: patch_dist_plain(*args, **kw), 1)
        bms, by = k1_work(sites, vid, scfg, starts=2 * bool(kw),
                          planes=n_dt)
        fp32_ms = k1_fp32_issue_ms(sites.shape[0] * n_dt, vid, scfg)
        k1_shapes[name] = (kms, pms, (bms, by), fp32_ms)
        load = {}
        if name == "s1.l0.bench_all":
            mhz, watts = clock_under(lambda: patch_dist(*args, **kw), 400)
            load = dict(sm_clock_mhz_under_load=f"{mhz:.0f}",
                        power_w_under_load=f"{watts:.0f}",
                        fp32_issue_ms_at_that_clock=f"{fp32_ms * 1980 / mhz:.4f}")
        k1_plan, per_sm = card_plan(scfg.ps, scfg.w_s, sites.shape[0], n_dt)
        if k1_plan != plan_k1(scfg.ps, scfg.w_s, sites.shape[0], n_dt) \
                or per_sm < k1_plan["blocks_per_sm"]:
            raise AssertionError(f"K1 {name}: the library's plan {k1_plan} "
                                 f"({per_sm} blocks per SM) is not the "
                                 f"wrapper's")
        log("k1_time", shape=name, sites=sites.shape[0],
            level=f"{vid.shape[2]}x{vid.shape[3]}", pt_c=scfg.pt * vid.shape[1],
            dt_planes=n_dt, window_starts=bool(kw), max_rel_err=f"{rel:.3g}",
            kernel_ms=f"{kms:.4f}", plain_ms=f"{pms:.3f}",
            bound_ms=f"{bms:.4f}", bound_by=by,
            over_bound=f"{kms / bms:.2f}", fp32_issue_ms=f"{fp32_ms:.4f}",
            blocks_per_sm=per_sm, sites_per_group=k1_plan["sites_per_group"],
            grid=f"{k1_plan['grid_x']}x{n_dt}", **load)
        del got, want
    # the cases' level videos stay out of the e2e peaks below
    del args, kw, vid, sites
    k1_ms, k1_plain_ms, k1_bound, _ = k1_shapes["s1.l0.bench_all"]

    # ---- 3b. K3 vs plain at the all-rows search's 480p shapes, dt=0
    # (every frame valid): stage 0 levels 0/1/2 (F=5, pt*C=1), stage 1
    # level 0 (F=4, pt*C=6); |d| <= 1e-5 (q2 + b2) + 1e-3 elementwise; the
    # launch plan against its mirror, a repeat launch bitwise ----
    k3_err, k3_times = 0.0, {}
    for name, scfg, lvl in (("s0.l0", a0, 0), ("s0.l1", a0, 1),
                            ("s0.l2", a0, 2), ("s1.l0", a1, 0)):
        v_l = search_levels(yuv, scfg)[lvl]
        ps, w_s, half = scfg.ps, scfg.w_s, (scfg.w_s - 1) // 2
        args = (v_l, 0, scfg.pt, ps, w_s)
        got = dense_dist(*args)
        want = dense_dist_plain(*args)
        torch.cuda.synchronize()
        plan_args = (ps, w_s, scfg.pt * v_l.shape[1], v_l.shape[2],
                     v_l.shape[3], got.shape[0])
        k3p, k3_per_sm = k3_card_plan(*plan_args)
        if k3p != plan_k3(*plan_args) or k3_per_sm < k3p["blocks_per_sm"]:
            raise AssertionError(f"K3 {name}: the library's plan {k3p} "
                                 f"({k3_per_sm} blocks per SM) is not the "
                                 f"mirror's {plan_k3(*plan_args)}")
        if not torch.equal(dense_dist(*args), got):
            raise AssertionError(f"K3 {name}: a repeat launch differs")
        v2 = (v_l * v_l).sum(1)
        v2p = sum(v2[p:p + T - scfg.pt + 1] for p in range(scfg.pt))
        q2 = _box_ps(v2p, ps)
        hp, wp = q2.shape[1:]
        b2 = torch.nn.functional.pad(q2, (half,) * 4)
        worst = 0.0
        for a in range(w_s):
            scale = q2[..., None] + torch.stack(
                [b2[:, a:a + hp, b:b + wp] for b in range(w_s)], dim=-1)
            err = (got[..., a * w_s:(a + 1) * w_s]
                   - want[..., a * w_s:(a + 1) * w_s]).abs()
            worst = max(worst, ((err - 1e-3) / scale).max().item())
            k3_err = max(k3_err, err.max().item())
        if not worst <= 1e-5:
            raise AssertionError(f"K3 {name}: error {worst} (q2 + b2)")
        kms = cuda_ms(lambda: dense_dist(*args), 5)
        pms = cuda_ms(lambda: dense_dist_plain(*args), 1)
        k3_times[name] = (kms, pms, k3_work(v_l, got.shape[0], scfg))
        extra = {}
        if name == "s0.l0":
            # the site take of the API default's interior sites, and what
            # an f32 running sum (JAX's cumsum box) loses at this size
            sites = torch.from_numpy(interior_split(
                lattice_sites(shape, scfg), shape, scfg)[0]).to(dev).long()
            rows = (sites[:, 0] * hp + sites[:, 1]) * wp + sites[:, 2]
            take_ms = cuda_ms(
                lambda: got.view(-1, w_s * w_s).index_select(0, rows), 10)
            c32 = torch.cumsum(v2p, -1)
            c32 = torch.cat([c32[..., ps - 1:ps], c32[..., ps:]
                             - c32[..., :-ps]], -1)
            c32 = torch.cumsum(c32, -2)
            c32 = torch.cat([c32[..., ps - 1:ps, :], c32[..., ps:, :]
                             - c32[..., :-ps, :]], -2)
            extra = dict(take_sites=rows.shape[0], take_ms=f"{take_ms:.4f}",
                         f32_cumsum_rel_loss=f"{((c32 - q2).abs() / q2).max().item():.3g}")
        bms, by = k3_times[name][2]
        log("k3", shape=name, out=tuple(got.shape),
            out_gb=f"{got.numel() * 4 / 1e9:.3f}", err_over_q2b2=f"{worst:.3g}",
            kernel_ms=f"{kms:.3f}", plain_ms=f"{pms:.3f}",
            bound_ms=f"{bms:.4f}", bound_by=by,
            over_bound=f"{kms / bms:.2f}", repeat="bitwise",
            tile=f"{k3p['tile_h']}x{k3p['tile_w']}",
            smem_bytes=k3p["smem_bytes"], blocks_per_sm=k3_per_sm,
            plan_blocks_per_sm=k3p["blocks_per_sm"],
            grid=f"{k3p['grid_x']}x{k3p['grid_y']}x{k3p['grid_z']}", **extra)
        del got, want, scale, err

    # ---- 4. K1's window-start entry vs plain: the gather search of the
    # API default at 480p (every border site of both stages, and 4096
    # sites under the drift flow), every pyramid level ----
    for name, scfg, flows in (("s0.border", a0, None),
                              ("s1.border", a1, None),
                              ("s0.drift", a0, (ff, bf)),
                              ("s1.drift", a1, (ff, bf))):
        sites = lattice_sites(shape, scfg)
        if flows is None:
            sites = interior_split(sites, shape, scfg)[1]
            flows = (torch.zeros_like(ff),) * 2
        else:
            sites = sites[:4096]
        sites = torch.from_numpy(sites).to(dev)
        levels = search_levels(yuv, scfg)
        rels = []

        def both(*a, **kw):
            got, want = patch_dist(*a, **kw), patch_dist_plain(*a, **kw)
            rels.append(rel_err(got, want))
            return got

        vk, ik = exec_search(yuv, sites, *flows, scfg, levels=levels,
                             dist_fn=both)
        vp, ip = exec_search(yuv, sites, *flows, scfg, levels=levels,
                             dist_fn=patch_dist_plain)
        rel = max(rels)
        if not rel < 1e-5:
            raise AssertionError(f"K1 window starts {name}: max relative "
                                 f"error {rel}")
        # f32 sums of the same squares in another order, per level
        tol = len(levels) * 1e-5 * (vp.abs() + scfg.offset) + 1e-7
        agree = tie_aware(f"K1 window starts {name}", vk, ik, vp, ip, tol)
        log("k1_windows", search=name, sites=sites.shape[0],
            levels=len(levels), max_rel_err=f"{rel:.3g}",
            index_agreement=f"{agree:.6f}", mismatches_are_ties=True)

    # ---- 5. K4 vs plain at main-path shapes: one 4096-site chunk of the
    # API default's top-K, stage 0 (K=100, pt=1, one video) and stage 1
    # (K=60, pt=2, noisy + basic) ----
    k4_times, k4_err = {}, 0.0
    for name, scfg in (("s0", a0), ("s1", a1)):
        sites = torch.from_numpy(lattice_sites(shape, scfg)[:4096]).to(dev)
        _, inds = exec_search_dense(yuv, sites, scfg,
                                    levels=search_levels(yuv, scfg))
        inds[::97, -1] = -1
        videos = [yuv] if scfg.step == 0 else [yuv, yuv.flip(0).contiguous()]
        got = patch_gather(videos, inds, scfg.ps, scfg.pt, scfg.cols_bf16)
        want = patch_gather_plain(videos, inds, scfg.ps, scfg.pt,
                                  scfg.cols_bf16)
        torch.cuda.synchronize()
        k4_err = max([k4_err] + [(g - w_).abs().max().item()
                                 for g, w_ in zip(got, want)])
        if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
            raise AssertionError(f"K4 {name}: not bitwise equal to plain")
        kms = cuda_ms(lambda: patch_gather(videos, inds, scfg.ps, scfg.pt,
                                           scfg.cols_bf16), 10)
        pms = cuda_ms(lambda: patch_gather_plain(videos, inds, scfg.ps,
                                                 scfg.pt, scfg.cols_bf16), 3)
        # a copy: the videos and the indices read once, the rows written
        k4_times[name] = (kms, pms, bound(
            0, 0, sum(g.numel() for g in got) * 4
            + sum(v.numel() for v in videos) * 4 + inds.numel() * 4))
        mb = sum(g.numel() for g in got) * 4 / 1e6
        log("k4", stage=name, B=inds.shape[0], K=inds.shape[1],
            videos=len(videos), out_mb=f"{mb:.1f}", bitwise=True,
            kernel_ms=f"{kms:.3f}", plain_ms=f"{pms:.3f}",
            kernel_gb_s=f"{mb / kms:.1f}",
            bound_ms=f"{k4_times[name][2][0]:.4f}",
            bound_by=k4_times[name][2][1])
        del got, want

    # ---- 5b. K6 vs plain on one 4096-site chunk of each pass of the
    # API default (L = 148, 295) and of preset default's first pass ----
    k6_times = k6_phase(yuv, shape, dev, (
        ("iphone s0", a0), ("iphone s1", a1),
        ("default s0", vt.default_config(SIGMA, preset="default").stage(0))))

    # ---- 6. K2 vs plain, both routes, at G=768 and at the main path's
    # chunk of 4096 sites x 3 channels (iphone shapes: the tensor-core
    # design, timed beside the shared-memory design on the same inputs),
    # the pt=2 first pass, the chunk without poly_bf16 (split TF32), and
    # couple_channels' joint groups at the chunk's 4096 sites (one group a
    # site: the streamed Gram route) ----
    def filter_check(tag, fn, plain, work, scfg, g, k, p, tol, reps,
                     beside=None, tags=None):
        base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
        xc = torch.from_numpy(base + rng.normal(size=(g, k, p))
                              .astype(np.float32) * 20).to(dev)
        xn = torch.from_numpy(base + rng.normal(size=(g, k, p))
                              .astype(np.float32) * 20).to(dev)
        got = fn(xc, xn, scfg)
        again = fn(xc, xn, scfg)
        want = plain(xc, xn, scfg)
        torch.cuda.synchronize()
        scale = want.abs().mean().item()
        rms = ((got - want) ** 2).mean().sqrt().item() / scale
        err = (got - want).abs().max().item()
        if not (rms < tol and torch.isfinite(got).all()):
            raise AssertionError(f"{tag} G={g} ({k}, {p}): rms/scale {rms}")
        if not torch.equal(got, again):
            raise AssertionError(f"{tag} G={g} ({k}, {p}): a repeat run is "
                                 f"not bitwise equal")
        kms = cuda_ms(lambda: fn(xc, xn, scfg), reps)
        pms = cuda_ms(lambda: plain(xc, xn, scfg), reps)
        bms, by = bound(*work(g, k, p, scfg))
        extra = {f"{key}_ms": cuda_ms(lambda: f(xc, xn, scfg), reps)
                 for key, f in (beside or {}).items()}
        if extra:
            # the design against the plain version and the designs beside
            extra["faster_than_plain_and_beside"] = kms < min(
                [pms, *extra.values()])
        log(tag, G=g, K=k, p=p, rms_over_scale=f"{rms:.3g}",
            kernel_ms=f"{kms:.3f}", plain_ms=f"{pms:.3f}",
            bound_ms=f"{bms:.4f}", bound_by=by, **(tags or {}),
            **{key: f"{v:.3f}" if isinstance(v, float) else v
               for key, v in extra.items()})
        return err, (kms, pms, (bms, by))

    k2_err = 0.0
    k2_times, k2_errs = {}, {}
    rng = np.random.default_rng(0)
    dflt0 = vt.default_config(SIGMA, preset="default").stage(0)
    k2_cases = [(g, name, scfg, scfg.npatches, scfg.pdim)
                for g in (768, 3 * 4096)
                for name, scfg in (("matrix(s0)", s0), ("gram(s1)", s1))]
    k2_cases += [(768, "matrix(default s0)", dflt0, 100, 98),
                 (3 * 4096, "matrix(default s0)", dflt0, 100, 98),
                 (4096, "gram(couple s0)", s0, 100, 147),
                 (4096, "gram(couple s1)", s1, 60, 294),
                 (4096, "gram(couple default s0)", dflt0, 100, 294),
                 (4096, "gram(couple s0) f32", s0.replace(poly_bf16=False),
                  100, 147),
                 (4096, "gram(couple s1) f32", s1.replace(poly_bf16=False),
                  60, 294),
                 (3 * 4096, "matrix(s0) f32", s0.replace(poly_bf16=False),
                  100, 49),
                 (3 * 4096, "gram(s1) f32", s1.replace(poly_bf16=False),
                  60, 98),
                 (3 * 4096, "matrix(default s0) f32",
                  dflt0.replace(poly_bf16=False), 100, 98)]
    def tc_tags(tag, kind, plan, mirror, blocks, width, bf16):
        """A tensor-core design's plan on the card against its Python
        mirror and its stated blocks per SM."""
        smem, per_sm = plan
        if per_sm < blocks or smem != mirror:
            raise AssertionError(f"{tag}: {per_sm} blocks per SM and {smem}"
                                 f" bytes; the wrapper's plan: {blocks} and "
                                 f"{mirror}")
        return dict(design=kind, operands="bf16" if bf16 else "split_tf32",
                    width=width, smem_bytes=smem, blocks_per_sm=per_sm,
                    blocks_stated=blocks)

    for g, name, scfg, k, p in k2_cases:
        # the design the shape takes; beside a tensor-core design, the
        # shared-memory design on the same inputs
        bf16 = scfg.poly_bf16
        kind = econ_design(k, p, bf16)
        tags, beside = dict(design=kind), None
        if kind != "smem":
            tags = tc_tags(f"k2 {name}", kind,
                           econ_tc_plan(k, p, kind, bf16),
                           smem_bytes(kind, k, p, bf16),
                           k2_blocks(kind, k, p, bf16),
                           k2_width(kind, k, p, bf16), bf16)
            beside = {"smem_design": lambda a, b, c: econ_filter_kernel(
                a, b, c, smem_design=True)}
        err, k2_times[name, g] = filter_check(
            f"k2 {name}", econ_filter, econ_filter_plain, econ_work, scfg,
            g, k, p, 5e-3, 5, beside=beside, tags=tags)
        k2_err = max(k2_err, err)
        k2_errs[name] = max(k2_errs.get(name, 0.0), err)

    # ---- 6b. K5 vs plain: right route (stage 0, K=100 >= p=49) and left
    # route (stage 1, K=60 < p=98), at G=768 and at one chunk, on the
    # tensor-core design (the shared-memory design timed beside on the same
    # inputs), then the chunk without poly_bf16 (split TF32), then
    # couple_channels' joint groups at the chunk's 4096 sites on the
    # batched design, bf16 and split TF32 (the shared-memory design beside)
    # ----
    k5_err = 0.0
    k5_times, k5_errs = {}, {}
    k5_cases = [(g, name, scfg, scfg.npatches, scfg.pdim)
                for g in (768, 3 * 4096)
                for name, scfg in (("right(s0)", a0), ("left(s1)", a1))]
    k5_cases += [(3 * 4096, "right(s0) f32", a0.replace(poly_bf16=False),
                  100, 49),
                 (3 * 4096, "left(s1) f32", a1.replace(poly_bf16=False),
                  60, 98),
                 (4096, "left(couple s0)", a0, 100, 147),
                 (4096, "left(couple s1)", a1, 60, 294),
                 (4096, "left(couple s0) f32", a0.replace(poly_bf16=False),
                  100, 147),
                 (4096, "left(couple s1) f32", a1.replace(poly_bf16=False),
                  60, 294),
                 # preset default's first pass (pt=2): the right route at
                 # p = 98, bf16 and split TF32 (Q in the gate's fifth
                 # buffer), at its 4096-site chunk
                 (3 * 4096, "right(default s0)", dflt0, 100, 98),
                 (3 * 4096, "right(default s0) f32",
                  dflt0.replace(poly_bf16=False), 100, 98)]
    for g, name, scfg, k, p in k5_cases:
        bf16 = scfg.poly_bf16
        kind = k5.design(k, p, bf16)
        tags, beside = dict(design=kind), None
        if kind == "tc":
            tags = tc_tags(f"k5 {name}", kind, k5.tc_plan(k, p, bf16),
                           k5.tc_smem_bytes(k, p, bf16),
                           k5.BLOCKS_PER_SM[k5.tc_width(p)],
                           k5.tc_width(p), bf16)
        elif kind == "tcb":
            plan = k5.card_tcb_plan(g, k, p, bf16)
            if plan != k5.tcb_plan(g, k, p, bf16):
                raise AssertionError(f"k5 {name}: the library's plan {plan}"
                                     f" is not the wrapper's "
                                     f"{k5.tcb_plan(g, k, p, bf16)}")
            tags = dict(design=kind,
                        operands="bf16" if bf16 else "split_tf32",
                        p_pad=plan["p_pad"], k_pad=plan["k_pad"],
                        tiles=plan["tiles"], ztiles=plan["ztiles"],
                        sub_batch=plan["batch"],
                        ws_mib=f"{plan['ws_bytes'] / 2 ** 20:.1f}")
        if kind != "smem":
            beside = {"smem_design": lambda a, b, c: k5.poly_filter_kernel(
                a, b, c, smem_design=True)}
        err, k5_times[name, g] = filter_check(
            f"k5 {name}", poly_filter, poly_filter_plain, poly_work, scfg,
            g, k, p, 2e-2 if scfg.poly_bf16 else 1e-4,
            5 if g == 768 else 2, beside=beside, tags=tags)
        k5_err = max(k5_err, err)
        k5_errs[name] = max(k5_errs.get(name, 0.0), err)
    tcb_stale_ws_phase(dev, a0, a1)

    # ---- 7. small-clip parity with the JAX package (CPU numbers) ----
    small_clean = synthetic_video(5, 96, 112, seed=0)
    small_noisy = add_noise(small_clean, SIGMA, seed=1)
    runs = [("small_clip", REF_SMALL, cfg, None)] + [
        (f"small_clip_api_{fl}", REF_SMALL_API[fl], None,
         drift_flows(5, 96, 112) if fl == "drift" else None)
        for fl in ("zero", "drift")] + [
        (f"small_clip_{name}", ref, vt.default_config(SIGMA, **kw), None)
        for name, (kw, ref) in REF_SMALL_MODES.items()]
    for name, ref, rcfg, flows in runs:
        d, b, sec = vt.denoise(small_noisy, SIGMA, flows=flows, cfg=rcfg,
                               device=dev)
        pb = compute_psnr(b.cpu().numpy(), small_clean)
        pd = compute_psnr(d.cpu().numpy(), small_clean)
        if not (abs(pb - ref["basic"]) < 0.02
                and abs(pd - ref["deno"]) < 0.02):
            raise AssertionError(f"{name} PSNR {pb}/{pd} vs JAX {ref}")
        log(name, basic_psnr=f"{pb:.4f}", deno_psnr=f"{pd:.4f}",
            jax_cpu=f"{ref['basic']}/{ref['deno']}", seconds=f"{sec:.2f}")
    d, b, sec = vt.denoise_mod(small_noisy, SIGMA, device=dev)
    pb = compute_psnr(b.cpu().numpy(), small_clean)
    pd = compute_psnr(d.cpu().numpy(), small_clean)
    if not (abs(pb - REF_SMALL_MOD["basic"]) < 0.02
            and abs(pd - REF_SMALL_MOD["deno"]) < 0.02):
        raise AssertionError(f"denoise_mod PSNR {pb}/{pd} vs JAX "
                             f"{REF_SMALL_MOD}")
    log("small_clip_denoise_mod", basic_psnr=f"{pb:.4f}",
        deno_psnr=f"{pd:.4f}",
        jax_cpu=f"{REF_SMALL_MOD['basic']}/{REF_SMALL_MOD['deno']}",
        seconds=f"{sec:.2f}")
    # the witness of e2e_default_couple's gain floor: the band of the 480p
    # clip that vnlb_tpu denoised on the CPU
    ref = REF_BAND_DEFAULT_COUPLE
    rows = slice(*ref["rows"])
    band_clean = np.ascontiguousarray(clean[..., rows, :])
    d, b, sec = vt.denoise(np.ascontiguousarray(noisy[..., rows, :]), SIGMA,
                           cfg=vt.default_config(SIGMA, preset="default",
                                                 couple_channels=True),
                           device=dev)
    pb = compute_psnr(b.cpu().numpy(), band_clean)
    pd = compute_psnr(d.cpu().numpy(), band_clean)
    if not (abs(pb - ref["basic"]) < 0.02 and abs(pd - ref["deno"]) < 0.02):
        raise AssertionError(f"band_default_couple PSNR {pb}/{pd} vs JAX "
                             f"{ref}")
    log("band_default_couple", rows=f"{rows.start}:{rows.stop}",
        basic_psnr=f"{pb:.4f}", deno_psnr=f"{pd:.4f}",
        jax_cpu=f"{ref['basic']}/{ref['deno']}",
        gain_db=f"{pd - ref['noisy']:.4f}", seconds=f"{sec:.2f}")
    del d, b

    # ---- 8. end to end at 5x480x854: each main path with the launch
    # counts set to 0 just before it and read just after ----
    counters = (patch_dist, econ_filter, patch_gather, poly_filter,
                dense_dist, scatter_rows)
    k124 = {"patch_dist", "econ_filter", "patch_gather", "scatter_rows"}
    k145 = {"patch_dist", "patch_gather", "poly_filter", "scatter_rows"}
    runs = (("e2e", k124, cfg, None), ("e2e_api_zero", k124, None, None),
            ("e2e_api_drift", k124, None, drift),
            ("e2e_poly_pallas", k145,
             vt.default_config(SIGMA, poly_impl="pallas"), None),
            ("e2e_preset_default", k124,
             vt.default_config(SIGMA, preset="default"), None),
            # the paths of K2's and K5's redesigned shared-memory shapes:
            # couple_channels (the streamed Gram route), poly_bf16 off
            # (split TF32: the wide design and the streamed Gram route),
            # poly_econ off without bf16 (K5 in split TF32 in the first
            # pass; the second pass's K < p groups take the fused series)
            ("e2e_api_couple", k124,
             vt.default_config(SIGMA, couple_channels=True), None),
            ("e2e_api_f32", k124, vt.default_config(SIGMA, poly_bf16=False),
             None),
            ("e2e_poly_econ_off_f32", k145,
             vt.default_config(SIGMA, poly_econ=False, poly_bf16=False),
             None),
            # K5 on couple_channels' joint groups: the batched design in
            # both passes
            ("e2e_poly_pallas_couple", k145,
             vt.default_config(SIGMA, poly_impl="pallas",
                               couple_channels=True), None),
            # the filter paths first run end to end here: K5 "tc" in split
            # TF32 in both passes, K2 "tcg" in split TF32, K5 "tcb" in
            # split TF32, K2 "tcg" on preset default's (100, 294) groups
            ("e2e_poly_pallas_f32", k145,
             vt.default_config(SIGMA, poly_impl="pallas", poly_bf16=False),
             None),
            ("e2e_api_couple_f32", k124,
             vt.default_config(SIGMA, couple_channels=True, poly_bf16=False),
             None),
            ("e2e_poly_pallas_couple_f32", k145,
             vt.default_config(SIGMA, poly_impl="pallas",
                               couple_channels=True, poly_bf16=False), None),
            ("e2e_default_couple", k124,
             vt.default_config(SIGMA, preset="default",
                               couple_channels=True), None),
            # preset default's first pass (pt=2, (100, 98) groups) through
            # K5 "tc" in bf16 and in split TF32, through K2 in split TF32
            # ("tcw"; "tcg" in the second pass), and through K5 "tc" in
            # split TF32 with poly_econ off (the second pass's K < p groups
            # take the fused series)
            ("e2e_default_pallas", k145,
             vt.default_config(SIGMA, preset="default", poly_impl="pallas"),
             None),
            ("e2e_default_pallas_f32", k145,
             vt.default_config(SIGMA, preset="default", poly_impl="pallas",
                               poly_bf16=False), None),
            ("e2e_default_f32", k124,
             vt.default_config(SIGMA, preset="default", poly_bf16=False),
             None),
            ("e2e_default_econ_off_f32", k145,
             vt.default_config(SIGMA, preset="default", poly_econ=False,
                               poly_bf16=False), None))
    launches, k1_runs = {}, {}
    for name, want, rcfg, fl in runs:
        # only the counts and the K1 times: a run's outputs stay out of the
        # next run's peak
        out = e2e(vt, name, noisy, clean, dev, counters, want, cfg=rcfg,
                  flows=fl, min_gain_db=E2E_GAIN_DB.get(name, 6.0))
        launches[name], k1_runs[name] = out[0], out[3]
        if name == "e2e_api_zero":
            api_psnr = (compute_psnr(out[2].cpu().numpy(), clean),
                        compute_psnr(out[1].cpu().numpy(), clean))
        del out
    # the redesigned filter kernels ran on the paths that take them: K5's
    # tensor-core design under poly_impl="pallas" and in split TF32, K2's
    # wide design on preset default's first pass and in split TF32, its
    # streamed Gram route under couple_channels and in split TF32
    for name, kern in (("e2e_poly_pallas", "poly_filter.tc"),
                       ("e2e_preset_default", "econ_filter.tcw"),
                       ("e2e_api_couple", "econ_filter.tcg"),
                       ("e2e_api_f32", "econ_filter.tcw"),
                       ("e2e_api_f32", "econ_filter.tcg"),
                       ("e2e_poly_econ_off_f32", "poly_filter.tc"),
                       ("e2e_poly_pallas_couple", "poly_filter.tcb"),
                       ("e2e_poly_pallas_f32", "poly_filter.tc"),
                       ("e2e_api_couple_f32", "econ_filter.tcg"),
                       ("e2e_poly_pallas_couple_f32", "poly_filter.tcb"),
                       ("e2e_default_couple", "econ_filter.tcg"),
                       ("e2e_default_pallas", "poly_filter.tc"),
                       ("e2e_default_pallas_f32", "poly_filter.tc"),
                       ("e2e_default_f32", "econ_filter.tcw"),
                       ("e2e_default_f32", "econ_filter.tcg"),
                       ("e2e_default_econ_off_f32", "poly_filter.tc")):
        if not launches[name][kern] > 0:
            raise AssertionError(f"{name}: no launch of {kern}: "
                                 f"{launches[name]}")
    # no 480p path reaches K5's shared-memory design
    for name, _, _, _ in runs:
        if launches[name]["poly_filter.smem"]:
            raise AssertionError(f"{name}: K5 launches on the shared-memory "
                                 f"design: {launches[name]}")
    # every K5 launch of the couple_channels paths on the batched design
    for name in ("e2e_poly_pallas_couple", "e2e_poly_pallas_couple_f32"):
        couple = launches[name]
        if couple["poly_filter.tcb"] != couple["poly_filter"]:
            raise AssertionError(f"{name}: {couple}: a K5 launch off the "
                                 f"batched design")
    main_path = launches["e2e_api_zero"]
    k1_api_phase(k1_runs["e2e_api_zero"], k1_shapes, api_cfg)

    # ---- 8b. the all-rows search: K3 for the interior sites (K1 for the
    # border sites), exact and streaming top-K ----
    full_cfg = vt.default_config(SIGMA, **DENSE_FULL)
    k1234 = k124 | {"dense_dist"}
    launches["e2e_dense_full"], d_full, b_full, _ = e2e(
        vt, "e2e_dense_full", noisy, clean, dev, counters, k1234,
        cfg=full_cfg)
    want_k3 = k3_launches(yuv, full_cfg)
    if launches["e2e_dense_full"]["dense_dist"] != want_k3:
        raise AssertionError(f"e2e_dense_full: {launches['e2e_dense_full']}"
                             f" K3 launches, predicted {want_k3}")
    launches["e2e_dense_full_stream"], d_str, b_str, _ = e2e(
        vt, "e2e_dense_full_stream", noisy, clean, dev, counters, k1234,
        cfg=vt.default_config(SIGMA, topk="stream", **DENSE_FULL))
    if not (torch.equal(d_str, d_full) and torch.equal(b_str, b_full)):
        raise AssertionError("e2e_dense_full_stream: not bitwise equal to "
                             "the exact top-K")
    log("dense_full_checks", k3_launches=want_k3, predicted=want_k3,
        stream_bitwise_equal_exact=True)
    del d_full, b_full, d_str, b_str

    # ---- 8c-8e. the rolling stream, denoise_pipelined(devices=) ----
    stream_phase(vt, dev, counters, launches)

    # ---- 9. the halo-sharded pass: K1's tile entry, the one-card strip
    # runner over 4 strips, a 2-rank gloo world on this card ----
    k1t_err, (k1t_ms, k1t_pms, (k1t_bms, k1t_by)) = k1_tile_phase(yuv, shape,
                                                                  dev)
    tile_full_phase(yuv, shape, dev)
    torch.cuda.empty_cache()
    halo_cfg = vt.default_config(SIGMA, **HALO_CFG)
    vt.denoise(noisy, SIGMA, cfg=halo_cfg, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    *mono, mono_s = vt.denoise(noisy, SIGMA, cfg=halo_cfg, device=dev)
    log("halo_one_card", config="API default, mask borders",
        seconds=f"{mono_s:.4f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f}")
    counters6 = counters + (patch_dist_tile,)
    launches["halo_strips"] = halo_strips_phase(vt, noisy, clean, dev,
                                                counters6, mono)
    torch.cuda.empty_cache()
    mesh_stream, one_s = halo_world_phase(vt, noisy, clean, dev, drift,
                                          mono)
    torch.cuda.empty_cache()
    pipe_world_phase(vt, dev, mesh_stream, one_s)

    # ---- 10. estimated flow (TV-L1 and LK) on a clip that moves 4 px a
    # frame, and denoise with it; the reference-order pass; the
    # aggregation modes ----
    torch.cuda.empty_cache()
    m_clean = synthetic_video(T, H, W, seed=0, motion=FLOW_MOTION)
    m_noisy = add_noise(m_clean, SIGMA, seed=1)
    est = flow_est_phase(vt, m_noisy, dev)
    launches["e2e_flow_est"] = e2e_flow_phase(vt, m_noisy, m_clean, dev,
                                              counters, k124, est)
    del est
    torch.cuda.empty_cache()
    launches["e2e_compat"] = compat_phase(vt, noisy[:COMPAT_FRAMES],
                                          clean[:COMPAT_FRAMES], dev)
    launches.update(agg_modes_phase(vt, noisy, clean, dev, counters))

    # ---- 10b. the port's CLI on the main clip ----
    torch.cuda.empty_cache()
    cli_phase(launches["e2e_api_zero"], api_psnr)
    analysis_scripts_phase(launches["e2e_api_zero"], api_psnr)

    # ---- 10c. the card against the C++ oracle and npref ----
    torch.cuda.empty_cache()
    oracle_phase(vt, dev)

    # ---- 11. records ----
    kms, pms, (k2_bms, k2_by) = k2_times["gram(s1)", 3 * 4096]
    g_kms, g_pms, (k4_bms, k4_by) = k4_times["s1"]
    p_kms, p_pms, (k5_bms, k5_by) = k5_times["left(s1)", 3 * 4096]
    w_kms, w_pms, (k2w_bms, k2w_by) = k2_times["matrix(default s0)",
                                               3 * 4096]
    cg_kms, cg_pms, (cg_bms, cg_by) = k2_times["gram(couple s0)", 4096]
    f2_kms, f2_pms, (f2_bms, f2_by) = k2_times["gram(s1) f32", 3 * 4096]
    f5_kms, f5_pms, (f5_bms, f5_by) = k5_times["right(s0) f32", 3 * 4096]
    c5_kms, c5_pms, (c5_bms, c5_by) = k5_times["left(couple s1)", 4096]
    d5_kms, d5_pms, (d5_bms, d5_by) = k5_times["right(default s0) f32",
                                               3 * 4096]
    k3_kms, k3_pms, (k3_bms, k3_by) = k3_times["s0.l0"]
    k6_kms, k6_pms, (k6_bms, k6_by), k6_lms = k6_times["iphone s1"]
    print(json.dumps({"kernels": [
        {"name": "patch_dist", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/patch_dist.cu",
         "replaces": "vnlb_tpu/ops/pallas_smat.py:378",
         "launches": main_path["patch_dist"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "econ_filter", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/econ_filter.cu",
         "replaces": "vnlb_tpu/ops/pallas_filter.py:260",
         "launches": main_path["econ_filter"], "max_abs_err": k2_err,
         "ms": kms, "plain_ms": pms, "bound_ms": k2_bms, "bound_by": k2_by,
         "library_ms": None},
        {"name": "econ_filter_tcw", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/econ_filter.cu",
         "replaces": "vnlb_tpu/ops/pallas_filter.py:320",
         "launches": launches["e2e_preset_default"]["econ_filter.tcw"],
         "max_abs_err": k2_errs["matrix(default s0)"], "ms": w_kms,
         "plain_ms": w_pms,
         "bound_ms": k2w_bms, "bound_by": k2w_by, "library_ms": None},
        {"name": "patch_gather", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/patch_gather.cu",
         "replaces": "vnlb_tpu/ops/pallas_gather.py:176",
         "launches": main_path["patch_gather"], "max_abs_err": k4_err,
         "ms": g_kms, "plain_ms": g_pms, "bound_ms": k4_bms,
         "bound_by": k4_by, "library_ms": None},
        {"name": "poly_filter", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/poly_filter.cu",
         "replaces": "vnlb_tpu/ops/pallas_poly.py:153",
         "launches": launches["e2e_poly_pallas"]["poly_filter"],
         "max_abs_err": k5_err, "ms": p_kms, "plain_ms": p_pms,
         "bound_ms": k5_bms, "bound_by": k5_by, "library_ms": None},
        {"name": "dense_dist", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/dense_dist.cu",
         "replaces": "vnlb_tpu/ops/pallas_dense.py:141",
         "launches": launches["e2e_dense_full"]["dense_dist"],
         "max_abs_err": k3_err, "ms": k3_kms, "plain_ms": k3_pms,
         "bound_ms": k3_bms, "bound_by": k3_by, "library_ms": None},
        {"name": "econ_filter_tcg", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/econ_filter.cu",
         "replaces": "vnlb_tpu/ops/pallas_filter.py:260",
         "launches": launches["e2e_api_couple"]["econ_filter.tcg"],
         "max_abs_err": max(v for n, v in k2_errs.items() if "couple" in n),
         "ms": cg_kms, "plain_ms": cg_pms, "bound_ms": cg_bms,
         "bound_by": cg_by, "library_ms": None},
        {"name": "econ_filter_split_tf32", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/econ_filter.cu",
         "replaces": "vnlb_tpu/ops/pallas_filter.py:260",
         "launches": launches["e2e_api_f32"]["econ_filter"],
         "max_abs_err": max(v for n, v in k2_errs.items() if "f32" in n),
         "ms": f2_kms, "plain_ms": f2_pms, "bound_ms": f2_bms,
         "bound_by": f2_by, "library_ms": None},
        {"name": "poly_filter_split_tf32", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/poly_filter.cu",
         "replaces": "vnlb_tpu/ops/pallas_poly.py:153",
         "launches": launches["e2e_poly_econ_off_f32"]["poly_filter"],
         "max_abs_err": max(v for n, v in k5_errs.items() if "f32" in n),
         "ms": f5_kms, "plain_ms": f5_pms, "bound_ms": f5_bms,
         "bound_by": f5_by, "library_ms": None},
        {"name": "poly_filter_split_tf32_p98", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/poly_filter.cu",
         "replaces": "vnlb_tpu/ops/pallas_poly.py:153",
         "launches": launches["e2e_default_econ_off_f32"]["poly_filter"],
         "max_abs_err": k5_errs["right(default s0) f32"], "ms": d5_kms,
         "plain_ms": d5_pms, "bound_ms": d5_bms, "bound_by": d5_by,
         "library_ms": None},
        {"name": "poly_filter_couple", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/poly_tcb.cu",
         "replaces": "vnlb_tpu/ops/pallas_poly.py:153",
         "launches": launches["e2e_poly_pallas_couple"]["poly_filter"],
         "max_abs_err": max(v for n, v in k5_errs.items() if "couple" in n),
         "ms": c5_kms, "plain_ms": c5_pms, "bound_ms": c5_bms,
         "bound_by": c5_by, "library_ms": None},
        {"name": "patch_dist_tile", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/patch_dist.cu",
         "replaces": "vnlb_tpu/ops/pallas_smat.py:526",
         "launches": launches["halo_strips"]["patch_dist_tile"],
         "max_abs_err": k1t_err, "ms": k1t_ms, "plain_ms": k1t_pms,
         "bound_ms": k1t_bms, "bound_by": k1t_by, "library_ms": None},
        {"name": "scatter_rows", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/scatter_rows.cu", "replaces": None,
         "launches": main_path["scatter_rows"], "max_abs_err": 0.0,
         "ms": k6_kms, "plain_ms": k6_pms, "bound_ms": k6_bms,
         "bound_by": k6_by, "library_ms": k6_lms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
