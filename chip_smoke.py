#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the kernels from vnlb_tpu_torch/csrc, checks each kernel against its
plain PyTorch version at the shapes of the main path, then runs the
two-pass ``denoise`` on a 5x480x854 clip at sigma=20 with the bench config
(preset iphone, eig_method poly, step_s 6, border_mode mask, topk exact,
zero flow) and checks its output.  Every phase prints one line; any failure
raises and the script exits nonzero.  The second-to-last line is the kernel
table as JSON, the last line the device record.  Without a CUDA card, or
without the repository beside it, the script fails and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

T, H, W, SIGMA = 5, 480, 854, 20.0
BENCH = dict(preset="iphone", eig_method="poly", step_s=6,
             border_mode="mask", topk="exact")
# the JAX package on the CPU, (5, 96, 112) clip, seed 0, noise seed 1
REF_SMALL = dict(basic=30.025878, deno=30.125710)


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch import _build
    from vnlb_tpu_torch.ops import color
    from vnlb_tpu_torch.ops.econ_filter import econ_filter, econ_filter_plain
    from vnlb_tpu_torch.ops.mask import lattice_sites
    from vnlb_tpu_torch.ops.patch_dist import patch_dist, patch_dist_plain
    from vnlb_tpu_torch.ops.search_dense import (exec_search_dense,
                                                 level_queries, search_levels)
    from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
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
    clean = synthetic_video(T, H, W, seed=0)
    noisy = add_noise(clean, SIGMA, seed=1)
    noisy_t = torch.from_numpy(noisy).to(dev)
    yuv = color.rgb2yuv(noisy_t)
    shape = tuple(noisy.shape)

    # ---- 3. K1 vs plain at main-path shapes ----
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
        rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
        k1_err = max(k1_err, (got - want).abs().max().item())
        if not rel < 1e-5:
            raise AssertionError(f"K1 {name}: max relative error {rel}")
        log("k1", shape=name, sites=sites.shape[0],
            level=f"{v_l.shape[2]}x{v_l.shape[3]}", dt_planes=3,
            max_rel_err=f"{rel:.3g}")
    agree = {}
    for name, scfg in (("s0", s0), ("s1", s1)):
        sites = torch.from_numpy(lattice_sites(shape, scfg)[:4096]).to(dev)
        levels = search_levels(yuv, scfg)
        vk, ik = exec_search_dense(yuv, sites, scfg, levels=levels,
                                   dist_fn=patch_dist)
        vp, ip = exec_search_dense(yuv, sites, scfg, levels=levels,
                                   dist_fn=patch_dist_plain)
        fin = torch.isfinite(vp)
        if not torch.equal(fin, torch.isfinite(vk)):
            raise AssertionError(f"K1 top-K {name}: inf pattern differs")
        tol = 3 * 2.0 ** -7 * (vp.abs() + scfg.offset) + 1e-7
        err = torch.where(fin, (vk - vp).abs(), torch.zeros_like(vp))
        if (err > tol).any():
            raise AssertionError(f"K1 top-K {name}: values beyond one bf16 "
                                 f"ulp per level")
        agree[name] = (ik == ip).float().mean().item()
        log("k1_topk", stage=name, sites=sites.shape[0],
            index_agreement=f"{agree[name]:.6f}",
            mismatches_are_ties=True)
    v_l = search_levels(yuv, s1)[0]
    sites = torch.from_numpy(lattice_sites(shape, s1)).to(dev).long()
    args = (v_l, sites[:, 0], sites[:, 1], sites[:, 2], -3, 7, s1.pt, s1.ps,
            s1.w_s)
    k1_ms = cuda_ms(lambda: patch_dist(*args), 5)
    k1_plain_ms = cuda_ms(lambda: patch_dist_plain(*args), 1)
    log("k1_time", shape=f"s1.l0 sites={sites.shape[0]} dt_planes=7",
        kernel_ms=f"{k1_ms:.3f}", plain_ms=f"{k1_plain_ms:.3f}")

    # ---- 4. K2 vs plain, both routes, at G=768 and at the main path's
    # chunk of 4096 sites x 3 channels ----
    k2_err = 0.0
    k2_times = {}
    rng = np.random.default_rng(0)
    for g in (768, 3 * 4096):
        for name, scfg in (("matrix(s0)", s0), ("gram(s1)", s1)):
            k, p = scfg.npatches, scfg.pdim
            base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
            xc = torch.from_numpy(base + rng.normal(size=(g, k, p))
                                  .astype(np.float32) * 20).to(dev)
            xn = torch.from_numpy(base + rng.normal(size=(g, k, p))
                                  .astype(np.float32) * 20).to(dev)
            got = econ_filter(xc, xn, scfg)
            want = econ_filter_plain(xc, xn, scfg)
            torch.cuda.synchronize()
            scale = want.abs().mean().item()
            rms = ((got - want) ** 2).mean().sqrt().item() / scale
            k2_err = max(k2_err, (got - want).abs().max().item())
            if not (rms < 5e-3 and torch.isfinite(got).all()):
                raise AssertionError(f"K2 {name} G={g}: rms/scale {rms}")
            kms = cuda_ms(lambda: econ_filter(xc, xn, scfg), 5)
            pms = cuda_ms(lambda: econ_filter_plain(xc, xn, scfg), 5)
            k2_times[name, g] = (kms, pms)
            log("k2", route=name, G=g, K=k, p=p,
                rms_over_scale=f"{rms:.3g}", kernel_ms=f"{kms:.3f}",
                plain_ms=f"{pms:.3f}")
            del xc, xn, got, want

    # ---- 5. end to end ----
    small_clean = synthetic_video(5, 96, 112, seed=0)
    small_noisy = add_noise(small_clean, SIGMA, seed=1)
    d, b, _ = vt.denoise(small_noisy, SIGMA, cfg=cfg, device=dev)
    pb = compute_psnr(b.cpu().numpy(), small_clean)
    pd = compute_psnr(d.cpu().numpy(), small_clean)
    if not (abs(pb - REF_SMALL["basic"]) < 0.02
            and abs(pd - REF_SMALL["deno"]) < 0.02):
        raise AssertionError(f"small clip PSNR {pb}/{pd} vs JAX {REF_SMALL}")
    log("small_clip", basic_psnr=f"{pb:.4f}", deno_psnr=f"{pd:.4f}",
        jax_cpu=f"{REF_SMALL['basic']}/{REF_SMALL['deno']}")

    patch_dist.launches = 0
    econ_filter.launches = 0
    deno, basic, first_s = vt.denoise(noisy, SIGMA, cfg=cfg, device=dev)
    launches = {"patch_dist": patch_dist.launches,
                "econ_filter": econ_filter.launches}
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"main path skipped a kernel: {launches}")
    log("e2e_warmup", seconds=f"{first_s:.3f}", **launches)

    times = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats(dev)
        d2, b2, sec = vt.denoise(noisy_t, SIGMA, cfg=cfg, device=dev)
        times.append(sec)
        if not (torch.equal(d2, deno) and torch.equal(b2, basic)):
            raise AssertionError("repeat run is not bitwise equal")
    peak = torch.cuda.max_memory_allocated(dev)
    deno_np, basic_np = deno.cpu().numpy(), basic.cpu().numpy()
    if not (deno_np.shape == noisy.shape and np.isfinite(deno_np).all()
            and np.isfinite(basic_np).all()):
        raise AssertionError("output has the wrong shape or non-finite values")
    p_noisy = compute_psnr(noisy, clean)
    p_basic = compute_psnr(basic_np, clean)
    p_deno = compute_psnr(deno_np, clean)
    best = min(times)
    log("e2e", seconds=",".join(f"{t:.4f}" for t in times),
        fps=f"{T / best:.3f}", psnr_noisy=f"{p_noisy:.4f}",
        psnr_basic=f"{p_basic:.4f}", psnr_deno=f"{p_deno:.4f}",
        peak_mem_gib=f"{peak / 2 ** 30:.3f}", repeat_bitwise=True)
    if not p_deno >= p_noisy + 6.0:
        raise AssertionError(f"deno {p_deno} < noisy {p_noisy} + 6 dB")

    t0 = time.perf_counter()
    dp, bp, plain_s = vt.denoise(noisy_t, SIGMA, cfg=cfg, device=dev,
                                 kernels=vt.PLAIN)
    pp_basic = compute_psnr(bp.cpu().numpy(), clean)
    pp_deno = compute_psnr(dp.cpu().numpy(), clean)
    log("e2e_plain", seconds=f"{plain_s:.4f}", psnr_basic=f"{pp_basic:.4f}",
        psnr_deno=f"{pp_deno:.4f}",
        mean_abs_diff=f"{(dp - deno).abs().mean().item():.4g}",
        wall=f"{time.perf_counter() - t0:.2f}")
    if not (abs(pp_basic - p_basic) < 0.02 and abs(pp_deno - p_deno) < 0.02):
        raise AssertionError("kernel path and plain path differ by >= 0.02 dB")

    # ---- 6. records ----
    kms, pms = k2_times["gram(s1)", 3 * 4096]
    print(json.dumps({"kernels": [
        {"name": "patch_dist", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/patch_dist.cu",
         "replaces": "vnlb_tpu/ops/pallas_smat.py:378",
         "launches": launches["patch_dist"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "econ_filter", "route": "cuda",
         "source": "vnlb_tpu_torch/csrc/econ_filter.cu",
         "replaces": "vnlb_tpu/ops/pallas_filter.py:260",
         "launches": launches["econ_filter"], "max_abs_err": k2_err,
         "ms": kms, "plain_ms": pms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
