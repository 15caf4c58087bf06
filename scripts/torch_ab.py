#!/usr/bin/env python3
"""Time the port's earlier 480p paths from one copy of ``vnlb_tpu_torch``,
for parent/change comparisons on one CUDA card.

    python3 scripts/torch_ab.py <dir holding vnlb_tpu_torch> <tag> [runs]

Runs ``denoise`` on the 5x480x854 clip of chip_smoke.py (sigma 20) with the
bench config, the API default (zero flow), the API default with
``poly_impl="pallas"`` (K5 in both passes), preset ``default`` (K2 on
(100, 98) groups in the first pass) and the API default with
``dense_rows="full"`` (K3 planes for the interior sites): one warmup,
then ``runs`` (default 3; 0 skips the paths) timed runs each, and prints
one ``[ab]`` line per path with the walls, the best wall, the peak device
memory, the PSNR of ``basic`` and ``deno``, K1's, K2's and K3's device
time in one more run (CUDA events around each launch,
``chip_smoke.timed_run``) and a SHA-256 of ``deno`` and of ``basic``.
Then times K3 (``dense_dist``) on one dt = 0 plane at the all-rows
search's four 480p shapes (stage 0 levels 0, 1, 2 and stage 1 level 0,
with a SHA-256 of each plane), then K1 (``patch_dist``)
at the main path's launch shapes (a 4096-site chunk of the API default's
interior sites at stage 0 levels 0, 1, 2 and stage 1 level 0, the bench
config's 46,046 stage-1 sites, and the window-start entry on 4096 sites of
each stage: ``chip_smoke.k1_cases``), then K2
(``econ_filter``) on the main path's two group shapes (12,288 groups of
(100, 49) and of (60, 98)), on the same without poly_bf16, on the shapes
beyond the tensor-core design ((100, 98) of preset ``default``, the
``couple_channels`` shapes), and K5 (``poly_filter``) on both routes,
with CUDA events over several launches, one ``[ab]`` line each.  To compare two trees, unpack the
parent's ``vnlb_tpu_torch`` into a directory that .gitignore lists and run
parent, change, change, parent in one call, e.g.

    sh -c 'python3 scripts/torch_ab.py build/ab/parent parent &&
           python3 scripts/torch_ab.py . change &&
           python3 scripts/torch_ab.py . change &&
           python3 scripts/torch_ab.py build/ab/parent parent'
"""

import hashlib
import os
import sys

import numpy as np
import torch


def main():
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    runs = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    # chip_smoke's shapes and timed run from this repository, the package
    # under test from ``root``
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch import _build
    from vnlb_tpu_torch.testing.data import add_noise, synthetic_video

    if not vt.__file__.startswith(root):
        raise SystemExit(f"imported {vt.__file__}, not the copy in {root}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: no CUDA device")
    _build.library()
    dev = torch.device("cuda", 0)
    clean = synthetic_video(5, 480, 854, seed=0)
    noisy = torch.from_numpy(add_noise(clean, 20.0, seed=1)).to(dev)
    bench = vt.default_config(20.0, preset="iphone", eig_method="poly",
                              step_s=6, border_mode="mask", topk="exact")
    from chip_smoke import k1_cases, timed_run

    from vnlb_tpu_torch.utils.metrics import compute_psnr

    paths = (("bench", bench), ("api_zero", None),
             ("poly_pallas", vt.default_config(20.0, poly_impl="pallas")),
             ("preset_default", vt.default_config(20.0, preset="default")),
             ("dense_full", vt.default_config(20.0, dense_rows="full")))
    for name, cfg in paths:
        if not runs:
            break
        deno, basic, _ = vt.denoise(noisy, 20.0, cfg=cfg, device=dev)
        walls = []
        for _ in range(runs):
            torch.cuda.reset_peak_memory_stats(dev)
            walls.append(vt.denoise(noisy, 20.0, cfg=cfg, device=dev)[2])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        _, per = timed_run(vt, noisy, dev, cfg, None)
        dev_ms = {}
        for kern in ("patch_dist", "econ_filter", "dense_dist"):
            vals = [v for k, v in per.items() if k[0] == kern]
            dev_ms[kern] = (sum(v[0] for v in vals), sum(v[1] for v in vals))
        sha = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]
               for k, v in (("deno", deno), ("basic", basic))}
        psnr = {k: compute_psnr(v.cpu().numpy(), clean)
                for k, v in (("deno", deno), ("basic", basic))}
        print(f"[ab] tag={tag} path={name} seconds="
              f"{','.join(f'{t:.4f}' for t in walls)} best={min(walls):.4f} "
              f"peak_gib={peak:.3f} psnr_basic={psnr['basic']:.4f} "
              f"psnr_deno={psnr['deno']:.4f} "
              f"k1_device_ms={dev_ms['patch_dist'][0]:.2f} "
              f"k1_launches={dev_ms['patch_dist'][1]} "
              f"k2_device_ms={dev_ms['econ_filter'][0]:.2f} "
              f"k2_launches={dev_ms['econ_filter'][1]} "
              f"k3_device_ms={dev_ms['dense_dist'][0]:.2f} "
              f"k3_launches={dev_ms['dense_dist'][1]} "
              f"sha_deno={sha['deno']} sha_basic={sha['basic']}", flush=True)
        del deno, basic
    from vnlb_tpu_torch.ops import color
    from vnlb_tpu_torch.ops.dense_dist import dense_dist
    from vnlb_tpu_torch.ops.patch_dist import patch_dist
    from vnlb_tpu_torch.ops.search import search_levels

    yuv = color.rgb2yuv(noisy)
    api = vt.default_config(20.0)
    for name, scfg, lvl in (("s0.l0", api.stage(0), 0),
                            ("s0.l1", api.stage(0), 1),
                            ("s0.l2", api.stage(0), 2),
                            ("s1.l0", api.stage(1), 0)):
        v_l = search_levels(yuv, scfg)[lvl]
        args = (v_l, 0, scfg.pt, scfg.ps, scfg.w_s)
        sha = hashlib.sha256(dense_dist(*args).cpu().numpy().tobytes())
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            dense_dist(*args)
        stop.record()
        torch.cuda.synchronize()
        print(f"[ab] tag={tag} path=k3_{name} level={tuple(v_l.shape)} "
              f"ms={start.elapsed_time(stop) / 5:.4f} "
              f"sha={sha.hexdigest()[:16]}", flush=True)
        del v_l
    for name, _, args, kw in k1_cases(vt, yuv, bench, dev):
        patch_dist(*args, **kw)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            patch_dist(*args, **kw)
        stop.record()
        torch.cuda.synchronize()
        print(f"[ab] tag={tag} path=k1_{name} sites={args[1].shape[0]} "
              f"planes={args[5]} ms={start.elapsed_time(stop) / 10:.4f}",
              flush=True)
    from vnlb_tpu_torch.ops.econ_filter import econ_filter
    from vnlb_tpu_torch.ops.poly_filter import poly_filter

    rng = np.random.default_rng(0)
    dflt0 = vt.default_config(20.0, preset="default").stage(0)
    f32 = dict(poly_bf16=False)
    # (name, kernel, groups, K, p, stage config, launches timed)
    cases = [("k2_100x49", econ_filter, 12288, 100, 49, api.stage(0), 20),
             ("k2_60x98", econ_filter, 12288, 60, 98, api.stage(1), 20),
             ("k2_100x49_f32", econ_filter, 12288, 100, 49,
              api.stage(0).replace(**f32), 10),
             ("k2_60x98_f32", econ_filter, 12288, 60, 98,
              api.stage(1).replace(**f32), 10),
             ("k2_100x98", econ_filter, 12288, 100, 98, dflt0, 5),
             ("k2_100x147", econ_filter, 768, 100, 147, api.stage(0), 10),
             ("k2_60x294", econ_filter, 768, 60, 294, api.stage(1), 10),
             ("k2_100x294", econ_filter, 768, 100, 294, dflt0, 10),
             ("k5_100x49", poly_filter, 12288, 100, 49, api.stage(0), 5),
             ("k5_60x98", poly_filter, 12288, 60, 98, api.stage(1), 3)]
    for name, fn, g, k, p, cfg, reps in cases:
        base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
        xc, xn = (torch.from_numpy(base + rng.normal(size=(g, k, p))
                                   .astype(np.float32) * 20).to(dev)
                  for _ in range(2))
        fn(xc, xn, cfg)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn(xc, xn, cfg)
        stop.record()
        torch.cuda.synchronize()
        print(f"[ab] tag={tag} path={name} "
              f"ms={start.elapsed_time(stop) / reps:.4f}", flush=True)
        del xc, xn



if __name__ == "__main__":
    main()
