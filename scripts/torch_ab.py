#!/usr/bin/env python3
"""Time the port's earlier 480p paths from one copy of ``vnlb_tpu_torch``,
for parent/change comparisons on one CUDA card.

    python3 scripts/torch_ab.py <dir holding vnlb_tpu_torch> <tag> [runs]

Runs ``denoise`` on the 5x480x854 clip of chip_smoke.py (sigma 20) with the
bench config and with the API default (zero flow): one warmup, then
``runs`` (default 3) timed runs each, and prints one ``[ab]`` line per path
with the walls, the best wall and the peak device memory.  To compare two trees, unpack the
parent's ``vnlb_tpu_torch`` into a directory that .gitignore lists and run
parent, change, change, parent in one call, e.g.

    sh -c 'python3 scripts/torch_ab.py build/ab/parent parent &&
           python3 scripts/torch_ab.py . change &&
           python3 scripts/torch_ab.py . change &&
           python3 scripts/torch_ab.py build/ab/parent parent'
"""

import os
import sys

import torch


def main():
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    runs = int(sys.argv[3]) if len(sys.argv) > 3 else 3
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
    for name, cfg in (("bench", bench), ("api_zero", None)):
        vt.denoise(noisy, 20.0, cfg=cfg, device=dev)
        walls = []
        for _ in range(runs):
            torch.cuda.reset_peak_memory_stats(dev)
            walls.append(vt.denoise(noisy, 20.0, cfg=cfg, device=dev)[2])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"[ab] tag={tag} path={name} seconds="
              f"{','.join(f'{t:.4f}' for t in walls)} best={min(walls):.4f} "
              f"peak_gib={peak:.3f}", flush=True)


if __name__ == "__main__":
    main()
