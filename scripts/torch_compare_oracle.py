#!/usr/bin/env python3
"""Full-pipeline parity of the PyTorch port against the C++ oracle
(scripts/compare_oracle.py's protocol and markdown table, plus
``--device``): the port's two-pass ``denoise`` and the sequential
double-precision oracle (``vnlb_tpu_torch.testing.oracle``) run on the same
clip; the table gives the relative error of each pass and both sides'
PSNRs.  Imports no jax.

    python3 scripts/torch_compare_oracle.py --device cuda
    python3 scripts/torch_compare_oracle.py --frames 3 --size 32 --device cpu

The oracle takes ~36 s on a 3x48x48 clip (one CPU core), the port a few
seconds on the CPU.
"""

import argparse
import sys
from pathlib import Path

_root = str(Path(__file__).resolve().parent.parent)
if _root not in sys.path:
    sys.path.insert(0, _root)

import numpy as np  # noqa: E402

from vnlb_tpu_torch import default_config, denoise  # noqa: E402
from vnlb_tpu_torch.testing.data import load_dataset  # noqa: E402
from vnlb_tpu_torch.testing.oracle import oracle_denoise  # noqa: E402
from vnlb_tpu_torch.utils.metrics import compute_psnr  # noqa: E402


def rel_error(a, b):
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-10))


def main(argv=None):
    """Print the table; returns the clip, both outputs of each side and the
    table's numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="davis_64x64")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--eig", default="jacobi",
                    help="jacobi (exact parity) | rational (fast path)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = load_dataset(args.dataset, sigma=args.sigma)
    clean = data["clean"][:args.frames, :, :args.size, :args.size]
    noisy = data["noisy"][:args.frames, :, :args.size, :args.size]

    # l2 in both passes: the docs/COMPARE.md protocol
    cfg = default_config(args.sigma, preset="iphone",
                         stype=["l2", "l2"], eig_method=args.eig)

    deno, basic, dtime = denoise(noisy, args.sigma, cfg=cfg,
                                 device=args.device)
    deno, basic = deno.cpu().numpy(), basic.cpu().numpy()

    print("running C++ oracle (sequential, double precision)...")
    o_deno, o_basic = oracle_denoise(noisy, args.sigma, cfg)

    res = dict(clean=clean, noisy=noisy, deno=deno, basic=basic,
               o_deno=o_deno, o_basic=o_basic,
               rel_basic=rel_error(basic, o_basic),
               rel_deno=rel_error(deno, o_deno),
               psnr_basic=compute_psnr(basic, clean),
               psnr_deno=compute_psnr(deno, clean),
               o_psnr_basic=compute_psnr(o_basic, clean),
               o_psnr_deno=compute_psnr(o_deno, clean), seconds=dtime)
    rows = [
        ("basic rel. error", f"{res['rel_basic']:.6f}", ""),
        ("deno rel. error", f"{res['rel_deno']:.6f}", ""),
        ("PSNR oracle (basic/deno)", f"{res['o_psnr_basic']:.4f}",
         f"{res['o_psnr_deno']:.4f}"),
        ("PSNR port (basic/deno)", f"{res['psnr_basic']:.4f}",
         f"{res['psnr_deno']:.4f}"),
        ("PSNR abs. delta (basic/deno)",
         f"{abs(res['psnr_basic'] - res['o_psnr_basic']):.4f}",
         f"{abs(res['psnr_deno'] - res['o_psnr_deno']):.4f}"),
        (f"port wall time ({args.device})", f"{dtime:.2f}s",
         f"{clean.shape[0] / dtime:.2f} fps"),
    ]
    print("\n| metric | value | value2 |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r[0]} | {r[1]} | {r[2]} |")
    return res


if __name__ == "__main__":
    main()
