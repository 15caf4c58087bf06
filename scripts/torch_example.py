#!/usr/bin/env python3
"""Quickstart of the PyTorch port (scripts/example.py's arguments, plus
``--device``): denoise a clip and report PSNRs and SSIM.

    python3 scripts/torch_example.py --dataset davis --device cuda
    python3 scripts/torch_example.py --dataset davis_64x64 --device cpu
"""

import argparse
import sys
import time
from pathlib import Path

_root = str(Path(__file__).resolve().parent.parent)
if _root not in sys.path:
    sys.path.insert(0, _root)

from vnlb_tpu_torch import denoise  # noqa: E402
from vnlb_tpu_torch.testing.data import load_dataset  # noqa: E402
from vnlb_tpu_torch.utils.metrics import (compute_psnr,  # noqa: E402
                                          compute_ssim)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="davis_64x64")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--preset", default="iphone")
    ap.add_argument("--save", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    data = load_dataset(args.dataset, sigma=args.sigma)
    clean, noisy = data["clean"], data["noisy"]

    deno, basic, dtime = denoise(noisy, args.sigma, preset=args.preset,
                                 verbose=True, device=args.device)
    deno, basic = deno.cpu().numpy(), basic.cpu().numpy()

    print(f"time: {dtime:.2f}s ({clean.shape[0] / dtime:.2f} fps)")
    print(f"psnr  noisy: {compute_psnr(noisy, clean):.3f} dB")
    print(f"psnr  basic: {compute_psnr(basic, clean):.3f} dB")
    print(f"psnr   deno: {compute_psnr(deno, clean):.3f} dB")
    t0 = time.perf_counter()
    ssim = compute_ssim(deno, clean)
    print(f"ssim   deno: {ssim:.4f} ({time.perf_counter() - t0:.2f}s)")

    if args.save:
        from vnlb_tpu_torch.utils.video_io import save_burst

        save_burst(deno, args.save, "deno")
        save_burst(basic, args.save, "basic")
        print(f"saved to {args.save}")


if __name__ == "__main__":
    main()
