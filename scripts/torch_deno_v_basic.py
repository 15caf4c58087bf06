#!/usr/bin/env python3
"""Where the second pass helps over the first, in the PyTorch port
(scripts/deno_v_basic.py's arguments, plus ``--device``): the PSNR of
basic and deno, then per frame the PSNR of each on the clean frame's
edges (the top 20% of its Sobel magnitude) and on the rest, and their
delta.

    python3 scripts/torch_deno_v_basic.py --dataset davis --device cuda
    python3 scripts/torch_deno_v_basic.py --dataset davis_64x64 --device cpu
"""

import argparse
import sys
from pathlib import Path

import numpy as np

_root = str(Path(__file__).resolve().parent.parent)
if _root not in sys.path:
    sys.path.insert(0, _root)

from vnlb_tpu_torch import denoise  # noqa: E402
from vnlb_tpu_torch.testing.data import load_dataset  # noqa: E402
from vnlb_tpu_torch.utils.metrics import compute_psnr  # noqa: E402


def sobel_mag(img):
    """(c, h, w) -> (h, w) edge magnitude (reference utils/sobel.py:16-34)."""
    g = img.mean(axis=0)
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    ky = kx.T
    pad = np.pad(g, 1, mode="edge")
    gx = sum(kx[i, j] * pad[i:i + g.shape[0], j:j + g.shape[1]]
             for i in range(3) for j in range(3))
    gy = sum(ky[i, j] * pad[i:i + g.shape[0], j:j + g.shape[1]]
             for i in range(3) for j in range(3))
    return np.sqrt(gx ** 2 + gy ** 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="davis_64x64")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    data = load_dataset(args.dataset, sigma=args.sigma)
    clean, noisy = data["clean"], data["noisy"]
    deno, basic, _ = denoise(noisy, args.sigma, device=args.device)
    deno, basic = deno.cpu().numpy(), basic.cpu().numpy()

    print(f"basic: {compute_psnr(basic, clean):.3f} dB   "
          f"deno: {compute_psnr(deno, clean):.3f} dB")

    for ti in range(clean.shape[0]):
        mag = sobel_mag(clean[ti])
        edges = mag > np.percentile(mag, 80)
        for name, mask in [("edge", edges), ("flat", ~edges)]:
            eb = ((basic[ti, :, mask] - clean[ti, :, mask]) ** 2).mean()
            ed = ((deno[ti, :, mask] - clean[ti, :, mask]) ** 2).mean()
            pb = -10 * np.log10(eb / 255 ** 2)
            pd = -10 * np.log10(ed / 255 ** 2)
            print(f"frame {ti} {name}: basic {pb:.2f}  deno {pd:.2f}  "
                  f"delta {pd - pb:+.3f} dB")


if __name__ == "__main__":
    main()
