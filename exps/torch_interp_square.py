#!/usr/bin/env python3
"""PSNR surface over convex blends of denoiser outputs in the PyTorch port
(exps/interp_square.py's arguments, plus ``--device``): alpha-blends of
{vnlb, pacnet, udvd} outputs, memoized.

    python3 exps/torch_interp_square.py --dataset davis --device cuda
    python3 exps/torch_interp_square.py --dataset davis_64x64 --device cpu

Reads cached outputs from the result cache both packages share
(``vnlb_tpu_torch.api.proc_nn``, ``VNLB_TPU_CACHE``); a missing vnlb
output is made by the port's ``denoise`` on ``--device``, a missing NN
output by the same blurred stand-in as exps/interp_square.py, and each is
saved there.  The surface is memoized under
``cache_root()/exps/torch_interp_square/``, apart from the JAX script's
memo, keyed by (dataset, sigma, grid, methods).
"""

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

_root = str(Path(__file__).resolve().parent.parent)
if _root not in sys.path:
    sys.path.insert(0, _root)

from vnlb_tpu_torch import denoise, proc_nn  # noqa: E402
from vnlb_tpu_torch.testing.data import load_dataset  # noqa: E402
from vnlb_tpu_torch.utils.metrics import compute_psnr  # noqa: E402
from vnlb_tpu_torch.utils.video_io import (cache_root,  # noqa: E402
                                           save_result_sequence)


def _exp_cache(key):
    d = cache_root() / "exps" / "torch_interp_square"
    d.mkdir(parents=True, exist_ok=True)
    return d / (hashlib.sha1(key.encode()).hexdigest()[:16] + ".json")


def get_output(method, vid_set, vid_name, sigma, noisy, device):
    out = proc_nn(method, vid_set, vid_name, sigma)
    if out is None:
        if method == "vnlb":
            deno, _, _ = denoise(noisy, sigma, device=device)
            out = deno.cpu().numpy()
        else:
            # stand-in for absent NN caches: a blurred vnlb output
            base = get_output("vnlb", vid_set, vid_name, sigma, noisy, device)
            out = 0.5 * (base + np.roll(base, 1, -1))
        save_result_sequence(out, method, vid_set, vid_name, sigma)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="davis_64x64")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--grid", type=int, default=5)
    ap.add_argument("--methods", nargs=3,
                    default=["vnlb", "pacnet", "udvd"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    key = f"{args.dataset}|{args.sigma}|{args.grid}|{args.methods}"
    cache = _exp_cache(key)
    if cache.exists():
        print(cache.read_text())
        return

    data = load_dataset(args.dataset, sigma=args.sigma)
    clean, noisy = data["clean"], data["noisy"]
    outs = [get_output(m, args.dataset, "exp", args.sigma, noisy,
                       args.device) for m in args.methods]

    grid = np.linspace(0, 1, args.grid)
    table = []
    for a in grid:
        for b in grid:
            if a + b > 1:
                continue
            mix = a * outs[0] + b * outs[1] + (1 - a - b) * outs[2]
            table.append({"alpha": float(a), "beta": float(b),
                          "psnr": compute_psnr(mix, clean)})
    best = max(table, key=lambda r: r["psnr"])
    out = json.dumps({"surface": table, "best": best}, indent=2)
    cache.write_text(out)
    print(out)


if __name__ == "__main__":
    main()
