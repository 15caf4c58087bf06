#!/usr/bin/env python3
"""Denoise a single video sequence with the PyTorch port
(scripts/process_video_sequence.py's arguments, plus ``--device``).

Reads frames from a directory (or a registered dataset), denoises at the
given sigma, saves outputs + metrics into the result cache
(VNLB_TPU_CACHE, else ``~/.cache/vnlb_tpu``).

    python3 scripts/torch_process_video_sequence.py davis --device cuda
"""

import argparse
import json
import sys
from pathlib import Path

_root = str(Path(__file__).resolve().parent.parent)
if _root not in sys.path:
    sys.path.insert(0, _root)

from vnlb_tpu_torch import denoise  # noqa: E402
from vnlb_tpu_torch.testing.data import add_noise, load_dataset  # noqa: E402
from vnlb_tpu_torch.utils.metrics import compute_psnr  # noqa: E402
from vnlb_tpu_torch.utils.video_io import (read_video_sequence,  # noqa: E402
                                           save_result_sequence)


def run_sequence(name_or_path, sigma, preset="iphone", nframes=-1,
                 vid_set="custom", seed=123, device="cuda"):
    # every frame, then the first nframes: a sequence shorter than nframes
    # is still read from its directory (and cached under its own name)
    vid_name = Path(str(name_or_path).rstrip("/")).name
    try:
        clean = read_video_sequence(name_or_path)
    except (FileNotFoundError, OSError):
        clean = load_dataset(str(name_or_path), sigma=sigma)["clean"]
    if nframes > 0:
        clean = clean[:nframes]
    noisy = add_noise(clean, sigma, seed=seed)

    deno, basic, dtime = denoise(noisy, sigma, preset=preset, device=device)
    deno, basic = deno.cpu().numpy(), basic.cpu().numpy()

    res = {
        "video": vid_name, "sigma": sigma, "time_s": dtime,
        "fps": clean.shape[0] / dtime,
        "psnr_noisy": compute_psnr(noisy, clean),
        "psnr_basic": compute_psnr(basic, clean),
        "psnr_deno": compute_psnr(deno, clean),
    }
    out_dir = save_result_sequence(deno, "vnlb", vid_set, vid_name, sigma)
    (out_dir / "metrics.json").write_text(json.dumps(res, indent=2))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("video", help="frame directory or dataset name")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--preset", default="iphone")
    ap.add_argument("--nframes", type=int, default=-1)
    ap.add_argument("--vid-set", default="custom")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run_sequence(args.video, args.sigma, args.preset, args.nframes,
                       args.vid_set, device=args.device)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
