#!/usr/bin/env python3
"""Sweep a video set with the PyTorch port
(scripts/process_video_set.py's arguments, plus ``--device``).

Runs the denoiser over every sequence of a set (one frame directory per
video under ``data_root()/<set>``, or a synthetic roster when the set is
not on disk), with per-sequence output caching, skip-on-cache and
retry-on-failure.  Writes a markdown summary table and
``output/<set>_s<sigma>_summary.json``.

    python3 scripts/torch_process_video_set.py --vid-set set8 --device cuda
"""

import argparse
import json
import sys
import traceback
import zlib
from pathlib import Path

_here = Path(__file__).resolve().parent
for _p in (str(_here.parent), str(_here)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from vnlb_tpu_torch.testing.data import data_root  # noqa: E402
from vnlb_tpu_torch.utils.logger import Logger  # noqa: E402
from vnlb_tpu_torch.utils.video_io import read_result_sequence  # noqa: E402

from torch_process_video_sequence import run_sequence  # noqa: E402


def list_videos(vid_set: str):
    root = data_root() / vid_set
    if root.exists():
        return sorted(p.name for p in root.iterdir() if p.is_dir()), root
    # synthetic fallback: a small fixed roster
    return [f"synth_{i:02d}" for i in range(4)], None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vid-set", default="set8")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--preset", default="iphone")
    ap.add_argument("--nframes", type=int, default=10)
    ap.add_argument("--retries", type=int, default=1)
    ap.add_argument("--log", default="")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.log:
        sys.stdout = Logger(args.log)

    videos, root = list_videos(args.vid_set)
    results = []
    for i, vid in enumerate(videos):
        if not args.overwrite and \
                read_result_sequence("vnlb", args.vid_set, vid, args.sigma) \
                is not None:
            print(f"[{i + 1}/{len(videos)}] {vid}: cached, skipping")
            continue
        src = (root / vid) if root else "davis_64x64"
        for attempt in range(args.retries + 1):
            try:
                # stable across processes (Python's str hash is randomized)
                seed = zlib.crc32(vid.encode()) % 2 ** 31
                res = run_sequence(src, args.sigma, args.preset, args.nframes,
                                   args.vid_set, seed=seed,
                                   device=args.device)
                res["video"] = vid
                results.append(res)
                print(f"[{i + 1}/{len(videos)}] {vid}: "
                      f"deno {res['psnr_deno']:.2f} dB  {res['fps']:.2f} fps")
                break
            except Exception:
                print(f"[{i + 1}/{len(videos)}] {vid}: attempt {attempt} "
                      f"failed\n{traceback.format_exc()}")
        else:
            print(f"[{i + 1}/{len(videos)}] {vid}: giving up")

    if results:
        print("\n| video | psnr_noisy | psnr_basic | psnr_deno | fps |")
        print("|---|---|---|---|---|")
        for r in results:
            print(f"| {r['video']} | {r['psnr_noisy']:.2f} | "
                  f"{r['psnr_basic']:.2f} | {r['psnr_deno']:.2f} | "
                  f"{r['fps']:.2f} |")
        out = Path(f"output/{args.vid_set}_s{int(args.sigma)}_summary.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
