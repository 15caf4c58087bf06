#!/usr/bin/env python3
"""Long clips through ``denoise_streaming`` on the CUDA card: wall time,
peak device memory and PSNR against the clean clip, and the gaps to the
whole-clip ``denoise`` of the same clip.

    python3 scripts/torch_stream_probe.py --frames 48,96 --whole 48
    python3 scripts/torch_stream_probe.py --frames 36 --height 1080 \
        --width 1920 --chunk 4,2 --whole 36

For each clip length of ``--frames`` (a synthetic clip from ``--seed``,
sigma 20, the API default unless ``--nwt`` narrows the window) and each
chunk of ``--chunk`` in turn until one fits: one warm streamed call at the
smallest length (unless ``--no-warm``), then the timed call; for the lengths in ``--whole``, the
whole-clip ``denoise`` too.  A call that runs out of device memory is
reported as such.  One JSON object per line on standard output, each with
the card's name and power limit.  It calls ``denoise_streaming`` without
``kernels=``, so ``--tree`` may name another checkout whose package is
measured in its place.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GIB = 2 ** 30


def card_name() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", default="48")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=854)
    ap.add_argument("--chunk", default="12")
    ap.add_argument("--whole", default="")
    ap.add_argument("--nwt", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose vnlb_tpu_torch is measured")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch.testing.data import add_noise, synthetic_video
    from vnlb_tpu_torch.utils.metrics import compute_psnr

    if not torch.cuda.is_available():
        raise SystemExit("torch_stream_probe: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.cuda.set_device(dev)
    card = card_name()
    over = {} if not args.nwt else dict(nwt_f=[args.nwt] * 2,
                                        nwt_b=[args.nwt] * 2)
    cfg = vt.default_config(20.0, **over)
    frames, chunks, whole = ints(args.frames), ints(args.chunk), \
        set(ints(args.whole))
    size = (args.height, args.width)

    def emit(**row):
        print(json.dumps(dict(card=card, package=os.path.dirname(
            vt.__file__), height=size[0], width=size[1], **row)),
              flush=True)

    def run(fn):
        """(outputs, seconds, peak GiB), or None out of memory."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(dev)
            sec = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as err:
            torch.cuda.empty_cache()
            return None, str(err).splitlines()[0][:200]
        return (out, sec, torch.cuda.max_memory_allocated(dev) / GIB), None

    if not args.no_warm:
        warm = add_noise(synthetic_video(min(frames), *size, seed=args.seed),
                         20.0, seed=args.seed + 1)
        got, err = run(lambda: vt.denoise_streaming(
            warm, 20.0, cfg=cfg, chunk=chunks[0], device=dev))
        emit(kind="warm", frames=min(frames), chunk=chunks[0],
             seconds=None if got is None else got[1], oom=err)
        del warm
    for t_len in frames:
        clean = synthetic_video(t_len, *size, seed=args.seed)
        noisy = add_noise(clean, 20.0, seed=args.seed + 1)
        psnr = lambda x: compute_psnr(np.asarray(x), clean)  # noqa: E731
        streamed = None
        for chunk in chunks:
            got, err = run(lambda: vt.denoise_streaming(
                noisy, 20.0, cfg=cfg, chunk=chunk, device=dev))
            if got is None:
                emit(kind="stream", frames=t_len, chunk=chunk, oom=err)
                continue
            (deno, basic, _), sec, peak = got
            emit(kind="stream", frames=t_len, chunk=chunk, seconds=sec,
                 fps=t_len / sec, peak_gib=peak, psnr_noisy=psnr(noisy),
                 psnr_basic=psnr(basic), psnr_deno=psnr(deno))
            streamed = (deno, basic)
            break
        if t_len not in whole:
            continue
        got, err = run(lambda: vt.denoise(noisy, 20.0, cfg=cfg, device=dev))
        if got is None:
            emit(kind="whole", frames=t_len, oom=err)
            continue
        (deno, basic, _), sec, peak = got
        deno, basic = deno.cpu().numpy(), basic.cpu().numpy()
        row = dict(kind="whole", frames=t_len, seconds=sec, fps=t_len / sec,
                   peak_gib=peak, psnr_basic=psnr(basic),
                   psnr_deno=psnr(deno))
        if streamed is not None:
            for tag, a, b in (("basic", streamed[1], basic),
                              ("deno", streamed[0], deno)):
                d = a.astype(np.float64) - b.astype(np.float64)
                row[f"gap_{tag}_mean_abs"] = float(np.abs(d).mean())
                row[f"gap_{tag}_rms"] = float(np.sqrt((d * d).mean()))
                row[f"gap_{tag}_max"] = float(np.abs(d).max())
        emit(**row)


if __name__ == "__main__":
    main()
