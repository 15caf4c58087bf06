#!/usr/bin/env python3
"""How far the two stages of ``denoise_pipelined(meshes=...)`` overlap on
one card.

    python3 scripts/torch_pipe_probe.py [--frames 24] [--chunk 4]

On a synthetic 480x854 clip (seed 0, noise seed 1, sigma 20; nwt 2, mask
borders: chip_smoke.py's halo streaming config) of ``--frames`` frames,
for each stage size n in (1, 2): a world of 2n ranks runs
``pipelined_world`` (n ranks a stage) and a world of n ranks runs
``denoise_streaming(mesh=...)``; every rank on ``cuda:0`` over gloo, at
this process's torch threads.  The two outputs must be bitwise equal.
Prints, per n, the in-world walls, each stage's busy seconds, the stage
edge's bytes and seconds, and the overlap: (busy 1 + busy 2 - wall) /
min(busy 1, busy 2), 0 when the stages ran one after the other.  Also
prints ``schedule``'s window plan, the card's name and power limit.
Pass ``--device cpu`` to rehearse on the host at a small ``--height``.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import vnlb_tpu_torch as vt  # noqa: E402
from vnlb_tpu_torch.parallel.launch import run_world, sequence  # noqa: E402
from vnlb_tpu_torch.parallel.pipe import (pipelined_world,  # noqa: E402
                                          schedule)
from vnlb_tpu_torch.streaming import pass_ctx, windows  # noqa: E402
from vnlb_tpu_torch.testing.data import (add_noise,  # noqa: E402
                                         synthetic_video)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=854)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_pipe_probe: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, check=True).stdout.strip())
        from vnlb_tpu_torch import _build

        _build.build()             # once, before the ranks load it
    noisy = add_noise(synthetic_video(args.frames, args.height, args.width,
                                      seed=0), 20.0, seed=1)
    cfg = vt.default_config(20.0, nwt_f=2, nwt_b=2, border_mode="mask")
    w1 = windows(args.frames, args.chunk, pass_ctx(cfg.stage(0)))
    w2 = windows(args.frames, args.chunk, pass_ctx(cfg.stage(1)))
    print(json.dumps({"pass1_windows": w1, "pass2_windows": w2,
                      "pass2_ready_after_pass1_window": schedule(w1, w2)}))
    threads = torch.get_num_threads()
    for n in (1, 2):
        kw = dict(chunk=args.chunk, cfg=cfg)
        pipe = run_world(sequence, 2 * n, device=str(dev), threads=threads,
                         args=([(pipelined_world, (noisy, 20.0),
                                 dict(sizes=(n, n), **kw))],))
        stream = run_world(sequence, n, device=str(dev), threads=threads,
                           args=([(vt.denoise_streaming, (noisy, 20.0),
                                   kw)],))
        (sdeno, sbasic, _), stream_wall, _ = stream[0][0]
        for r in pipe:
            deno, basic, _, _ = r[0][0]
            if not (np.array_equal(deno, sdeno)
                    and np.array_equal(basic, sbasic)):
                raise AssertionError(f"stages of {n}: not bitwise equal to "
                                     f"the {n}-rank streaming run")
        stats = [r[0][0][3] for r in pipe]
        wall = max(r[0][1] for r in pipe)
        busy1 = max(s["busy_s"] for s in stats if s["stage"] == 1)
        busy2 = max(s["busy_s"] for s in stats if s["stage"] == 2)
        print(json.dumps({
            "stage_ranks": n, "frames": args.frames, "chunk": args.chunk,
            "device": str(dev), "bitwise_equal_streaming_mesh": True,
            "pipelined_wall_s": wall, "streaming_mesh_wall_s": stream_wall,
            "busy_s": [s["busy_s"] for s in stats],
            "edge_bytes_sent": sum(s["edge_bytes"] for s in stats
                                   if s["stage"] == 1),
            "edge_s": [s["edge_s"] for s in stats],
            "overlap": max(0.0, busy1 + busy2 - wall) / min(busy1, busy2),
        }), flush=True)


if __name__ == "__main__":
    main()
