#!/usr/bin/env python3
"""The filter kernels K2 and K5 on the card: build csrc/econ_filter.cu and
csrc/poly_filter.cu with the register report of ptxas, hold each design's
launch plan to its Python mirror, then check and time each group shape's
design against its plain version and against the shared-memory design on
the same inputs.

    python3 scripts/filter_probe.py [--tree DIR] [--sha-only]

Prints the card's name and power limit, the ptxas lines of the kernels
(registers, spills), the plans (dynamic shared memory, blocks per SM) and
one line per shape: rms / scale against the plain version (and of the
shared-memory design), a bitwise repeat check and, at 12,288 groups, the
times of the design, of the shared-memory design and of the plain version
(CUDA events).  ``--sha-only`` prints only a SHA-256 of K2's output at the
main path's two shapes from fixed inputs, for the package under ``--tree``
(default: this checkout), so that two trees can be compared bit for bit.
"""

import argparse
import hashlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# (kernel, groups, K, p, preset, stage): the main path's K2 shapes, preset
# default's (100, 98), K5's two routes, ragged shapes of each design
SHAPES = [("k2", 12288, 100, 49, "iphone", 0), ("k2", 12288, 60, 98, "iphone", 1),
          ("k2", 12288, 100, 98, "default", 0), ("k2", 777, 100, 98, "default", 0),
          ("k2", 535, 70, 65, "default", 0), ("k2", 768, 100, 147, "iphone", 0),
          ("k5", 12288, 100, 49, "iphone", 0), ("k5", 12288, 60, 98, "iphone", 1),
          ("k5", 777, 37, 98, "iphone", 1), ("k5", 535, 64, 33, "iphone", 0),
          ("k5", 300, 16, 128, "iphone", 1), ("k5", 300, 100, 98, "default", 0),
          ("k5", 300, 20, 49, "iphone", 1), ("k5", 768, 60, 147, "iphone", 1)]


def cuda_ms(fn, reps=5):
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def groups(rng, g, k, p, dev):
    base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
    return tuple(torch.from_numpy(base + rng.normal(size=(g, k, p))
                                  .astype(np.float32) * 20).to(dev)
                 for _ in range(2))


def ptxas_report(_build):
    """Compile the two filter sources alone with -Xptxas=-v, in parallel;
    print the lines on registers and spills."""
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [(name, subprocess.Popen(
        [_build._nvcc(), "-Xptxas=-v", *_build.NVCC_FLAGS, "-c", "-o",
         str(_build.BUILD_DIR / f"{name}.probe.o"),
         str(_build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name in ("econ_filter", "poly_filter")]
    failed = False
    for name, proc in procs:
        _, err = proc.communicate()
        print(f"nvcc {name} rc={proc.returncode} "
              f"seconds={time.perf_counter() - t0:.1f}")
        for line in err.splitlines():
            if any(w in line for w in ("error", "Compiling", "spill",
                                       "registers")):
                print(line)
        failed |= proc.returncode != 0
    if failed:
        sys.exit(1)


def sha_only(vt, dev):
    from vnlb_tpu_torch.ops.econ_filter import econ_filter_kernel
    for k, p, stage in ((100, 49, 0), (60, 98, 1)):
        cfg = vt.default_config(20.0).stage(stage)
        xc, xn = groups(np.random.default_rng(k * p), 4096, k, p, dev)
        out = econ_filter_kernel(xc, xn, cfg).cpu().numpy()
        print(f"k2_sha K={k} p={p} "
              f"{hashlib.sha256(out.tobytes()).hexdigest()[:16]}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--sha-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.sha_only:
        sha_only(vt, dev)
        return
    from vnlb_tpu_torch.ops import econ_filter as k2
    from vnlb_tpu_torch.ops import poly_filter as k5

    ptxas_report(_build)
    _build.library()
    sha_only(vt, dev)
    for kind, g, k, p, preset, stage in SHAPES:
        mod = k2 if kind == "k2" else k5
        kern = k2.econ_filter_kernel if kind == "k2" else k5.poly_filter_kernel
        plain = k2.econ_filter_plain if kind == "k2" else k5.poly_filter_plain
        cfg = vt.default_config(20.0, preset=preset).stage(stage)
        dsg = mod.design(k, p, True)
        if kind == "k2" and dsg != "smem":
            plan, mirror = k2.tc_plan(k, p, dsg), k2.smem_bytes(dsg, k, p)
            blocks = k2.BLOCKS_PER_SM[dsg]
        elif kind == "k5" and dsg == "tc":
            plan, mirror = k5.tc_plan(k, p), k5.tc_smem_bytes(k, p)
            blocks = k5.BLOCKS_PER_SM[k5.tc_width(p)]
        else:
            plan, mirror, blocks = None, 0, 0
        xc, xn = groups(np.random.default_rng(k + p + g), g, k, p, dev)
        got = kern(xc, xn, cfg)
        again = kern(xc, xn, cfg)
        old = kern(xc, xn, cfg, smem_design=True)
        want = plain(xc, xn, cfg)
        torch.cuda.synchronize()
        scale = want.abs().mean().item()

        def rms(x):
            return ((x - want) ** 2).mean().sqrt().item() / scale

        line = dict(kernel=kind, G=g, K=k, p=p, design=dsg, plan=plan,
                    mirror=mirror, blocks_stated=blocks,
                    rms=f"{rms(got):.3g}", rms_smem=f"{rms(old):.3g}",
                    finite=bool(torch.isfinite(got).all()),
                    bitwise_repeat=bool(torch.equal(got, again)))
        if g == 12288:
            line.update(
                ms=f"{cuda_ms(lambda: kern(xc, xn, cfg)):.3f}",
                smem_ms=f"{cuda_ms(lambda: kern(xc, xn, cfg, smem_design=True), 2):.3f}",
                plain_ms=f"{cuda_ms(lambda: plain(xc, xn, cfg), 2):.3f}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
