#!/usr/bin/env python3
"""K2 on the card: build csrc/econ_filter.cu with the register report of
ptxas, then check and time the kernel's tensor-core design against its
plain version and against the shared-memory design on the same inputs.

    python3 scripts/k2_probe.py

Prints the card's name and power limit, the ptxas lines of the kernels
(registers, spills), the tensor-core plan (dynamic shared memory, blocks
per SM) of four group shapes, and one line per shape: rms / scale against
the plain version, a bitwise repeat check and, at the main path's 12,288
groups, the times of both designs and of the plain version (CUDA events).
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import vnlb_tpu_torch as vt  # noqa: E402
from vnlb_tpu_torch import _build  # noqa: E402
from vnlb_tpu_torch.ops.econ_filter import (design, econ_filter_kernel,  # noqa: E402
                                            econ_filter_plain, tc_plan,
                                            tc_smem_bytes)

# (groups, K, p, stage of the API default)
SHAPES = [(1000, 100, 49, 0), (1000, 60, 98, 1), (777, 37, 98, 1),
          (777, 64, 33, 0), (12288, 100, 49, 0), (12288, 60, 98, 1)]


def cuda_ms(fn, reps=5):
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_report():
    """Compile econ_filter.cu alone with -Xptxas=-v; print the lines on
    registers and spills."""
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [_build._nvcc(), "-Xptxas=-v", *_build.NVCC_FLAGS, "-c", "-o",
         str(_build.BUILD_DIR / "econ_filter.probe.o"),
         str(_build.CSRC / "econ_filter.cu")],
        capture_output=True, text=True)
    print(f"nvcc rc={res.returncode} seconds={time.perf_counter() - t0:.1f}")
    for line in res.stderr.splitlines():
        if any(w in line for w in ("error", "Compiling", "spill",
                                   "registers")):
            print(line)
    if res.returncode:
        sys.exit(1)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    ptxas_report()
    _build.library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for k, p in {(k, p) for _, k, p, _ in SHAPES}:
        print("plan", k, p, tc_plan(k, p), tc_smem_bytes(k, p), flush=True)
    for g, k, p, stage in SHAPES:
        cfg = vt.default_config(20.0).stage(stage)
        base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
        xc, xn = (torch.from_numpy(base + rng.normal(size=(g, k, p))
                                   .astype(np.float32) * 20).to(dev)
                  for _ in range(2))
        got = econ_filter_kernel(xc, xn, cfg)
        again = econ_filter_kernel(xc, xn, cfg)
        old = econ_filter_kernel(xc, xn, cfg, smem_design=True)
        want = econ_filter_plain(xc, xn, cfg)
        scale = want.abs().mean().item()

        def rms(x):
            return ((x - want) ** 2).mean().sqrt().item() / scale

        line = dict(G=g, K=k, p=p, design=design(k, p, True),
                    rms=f"{rms(got):.3g}", rms_smem=f"{rms(old):.3g}",
                    finite=bool(torch.isfinite(got).all()),
                    bitwise_repeat=bool(torch.equal(got, again)))
        if g == 12288:
            line.update(
                tc_ms=f"{cuda_ms(lambda: econ_filter_kernel(xc, xn, cfg)):.3f}",
                smem_ms=f"{cuda_ms(lambda: econ_filter_kernel(xc, xn, cfg, smem_design=True)):.3f}",
                plain_ms=f"{cuda_ms(lambda: econ_filter_plain(xc, xn, cfg), 2):.3f}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
