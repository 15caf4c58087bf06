#!/usr/bin/env python3
"""What bounds the batched design's product kernel (csrc/poly_tcb.cu
`tcb_mm`) on the card: patched copies of the whole package (one without
the tensor-core products, one without the operand copies into shared
memory after the first stages: their outputs are meaningless, their times
are not; and one unpatched, "base"), each built by its own ``_build`` under
build/prof/bn_<variant>/ and run in a process of its own (the machinery
of scripts/k5_tcb_probe.py, imported from it) on 4096
couple_channels groups, with each kernel's device time by name
(torch.profiler); then one ``torch.bmm`` of the same operand shape as a
sub-batch's p x p product (cuBLAS, timed here only as a yardstick).

    python3 scripts/k5_tcb_bottleneck.py

Prints the card's name and power limit, then per (variant, shape, mode)
the launch's device ms by CUDA events, its rms / scale against the plain
version (a check for "base" and the package itself, which also runs), the
device ms and launches of each kernel, and the bmm lines.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# k5_tcb_probe.py's machinery: at import it puts this package, or in a
# ``--child`` process that process's patched copy, first on sys.path
import k5_tcb_probe as probe

VARIANTS = {
    "base": [],
    # the mma.sync calls never issue (the fragment loads stay)
    "no_mma": [("tc::mma_bf16(acc[mt][nt]", "if (0) tc::mma_bf16(acc[mt][nt]"),
               ("tc::mma_term(t, acc[mt][nt]",
                "if (0) tc::mma_term(t, acc[mt][nt]")],
    # no operand copies after the first stages (shared memory stale)
    "no_load": [("if (c + NS - 1 < nch) load(c + NS - 1, (c + NS - 1) % NS);",
                 "")],
}
# (groups, K, p, stage): couple_channels' joint groups of both passes
SHAPES = [(4096, 60, 294, 1), (4096, 100, 147, 0)]


def run_cases(name):
    """Per case: the launch's CUDA-event time, its rms / scale against
    the plain version, then each kernel's device time by name."""
    import vnlb_tpu_torch as vt
    from torch.profiler import ProfilerActivity, profile
    from vnlb_tpu_torch.ops import poly_filter as k5

    where = probe.PROF / name if name != "package" else probe.ROOT
    if not str(Path(k5.__file__).resolve()).startswith(str(where)):
        raise SystemExit(f"k5_tcb_bottleneck: {k5.__file__} is not "
                         f"under {where}")
    dev = torch.device("cuda", 0)
    cases = [(c, bf16) for c in SHAPES for bf16 in (True, False)]
    for i, ((g, k, p, stage), bf16) in enumerate(cases):
        cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
        xc, xn = probe.groups(np.random.default_rng(100 + i), g, k, p, dev)
        want = k5.poly_filter_plain(xc, xn, cfg)
        rms = probe.rel_rms(k5.poly_filter_kernel(xc, xn, cfg), want)
        del want
        ms = probe.cuda_ms(lambda: k5.poly_filter_kernel(xc, xn, cfg), 3)
        print(f"variant={name} K={k} p={p} bf16={bf16} "
              f"event_ms={ms:.3f} rms={rms:.3g}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k5.poly_filter_kernel(xc, xn, cfg)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0) or 0
            if us and "tcb" in ev.key:
                kname = (ev.key.replace("(anonymous namespace)::", "")
                         .split("(")[0])
                print(f"variant={name} K={k} p={p} bf16={bf16} "
                      f"ms={us / 1e3:.3f} launches={ev.count} "
                      f"kernel={kname}", flush=True)
        del xc, xn
        torch.cuda.empty_cache()


def bmm_lines():
    """One sub-batch's p x p product as one library call per shape."""
    from vnlb_tpu_torch.ops import poly_filter as k5

    dev = torch.device("cuda", 0)
    for g, k, p, _ in SHAPES:
        for bf16 in (True, False):
            plan = k5.tcb_plan(g, k, p, bf16)
            pad = plan["p_pad"]
            dt = torch.bfloat16 if bf16 else torch.float32
            a = torch.randn(plan["batch"], pad, pad, device=dev).to(dt)
            for tf32 in ((False,) if bf16 else (False, True)):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.bmm(a, a)
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(10):
                    torch.bmm(a, a)
                e1.record()
                torch.cuda.synchronize()
                print(f"bmm batch={plan['batch']} n={pad} dtype={dt} "
                      f"tf32={tf32} ms={e0.elapsed_time(e1) / 10:.4f}",
                      flush=True)
            torch.backends.cuda.matmul.allow_tf32 = False


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k5_tcb_bottleneck: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if probe._variant_arg():
        return run_cases(probe._variant_arg())
    from vnlb_tpu_torch import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    # the copies build in the background while the package builds
    jobs = {name: probe.make_variant(f"bn_{name}", edits, [])
            for name, edits in VARIANTS.items()}
    _build.build()
    for name, proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: build failed:\n{err}")
    run_cases("package")
    torch.cuda.empty_cache()
    # each patched copy in a process of its own, one after another
    for name in VARIANTS:
        res = subprocess.run([sys.executable, __file__, "--child",
                              f"bn_{name}"],
                             capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"{name}: the child failed:\n{res.stderr}")
    bmm_lines()


if __name__ == "__main__":
    main()
