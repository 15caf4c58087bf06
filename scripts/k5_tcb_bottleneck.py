#!/usr/bin/env python3
"""What bounds the batched design's product kernel (csrc/poly_tcb.cu
`tcb_mm`) on the card: build patched copies of poly_tcb.cu on their own
(one without the tensor-core products, one without the operand copies into
shared memory: their outputs are meaningless, their times are not), run
each on 4096 couple_channels groups, and print each kernel's device time by
name (torch.profiler) beside one ``torch.bmm`` of the same operand shape as
a sub-batch's p x p product (cuBLAS, timed here only as a yardstick).

    python3 scripts/k5_tcb_bottleneck.py

Prints the card's name and power limit, then per (variant, shape, mode)
the device ms and launches of each kernel, and the bmm lines.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

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
SHAPES = [(4096, 60, 294, 1), (4096, 100, 147, 0)]


def build(name, edits):
    """Start nvcc on a copy of poly_tcb.cu with ``edits`` (pairs of old,
    new text) as build/prof/tcb_<name>.so; returns (path, process)."""
    from vnlb_tpu_torch import _build

    out = ROOT / "build" / "prof" / f"tcb_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "poly_tcb.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: patch target not found: {old}")
        src = src.replace(old, new)
    path = out.with_suffix(".cu")
    path.write_text(src)
    return out, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), "-o", str(out), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(out):
    """The batched design's two entry points of a library ``build`` made:
    (launch, plan)."""
    from vnlb_tpu_torch import _build

    lib = ctypes.CDLL(str(out))
    fns = []
    for name in ("vnlb_poly_filter_tcb", "vnlb_poly_filter_tcb_plan"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name]
        fns.append(fn)
    return tuple(fns)


def launcher(fns, xc, xn, cfg):
    """(run, plan): ``run()`` launches the library's batched design on
    (G, K, p) CUDA groups under ``cfg`` and returns the output; as the
    wrapper does, it allocates the output and a workspace of the library's
    own plan (``plan``, the keys of ops/poly_filter.tcb_plan) each call."""
    from vnlb_tpu_torch import _build
    from vnlb_tpu_torch.ops.polyspec import _AGGR, poly_params

    launch, plan_fn = fns
    g, k, p = xc.shape
    pp = poly_params(cfg)
    v = (ctypes.c_longlong * 7)()
    _build.check(plan_fn(g, k, p, int(pp["rnd"]), v), "tcb plan")
    plan = dict(zip(("p_pad", "k_pad", "tiles", "ztiles", "batch",
                     "group_bytes", "ws_bytes"), v))
    dev = xc.device
    xs = torch.as_tensor(pp["xs"], device=dev)
    dct = torch.as_tensor(pp["dct"], device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        ws = torch.empty((plan["ws_bytes"],), dtype=torch.uint8, device=dev)
        out = torch.empty_like(xn)
        _build.check(launch(
            xc.data_ptr(), xn.data_ptr(), out.data_ptr(), g, k, p,
            pp["n_aggr"], pp["n_polish"], pp["wdeg"], pp["nodes"],
            xs.data_ptr(), dct.data_ptr(), float(pp["tau"]),
            float(pp["sb2"]), float(pp["s2"]), *(float(a) for a in _AGGR),
            int(pp["rnd"]), ws.data_ptr(), plan["ws_bytes"], stream), "tcb")
        return out

    return run, plan


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k5_tcb_bottleneck: no CUDA device")
    import vnlb_tpu_torch as vt
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    jobs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    libs = {}
    for name, (out, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{err}")
        libs[name] = load(out)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for g, k, p, stage in SHAPES:
        for bf16 in (True, False):
            cfg = vt.default_config(20.0).stage(stage).replace(
                poly_bf16=bf16)
            base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
            xc, xn = (torch.from_numpy(base + rng.normal(size=(g, k, p))
                                       .astype(np.float32) * 20).to(dev)
                      for _ in range(2))
            for name, fns in libs.items():
                run, plan = launcher(fns, xc, xn, cfg)
                run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
                for ev in prof.key_averages():
                    us = getattr(ev, "device_time_total", 0) or 0
                    if us and "tcb" in ev.key:
                        kname = (ev.key.replace("(anonymous namespace)::", "")
                                 .split("(")[0])
                        print(f"variant={name} K={k} p={p} bf16={bf16} "
                              f"ms={us / 1e3:.3f} launches={ev.count} "
                              f"kernel={kname}", flush=True)
            # one sub-batch's p x p product as one library call
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


if __name__ == "__main__":
    main()
