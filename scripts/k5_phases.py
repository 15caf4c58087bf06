#!/usr/bin/env python3
"""Where a group's time goes in K5's tensor-core design, on the card.

    python3 scripts/k5_phases.py

Copies csrc/poly_filter.cu to build/prof/, inserts a barrier and a
clock64() mark (thread 0 of each block) between the tensor-core kernel's
phases, builds that copy on its own and runs it once at 12,288 groups of
each route's main shape: right (100, 49) at width 64, left (60, 98) at
width 128.  Prints the cycles per group of each phase: wall cycles of a
block, so with two blocks on an SM (width 64) each phase also holds the
time the other block ran.  The marks' barriers slow the kernel a little;
compare phases, not totals, with the real kernel.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import vnlb_tpu_torch as vt  # noqa: E402
from vnlb_tpu_torch import _build  # noqa: E402
from vnlb_tpu_torch.ops.polyspec import _AGGR, poly_params  # noqa: E402

# the clock64() marks and their read-out, as K2's phase probe has them
from k2_phases import PROF, READ  # noqa: E402

# (phase, the source line the mark goes before); each mark closes the
# phase named beside it, which began at the previous mark of its route
MARKS = [
    ("load_xc", "    // covariance C, f32 operands, and lub"),
    ("syrk_lub", "    // the Wiener factor's node values"),
    ("coef", "    // S = st((C - tau I) / sc) on both sides"),
    ("s0_ah", "    // matrix sign gate: quintic steps"),
    ("gate_quintic", "    for (int it = 0; it < n_polish; ++it) {"),
    ("gate_polish", "    if (!left) {"),
    ("right_chebyshev", "      // F = st(W) st(Q), W = (S + I) / 2"),
    ("right_F", "      // xn = hi + mid + lo exactly"),
    ("right_load_xn", "      // out = xn st(F) in rows of m16n8 tiles"),
    ("left_w_load_xn", "      float zp[NZ], zc[NZ], acc[NZ];"),
    ("left_z0_syrk", "      tc::store_row(zb0, LDB, pz, [&](int i) { return "
                     "zp[i]; });"),
    ("left_recurrence", "#pragma unroll\n      for (int i = 0; i < NZ; ++i) "
                        "{\n        const int r = pz.row(i)"),
    ("apply_store", "    __syncthreads();  // the next group overwrites "
                    "shared memory"),
]


def patched_source():
    src = (_build.CSRC / "poly_filter.cu").read_text()
    start = src.index("poly_tc_kernel(const")
    for i, (_, key) in enumerate(MARKS):
        at = src.index(key, start)
        src = src[:at] + f"    PROF({i});\n" + src[at:]
    group = "    float* o = out + base;\n"
    at = src.index(group, start) + len(group)
    src = src[:at] + "    long long _t0 = clock64();\n" + src[at:]
    src = src.replace('#include "group_mm.cuh"\n',
                      '#include "group_mm.cuh"\n' + PROF, 1)
    return src + READ


def build():
    out = _build.BUILD_DIR.parent / "prof"
    out.mkdir(parents=True, exist_ok=True)
    (out / "poly_prof.cu").write_text(patched_source())
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", str(out / "libk5prof.so"),
         str(out / "poly_prof.cu")], capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"nvcc failed:\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out / "libk5prof.so"))
    argtypes, restype = _build.SIGNATURES["vnlb_poly_filter_tc"]
    lib.vnlb_poly_filter_tc.argtypes = argtypes
    lib.vnlb_poly_filter_tc.restype = restype
    return lib


def main():
    lib = build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    g = 12288
    for k, p, stage in ((100, 49, 0), (60, 98, 1)):
        cfg = vt.default_config(20.0).stage(stage)
        pp = poly_params(cfg)
        base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
        xc, xn = (torch.from_numpy(base + rng.normal(size=(g, k, p))
                                   .astype(np.float32) * 20).to(dev)
                  for _ in range(2))
        out = torch.empty_like(xc)
        xs = torch.as_tensor(pp["xs"], device=dev)
        dct = torch.as_tensor(pp["dct"], device=dev)

        def run():
            err = lib.vnlb_poly_filter_tc(
                xc.data_ptr(), xn.data_ptr(), out.data_ptr(), g, k, p,
                pp["n_aggr"], pp["n_polish"], pp["wdeg"], pp["nodes"],
                xs.data_ptr(), dct.data_ptr(), float(pp["tau"]),
                float(pp["sb2"]), float(pp["s2"]), *(float(a) for a in _AGGR),
                torch.cuda.current_stream().cuda_stream)
            _build.check(err, "profiled poly_filter")

        run()
        torch.cuda.synchronize()
        lib.vnlb_prof_zero()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 32)()
        lib.vnlb_prof_read(cycles)
        phases = {name: round(cycles[i] / g)
                  for i, (name, _) in enumerate(MARKS) if cycles[i]}
        print(f"K={k} p={p} ms_with_marks={start.elapsed_time(stop):.3f} "
              f"cycles_per_group={phases} total={sum(phases.values())}",
              flush=True)


if __name__ == "__main__":
    main()
