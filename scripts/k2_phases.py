#!/usr/bin/env python3
"""Where a group's time goes in K2's tensor-core design, on the card.

    python3 scripts/k2_phases.py

Copies csrc/econ_filter.cu to build/prof/, inserts a barrier and a
clock64() mark (thread 0 of each block) between the tensor-core kernel's
phases, builds that copy on its own and runs it once at 12,288 groups of
each main-path shape.  Prints the cycles per group of each phase: wall
cycles of a block, so with two blocks on an SM each phase also holds the
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
from vnlb_tpu_torch.ops.econ_filter import _consts  # noqa: E402

PROF = r'''
__device__ unsigned long long vnlb_prof[32];
#define PROF(i) do { __syncthreads(); if (threadIdx.x == 0) { \
  long long _t = clock64(); \
  atomicAdd(&vnlb_prof[i], (unsigned long long)(_t - _t0)); _t0 = _t; } \
} while (0)
'''
READ = r'''
extern "C" int vnlb_prof_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, vnlb_prof, 32 * sizeof(*h));
}
extern "C" int vnlb_prof_zero() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(vnlb_prof, z, sizeof(z));
}
'''
# (phase, the source line the mark goes before); each mark closes the
# phase named beside it, which began at the previous mark
MARKS = [
    ("load", "    // covariance (matrix route) or Gram (Gram route), f32 "
             "operands\n    tc::syrk"),
    ("syrk", "    // lub = max("),
    ("lub", "    // transfer values at the scaled Chebyshev nodes"),
    ("fv_gam", "    // A = M * (2 / lub) - I\n    const float sc"),
    ("chain_A_B_T3", "    // Clenshaw in B over"),
    ("clenshaw", "    // F = V_0 + hi B - lo, into P"),
    ("final_F", "    // applications in rows of m16n8 tiles"),
    ("mh_syrk", "      tc::store_colT(buf0, ps, [&](int k) { return P[k]; "
                "});\n      tc::store_row(buf1"),
    ("t_xcT", "      const float yscale = 2.f / ((float)K * lub), f0"),
    ("apply", "    __syncthreads();  // the next group overwrites the patch "
              "blocks"),
]


def patched_source():
    src = (_build.CSRC / "econ_filter.cu").read_text()
    start = src.index("econ_tc_kernel(const")
    for i, (_, key) in enumerate(MARKS):
        at = src.rindex(key)          # the tensor-core kernel comes last
        assert at > start, key
        src = src[:at] + f"    PROF({i});\n" + src[at:]
    group = "    const size_t base = (size_t)grp * kp;\n"
    at = src.index(group, start) + len(group)
    src = src[:at] + "    long long _t0 = clock64();\n" + src[at:]
    src = src.replace('#include "group_mm.cuh"\n',
                      '#include "group_mm.cuh"\n' + PROF, 1)
    return src + READ


def build():
    out = _build.BUILD_DIR.parent / "prof"
    out.mkdir(parents=True, exist_ok=True)
    (out / "econ_prof.cu").write_text(patched_source())
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", str(out / "libprof.so"), str(out / "econ_prof.cu")],
        capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"nvcc failed:\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out / "libprof.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vnlb_econ_filter_tc.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p,
                                        f, f, f, f, f, p]
    return lib


def main():
    lib = build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    g = 12288
    for k, p, stage in ((100, 49, 0), (60, 98, 1)):
        cfg = vt.default_config(20.0).stage(stage)
        base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
        xc, xn = (torch.from_numpy(base + rng.normal(size=(g, k, p))
                                   .astype(np.float32) * 20).to(dev)
                  for _ in range(2))
        out = torch.empty_like(xc)
        ep, xs, proj, v0 = _consts(cfg, k, p, dev)

        def run():
            err = lib.vnlb_econ_filter_tc(
                xc.data_ptr(), xn.data_ptr(), out.data_ptr(), g, k, p,
                ep["m"], ep["s"], ep["nodes"], xs.data_ptr(),
                proj.data_ptr(), None if v0 is None else v0.data_ptr(),
                float(ep["tau"]), float(1.5 * ep["tau"]), float(ep["sb2"]),
                float(ep["s2"]), float(ep["cwg"]),
                torch.cuda.current_stream().cuda_stream)
            _build.check(err, "profiled econ_filter")

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
