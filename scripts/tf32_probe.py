#!/usr/bin/env python3
"""What the split-TF32 mode of the filter kernels pays for, on the card.

    python3 scripts/tf32_probe.py

Builds copies of csrc/econ_filter.cu and csrc/poly_filter.cu under
build/prof/tf32_<variant>/ whose econ_tc.cuh ``mma_term`` (the three TF32
products of a split-operand tile) is patched, each variant in its own
library (all nvcc processes started together), and times K2 and K5 in
split TF32 at their f32 shapes (12,288 groups; CUDA events, 5 launches
after a warmup) with the rms / scale of each variant against the plain
version.  Variants: ``x3`` (the kernels as they are), ``x2`` (big.big +
big.small: one correction term) and ``x1`` (big.big alone, plain TF32).
Only ``x3`` is accurate to f32; the others show how the time scales with
the tensor-core products a tile runs.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import vnlb_tpu_torch as vt  # noqa: E402
from vnlb_tpu_torch import _build  # noqa: E402
from vnlb_tpu_torch.ops import econ_filter as k2  # noqa: E402
from vnlb_tpu_torch.ops import poly_filter as k5  # noqa: E402

BODY = """  if (t == 0)
    mma_tf32(c, ab, bs0, bs1);
  else if (t == 1)
    mma_tf32(c, as, bb0, bb1);
  else
    mma_tf32(c, ab, bb0, bb1);
"""
VARIANTS = {
    "x3": BODY,
    "x2": ("  if (t != 1)\n    mma_tf32(c, ab, t == 0 ? bs0 : bb0, "
           "t == 0 ? bs1 : bb1);\n"),
    "x1": "  if (t == 2) mma_tf32(c, ab, bb0, bb1);\n",
}
# (kernel, K, p, stage)
SHAPES = [("k5", 100, 49, 0), ("k5", 60, 98, 1), ("k2", 100, 49, 0),
          ("k2", 60, 98, 1), ("k2", 100, 98, 0)]


def build_all():
    """One library per variant; returns {variant: ctypes.CDLL}."""
    procs, dirs = [], {}
    for name, body in VARIANTS.items():
        out = _build.BUILD_DIR.parent / "prof" / f"tf32_{name}"
        out.mkdir(parents=True, exist_ok=True)
        for src in _build._headers() + _build._sources():
            shutil.copy(src, out / src.name)
        hdr = (out / "econ_tc.cuh").read_text()
        if hdr.count(BODY) != 1:
            sys.exit("econ_tc.cuh: mma_term's body not found")
        (out / "econ_tc.cuh").write_text(hdr.replace(BODY, body))
        dirs[name] = out
        for stem in ("econ_filter", "poly_filter"):
            procs.append((name, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                 str(out / f"{stem}.o"), str(out / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc ({name}) failed:\n{err[-3000:]}")
    libs = {}
    for name, out in dirs.items():
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(out / "lib.so"), str(out / "econ_filter.o"),
             str(out / "poly_filter.o")], capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"link ({name}) failed:\n{res.stderr[-3000:]}")
        lib = ctypes.CDLL(str(out / "lib.so"))
        for fn, (argtypes, restype) in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def cuda_ms(fn, reps=5):
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build_all()
    rng = np.random.default_rng(0)
    g = 12288
    for kind, k, p, stage in SHAPES:
        cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=False)
        base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
        xc, xn = (torch.from_numpy(base + rng.normal(size=(g, k, p))
                                   .astype(np.float32) * 20).to(dev)
                  for _ in range(2))
        mod, kern = ((k5, k5.poly_filter_kernel) if kind == "k5" else
                     (k2, k2.econ_filter_kernel))
        plain = k5.poly_filter_plain if kind == "k5" else k2.econ_filter_plain
        want = plain(xc, xn, cfg)
        scale = want.abs().mean().item()
        line = dict(kernel=kind, K=k, p=p, design=mod.design(k, p, False))
        for name, lib in libs.items():
            # the wrappers launch through _build.library(): point it at the
            # variant's library for this measurement
            orig = _build.library
            _build.library = lambda lib=lib: lib
            try:
                got = kern(xc, xn, cfg)
                torch.cuda.synchronize()
                rms = ((got - want) ** 2).mean().sqrt().item() / scale
                ms = cuda_ms(lambda: kern(xc, xn, cfg))
            finally:
                _build.library = orig
            line[name] = f"{ms:.3f} ms, rms {rms:.3g}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
