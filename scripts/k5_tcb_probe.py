#!/usr/bin/env python3
"""K5's batched tensor-core design ("tcb", csrc/poly_tcb.cu) on the card:
build the kernels with the register report of ptxas, hold the design's
launch plan to its Python mirror, check it against the plain version (a
repeat launch bitwise), time it at couple_channels' group shapes beside
the shared-memory design and the plain version, time patched copies of the
package beside it (other workspace sizes, ``kWsBytes`` and
``TCB_WS_BYTES``; under bf16, the gate over the upper triangle mirrored,
as split TF32 computes it), and split one launch's device time by kernel
(torch.profiler).

    python3 scripts/k5_tcb_probe.py [--budgets MiB,MiB,...] [--no-smem]

Each patched copy is the package copied to build/prof/<variant>/ with its
edits, built there by its own ``_build`` and timed in a process of its own
(this script with ``--child <variant>``), on the same inputs.  Prints the
card's name and power limit, the ptxas lines of poly_tcb.cu, one
``check`` line per shape (rms / scale against the plain version, the
plan), one ``time`` line per (shape, variant) with the CUDA-event time of
a 4096-group launch, its rms / scale against the plain version and its
peak device memory (the package's line with the plain version's and the
shared-memory design's times), then the profiler's kernel times of one
launch by kernel name.
"""

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
PROF = ROOT / "build" / "prof"


def _variant_arg():
    """The variant a ``--child`` process times (None: the parent)."""
    if "--child" in sys.argv:
        return sys.argv[sys.argv.index("--child") + 1]
    return None


# a child imports the patched copy of the package, the parent this one
sys.path.insert(0, str(PROF / _variant_arg() if _variant_arg() else ROOT))

# (groups, K, p, stage, poly_bf16): the couple_channels shapes in both
# modes, the left route beyond K = 64, the f32 (16, 128)
CHECKS = [(300, 100, 147, 0, True), (300, 60, 294, 1, True),
          (200, 100, 294, 0, True), (300, 60, 147, 1, True),
          (300, 100, 147, 0, False), (300, 60, 294, 1, False),
          (200, 100, 294, 0, False), (300, 60, 147, 1, False),
          (535, 65, 98, 1, True), (300, 16, 128, 1, False)]
TIMES = [(4096, 100, 147, 0, True), (4096, 60, 294, 1, True),
         (4096, 100, 147, 0, False), (4096, 60, 294, 1, False)]
# the patched copies: the workspace size (both sides), and the bf16 gate
# over the upper triangle (the mirrored S^3 is the other-order product)
WS_CU = "constexpr long long kWsBytes = 512LL << 20;"
WS_PY = "TCB_WS_BYTES = 512 << 20"
BF16_UPPER = [("L.tiles = f32 ? tn * (tn + 1) / 2 : tn * tn;",
               "L.tiles = tn * (tn + 1) / 2;"),
              ("r.sym = M::kF32;", "r.sym = 1;")]
BF16_UPPER_PY = [("tiles=tn * tn if rnd else tn * (tn + 1) // 2,",
                  "tiles=tn * (tn + 1) // 2,")]
BF16_ONLY = {"bf16_upper"}   # variants that differ only under bf16


def groups(rng, g, k, p, dev):
    base = rng.normal(size=(g, 1, p)).astype(np.float32) * 30
    return tuple(torch.from_numpy(base + rng.normal(size=(g, k, p))
                                  .astype(np.float32) * 20).to(dev)
                 for _ in range(2))


def rel_rms(got, want):
    return (((got - want) ** 2).mean().sqrt() / want.abs().mean()).item()


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def patch(path, edits):
    src = path.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{path.name}: patch target not found: {old}")
        src = src.replace(old, new)
    path.write_text(src)


def make_variant(name, cu_edits, py_edits):
    """The package copied to build/prof/<name>/ with ``cu_edits`` to
    csrc/poly_tcb.cu and ``py_edits`` to ops/poly_filter.py; returns the
    process building its kernel library there."""
    pkg = PROF / name / "vnlb_tpu_torch"
    shutil.rmtree(PROF / name, ignore_errors=True)
    shutil.copytree(ROOT / "vnlb_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    patch(pkg / "csrc" / "poly_tcb.cu", cu_edits)
    patch(pkg / "ops" / "poly_filter.py", py_edits)
    return subprocess.Popen(
        [sys.executable, "-c",
         "from vnlb_tpu_torch import _build; _build.build()"],
        cwd=str(PROF / name),
        env={**os.environ, "PYTHONPATH": str(PROF / name)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def time_line(k5, name, g, k, p, stage, bf16, xc, xn, cfg, want):
    """Time the package's poly_filter (4096 groups, 3 launches after one),
    its peak memory above the inputs and its error; the ``time`` line's
    first fields."""
    dev = xc.device
    run = lambda: k5.poly_filter(xc, xn, cfg)  # noqa: E731
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kms = cuda_ms(run, 3)
    peak = torch.cuda.max_memory_allocated(dev) - base
    rms = rel_rms(run(), want)
    plan = k5.tcb_plan(g, k, p, bf16)
    return (f"time K={k} p={p} G={g} bf16={bf16} variant={name} "
            f"rms={rms:.3g} batch={plan['batch']} tiles={plan['tiles']} "
            f"ws_mib={plan['ws_bytes'] / 2 ** 20:.1f} kernel_ms={kms:.3f} "
            f"peak_mib={peak / 2 ** 20:.1f}")


def child(name):
    """A patched copy's ``time`` lines, on the parent's inputs."""
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch.ops import poly_filter as k5

    if not str(Path(k5.__file__).resolve()).startswith(str(PROF / name)):
        raise SystemExit(f"k5_tcb_probe: {k5.__file__} is not the copy")
    dev = torch.device("cuda", 0)
    for i, (g, k, p, stage, bf16) in enumerate(TIMES):
        if name in BF16_ONLY and not bf16:
            continue
        cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
        xc, xn = groups(np.random.default_rng(100 + i), g, k, p, dev)
        want = k5.poly_filter_plain(xc, xn, cfg)
        print(time_line(k5, name, g, k, p, stage, bf16, xc, xn, cfg, want),
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--budgets", default="64,1024")
    ap.add_argument("--no-smem", action="store_true")
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k5_tcb_probe: no CUDA device")
    if args.child:
        return child(args.child)
    import vnlb_tpu_torch as vt
    from vnlb_tpu_torch import _build
    from vnlb_tpu_torch.ops import poly_filter as k5

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    # the patched copies build in the background while this one builds
    variants = {"bf16_upper": (BF16_UPPER, BF16_UPPER_PY)}
    for mib in args.budgets.split(","):
        variants[f"ws{mib}"] = ([(WS_CU, WS_CU.replace("512", mib))],
                                [(WS_PY, WS_PY.replace("512", mib))])
    jobs = {name: make_variant(name, *edits)
            for name, edits in variants.items()}
    if not _build.library_path().exists():
        # the build with ptxas's report, kept to poly_tcb.cu's kernels
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, secs = _build.build(verbose=True)
        lines = buf.getvalue().splitlines()
        keep = False
        for ln in lines:
            if "Compiling entry function" in ln:
                keep = "tcb" in ln
            if keep and "Compiling" in ln:
                print("ptxas", ln.split("'")[1].split("tcb", 1)[1][:60])
            elif keep and ("registers" in ln or "spill" in ln):
                print("ptxas", ln.strip())
        print(f"build {secs:.1f} s", flush=True)
    for name, proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: build failed:\n{err}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    for g, k, p, stage, bf16 in CHECKS:
        cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
        xc, xn = groups(rng, g, k, p, dev)
        plan, mirror = k5.card_tcb_plan(g, k, p, bf16), k5.tcb_plan(
            g, k, p, bf16)
        before = k5.poly_filter.by_design["tcb"]
        got = k5.poly_filter(xc, xn, cfg)
        again = k5.poly_filter(xc, xn, cfg)
        want = k5.poly_filter_plain(xc, xn, cfg)
        torch.cuda.synchronize()
        rms = rel_rms(got, want)
        print(f"check K={k} p={p} G={g} bf16={bf16} "
              f"design={k5.design(k, p, bf16)} rms_over_scale={rms:.3g} "
              f"finite={bool(torch.isfinite(got).all())} "
              f"bitwise_repeat={torch.equal(got, again)} "
              f"tcb_launches={k5.poly_filter.by_design['tcb'] - before} "
              f"plan_equal={plan == mirror} plan={plan}", flush=True)
    # "tcb" forced on the main path's (60, 98) against "tc"
    cfg = vt.default_config(20.0).stage(1)
    xc, xn = groups(rng, 768, 60, 98, dev)
    tcb = k5.poly_filter_kernel(xc, xn, cfg, batched_design=True)
    tcd = k5.poly_filter_kernel(xc, xn, cfg)
    want = k5.poly_filter_plain(xc, xn, cfg)
    print(f"check forced tcb (60, 98): rms_vs_tc={rel_rms(tcb, tcd):.3g} "
          f"rms_vs_plain={rel_rms(tcb, want):.3g} "
          f"tc_vs_plain={rel_rms(tcd, want):.3g}", flush=True)

    for i, (g, k, p, stage, bf16) in enumerate(TIMES):
        cfg = vt.default_config(20.0).stage(stage).replace(poly_bf16=bf16)
        xc, xn = groups(np.random.default_rng(100 + i), g, k, p, dev)
        want = k5.poly_filter_plain(xc, xn, cfg)
        pms = cuda_ms(lambda: k5.poly_filter_plain(xc, xn, cfg), 1)
        sms = (None if args.no_smem else cuda_ms(
            lambda: k5.poly_filter_kernel(xc, xn, cfg, smem_design=True), 1))
        print(time_line(k5, "package", g, k, p, stage, bf16, xc, xn, cfg,
                        want) + f" plain_ms={pms:.3f} smem_ms="
              f"{'not run' if sms is None else f'{sms:.3f}'}", flush=True)
        from torch.profiler import ProfilerActivity, profile
        k5.poly_filter(xc, xn, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k5.poly_filter(xc, xn, cfg)
            torch.cuda.synchronize()
        rows = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0)
            if us:
                rows[ev.key] = (us / 1e3, ev.count)
        for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0]):
            print(f"profile K={k} p={p} bf16={bf16} ms={ms:.3f} launches={n}"
                  f" kernel={name[:90]}", flush=True)
    del xc, xn, want
    torch.cuda.empty_cache()
    # each patched copy in a process of its own, one after another
    for name in variants:
        res = subprocess.run([sys.executable, __file__, "--child", name],
                             capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"{name}: the child failed:\n{res.stderr}")


if __name__ == "__main__":
    main()
