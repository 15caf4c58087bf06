#!/usr/bin/env python3
"""Readings that the limits of a cell's correctness check are set from, on
the CUDA card, in one process:

    python3 perfbench/tools/calibrate.py --workload <cell> \
        --seeds 11,12,... [--control-seeds 11,12,13] [--out FILE]

For each seed, every clip of the pool a run with that seed sends (the
calls it compares are drawn among them; the same flows and configuration,
at the cell's own sizes) goes through the traffic mix's entry in the
program and in the plain reference, and the gaps of ``basic`` and
``deno`` are printed as a ``program`` line.  For each control seed, the
same gaps of:

* ``control_tf32``: the reference with TF32 on in the program's place (the
  nearest precision below the full f32 the configuration states);
* ``control_agg_bf16``: the program with its own lower-precision path
  switched on (``agg_bf16=True``: the scatter's rows rounded to bf16);
* the faults a run can have: ``fault_identity`` (a call returns its input
  unchanged), ``fault_half`` (half of each search's sites left out, the
  fold's mean taken over the rest) and ``fault_frame`` (the last frame of
  ``deno`` one gray level off where it is produced).

One JSON object per line, on standard output and in ``--out``.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@contextlib.contextmanager
def half_sites(vt):
    """Fault: every pass filters only the first half of its dense sites and
    of its gather sites."""
    import torch

    pipe = vt.pipeline
    saved = pipe.accumulate

    def accumulate(noisy_yuv, basic_yuv, srch, fflow, bflow, sites, n_dense,
                   cfg, *rest, **kw):
        keep = torch.cat([sites[:n_dense // 2],
                          sites[n_dense:n_dense + (sites.shape[0]
                                                   - n_dense) // 2]])
        return saved(noisy_yuv, basic_yuv, srch, fflow, bflow, keep,
                     n_dense // 2, cfg, *rest, **kw)

    pipe.accumulate = accumulate
    try:
        yield
    finally:
        pipe.accumulate = saved


def frame_off(out):
    """Fault: the last frame of ``deno`` one gray level off."""
    deno, basic = out
    deno = deno.clone()
    deno[-1] += 1.0
    return deno, basic


def readings(cell, seeds, control_seeds, device, emit):
    import torch
    import vnlb_tpu_torch as vt

    from perfbench import reference
    from perfbench.harness import check
    from perfbench.harness.loop import program_config
    from perfbench.traffic.generator import make_pool, module

    dev = torch.device(device)
    conf, mix = cell.config, cell.traffic
    sigma = float(conf["sigma"])
    cfg = program_config(vt, conf)
    rcfg = program_config(reference, conf)
    entry = module(mix, "entry")

    def program(clip, c=cfg, hook=None):
        out = entry.program(vt, torch.from_numpy(clip.noisy).to(dev), clip,
                            sigma, c, dev, vt.KERNELS)
        return hook(out) if hook else out

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for seed in seeds:
        pool = make_pool(mix, conf["height"], conf["width"], sigma, seed)
        for i, clip in enumerate(pool):
            t0 = time.perf_counter()
            deno, basic = program(clip)
            sync()
            t1 = time.perf_counter()
            prog_s = t1 - t0
            rd, rb = entry.reference(reference, clip, sigma, rcfg, dev)
            sync()
            ref_s = time.perf_counter() - t1
            emit(dict(kind="program", seed=seed, call=i, program_s=prog_s,
                      reference_s=ref_s,
                      **check.gaps(deno, basic, rd, rb)))
            if seed in control_seeds:
                cd, cb = entry.reference(reference, clip, sigma, rcfg, dev,
                                         tf32=True)
                emit(dict(kind="control_tf32", seed=seed, call=i,
                          **check.gaps(cd, cb, rd, rb)))
                agg_cfg = program_config(vt, dict(
                    conf, overrides=dict(conf["overrides"], agg_bf16=True)))
                cd, cb = program(clip, agg_cfg)
                emit(dict(kind="control_agg_bf16", seed=seed, call=i,
                          **check.gaps(cd, cb, rd, rb)))
                noisy = torch.from_numpy(clip.noisy).to(dev)
                emit(dict(kind="fault_identity", seed=seed, call=i,
                          **check.gaps(noisy, noisy, rd, rb)))
                with half_sites(vt):
                    cd, cb = program(clip)
                emit(dict(kind="fault_half", seed=seed, call=i,
                          **check.gaps(cd, cb, rd, rb)))
                cd, cb = program(clip, hook=frame_off)
                emit(dict(kind="fault_frame", seed=seed, call=i,
                          **check.gaps(cd, cb, rd, rb)))
            del deno, basic, rd, rb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import torch

    from perfbench.harness import spec

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA card")
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row = dict(workload=cell.name, **row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, seeds, controls, args.device, emit)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
