#!/usr/bin/env python3
"""Run one cell of vnlb_tpu_torch's benchmark once, on the CUDA card of
this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics read from a
``torch.profiler`` trace of the window.  Either way the outputs of sampled
window calls are compared with the plain reference (``correct``).  The
last line of standard output is the result as one JSON object; progress and
the numbers compared, each beside its limit, go to standard error.

Without a CUDA card (or with fewer than the cell asks for), without the
program beside the benchmark, or when jax, jaxlib, flax or vnlb_tpu was
imported, the run exits nonzero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names the run may not hold: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "vnlb_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each name compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench.harness import spec
    from perfbench.harness.loop import log, run_cell

    cell = spec.cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card; the benchmark does not run on the "
              "CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {cell.name} needs {chips} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START)
    log(f"card={power_limit()}")
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run imported {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    checks = result.pop("checks")
    for name, row in checks.items():
        print(f"check {name} = {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
