"""The comparison that decides ``correct``: the outputs of sampled window
calls (both passes, ``basic`` and ``deno``) against the plain reference's
on the same clip, flows and configuration.

Each number compared is the worst over the sampled calls; each has a limit
in ``perfbench/workloads/<cell>.json`` (``limits``), set from the readings
written beside it there and in PERF.md.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple


def numbers(prog, ref) -> Dict[str, float]:
    """Gaps of one pass's output ``prog`` from ``ref`` (torch tensors of
    one shape, gray levels on [0, 255]): the root mean square and the mean
    absolute difference.  (The largest absolute difference is not
    compared: near-tie swaps of the top-K put sound runs as high as the
    lower-precision controls.)"""
    d = (prog.double() - ref.double())
    if not bool(d.isfinite().all()):
        return {"rms": math.inf, "mean_abs": math.inf}
    return {"rms": float(d.pow(2).mean().sqrt()),
            "mean_abs": float(d.abs().mean())}


def gaps(deno, basic, ref_deno, ref_basic) -> Dict[str, float]:
    """``basic_rms``, ``deno_rms``, ... of one call."""
    out = {}
    for tag, p, r in (("basic", basic, ref_basic), ("deno", deno, ref_deno)):
        if tuple(p.shape) != tuple(r.shape):
            out.update({f"{tag}_{k}": math.inf
                        for k in ("rms", "mean_abs")})
            continue
        out.update({f"{tag}_{k}": v for k, v in numbers(p, r).items()})
    return out


def worst(per_call: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the calls compared."""
    keys = sorted({k for c in per_call for k in c})
    return {k: max(c.get(k, math.inf) for c in per_call) for k in keys}


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}} of the numbers compared):
    correct when every number with a limit is at or under it, and there
    is at least one.  A reading with no limit is not compared."""
    table, ok = {}, bool(limits)
    for name in sorted(limits):
        value = readings.get(name)
        table[name] = {"value": value, "limit": limits[name]}
        if value is None or not value <= limits[name]:
            ok = False
    return ok, table
