"""The benchmark's arithmetic on host-clock call lists and device
intervals: plain Python, no torch."""

from __future__ import annotations

import statistics
from typing import List, Sequence, Tuple

Interval = Tuple[float, float]


def fps(frames: int, window_s: float) -> float:
    """Frames of the calls completed in the window over its seconds."""
    if window_s <= 0:
        raise ValueError("empty window")
    return frames / window_s


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile (1-99) of ``values``, by
    ``statistics.quantiles(..., n=100, method="inclusive")``: linear
    between the closest ranks, within the sample's range."""
    if not values:
        raise ValueError("no samples")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def union(intervals: Sequence[Interval], lo: float, hi: float
          ) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], sorted and
    disjoint."""
    out: List[Interval] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Time in [lo, hi] in which at least one interval runs."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi]: its complement of the union."""
    out, cur = [], lo
    for s, e in union(intervals, lo, hi):
        if s > cur:
            out.append((cur, s))
        cur = e
    if hi > cur:
        out.append((cur, hi))
    return out
