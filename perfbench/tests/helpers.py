"""Small cells for the harness's CPU tests."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.harness import spec

TINY = dict(height=40, width=48)


def tiny(name: str, frames: int = 3, **limits) -> spec.Cell:
    """Cell ``name`` of the repository at a size the CPU runs in seconds,
    one clip compared, with ``limits`` (default: the cell's own)."""
    c = spec.cell(name)
    mix = dict(c.traffic, frames=frames, pool=2, check_calls=1)
    lim = {"limits": limits} if limits else c.limits
    return c._replace(config=dict(c.config, **TINY), traffic=mix, limits=lim)


def copy_bench(dst: Path) -> Path:
    """A copy of BENCHMARK.json and perfbench/ under ``dst``."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))
